#!/usr/bin/env python3
"""Drive the PyTorch port (``analytics_zoo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``analytics_zoo_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together) and prints the
   card (``nvidia-smi --query-gpu=name,power.limit``), each library's
   registers and spills (``ptxas``), and the tensor-core (``HMMA`` for
   ``mma.sync``, ``HGMMA`` for ``wgmma``) and ``cp.async`` (``LDGSTS``)
   instructions of every instance of the flash forward, dQ and dK/dV
   kernels and of the dequantize-matmul's ``dq_mma`` and ``dq_wgmma``
   (``cuobjdump -sass``), and the global loads by width of every
   instance of the bag forward (``bag_fwd<T, P>``); an instance without
   its tensor-core instruction or LDGSTS, a bag forward instance without
   the load of its piece's width (``LDG.E.128`` for 16-byte pieces), or
   a spill in the flash, dequantize-matmul or embedding-bag libraries,
   fails.
2. Kernel phase: each kernel against its plain PyTorch version on the
   card, at the slices' shapes and at the repo's kernel-bench shapes;
   times the kernel, the plain version and, where one exists, a single
   PyTorch call computing the same function, beside the least time the
   card could take (``bound_ms``: bytes over 3.35 TB/s or operations
   over the rate for their type, the larger: f32 at 67 TFLOP/s, except
   attention, whose f32 operations are bounded at the card's
   f32-accurate tensor rate, split-TF32's 495 / 3 = 165 TFLOP/s, and the
   dequantize-matmul, whose f32 x takes three bf16 products per product
   (989 / 3 = 330 TFLOP/s), each with the 67 TFLOP/s time kept as
   ``ops_bound_ms_cuda_cores``; bf16 and f16 at 989 TFLOP/s).
   Dequantize-matmul legs: the NCF slice (M = 1, 8, 64, 256, K = N = 40,
   int8 and int4), the kernel bench's M = 1024, K = N = 4096 (int8, int4,
   odd-K int4, and bf16 and f16 x with int8), BERT-Base's Dense layers
   at M = 4096 ((768, 768), (768, 3072), (3072, 768) int8, (768, 3072)
   int4) and M = 4,194,305 at K = N = 40 (past the former grid limit).
   Phase 16 and 17 add theirs (VGG-16's Dense layers; BERT-Base's block
   shapes at M = 1024 and in int4 at 4096).
   ``*_ms`` is device time
   (the calls captured in a CUDA graph and replayed, timed by CUDA
   events); ``*_call_ms`` is time per call from a host loop, launch
   cost included.
   Bag forward legs: the NCF slice (V = 6041 and 3707, B = 1, 8, 64,
   256, N = 1, D = 20), the kernel bench's V = 2^20, B = 4096, N = 32,
   D = 64 (every combiner, pad 0 and None; clipped ids; bf16 and f16
   tables; Zipf s = 1.0 ids; the table one element into its buffer, rows
   on 4 bytes), the bound counting the distinct rows the ids read.
   Tolerances: embedding-bag forward rtol 1e-5 / atol 1e-5 elementwise
   (bf16 and f16 tables 2^-7 or 2^-10 of |plain| plus 1e-5 of the summed
   magnitude of the terms: one rounding of an f32 sum);
   embedding-bag backward atol 1e-6 plus rtol 1e-5 of the summed
   magnitude of each element's contributions (|dT| itself where a row
   gets one add; the kernel adds duplicate ids in another fixed order
   than ``index_add_``, so a hot row's cancelling sum cannot be held to
   1e-5 of itself), and the same bits from a second call and from a
   CUDA graph's replay, also on a table of 2^31 + 192 elements (V = 2^25
   + 3, D = 64, ids at both ends and past 2^31 elements);
   dequantize-matmul f32 (and f64) x max |err| <= 1e-4 * max |plain|
   (K-long f32 sums in another order), bf16 and f16 x |err| <= 2^-7 or
   2^-10 * |plain| + 1e-5 * max |plain| (both f32 results rounded once
   to x's type, which may land one unit apart); flash attention f32
   |err| <= 2e-5 + 1e-4 * |plain| elementwise, bf16 |err| <= 8e-3 + 8e-3 * |plain| (one bf16 rounding
   of an f32 result) with at most ``BF16_MISMATCH_LIMIT`` of the bf16
   outputs differing from the plain version's (which tells the kernel's
   split P from a P rounded once to bf16), and rows with no live key
   exactly 0.  Flash cases:
   the BERT-Base shapes (B=32, L=128 and B=8, L=512; 12 heads, D=64),
   the kernel bench's L=2048 (D=64, and D=128 causal), a ragged causal
   L=77, causal Lq < Lk and Lq > Lk, bf16 at L=512 and at BERT's L=128,
   ragged head widths (D=24 f32, D=72 bf16), and q, k, v as
   ``x[..., 1:65]`` of a (B, L, H, 65) buffer (rows off 16 bytes, f32
   and bf16); the yardstick is
   ``F.scaled_dot_product_attention`` on the backend named in the case:
   the first that takes the inputs and answers within the case's
   tolerance (the flash backend left out on the misaligned legs, where
   it faults).
   The training kernels — the forward with logsumexp, dQ and dK/dV — at
   BERT training's B=32 H=12 L=128 D=64, the bench's L=2048 (D=64, and
   D=128 causal), ragged causal L=77, causal Lq < Lk and Lq > Lk, and
   the forward's bf16, ragged-D and misaligned cases: out as the
   forward's tolerance, lse |err| <= 2e-5 +
   1e-5 * |plain| on rows with a live key and -1e30 on rows with none,
   dQ, dK, dV as the forward's tolerance (bf16: each at most
   ``BF16_MISMATCH_LIMIT`` off the plain version's bf16 value, which
   tells split P and dS from a single rounding), dQ rows with no live
   key exactly 0, and two runs of the backward bit-identical (no
   atomics).
   Their yardsticks are aten's memory-efficient attention (SDPA's f32
   backend): its forward with ``compute_log_sumexp=True``, and its
   backward, which computes dQ, dK, dV and delta together, reported on
   both backward rows as the pair's time beside ``pair_ms`` (delta and
   both kernels); the plain time on those rows is the plain backward's,
   the pair's too.
   On the bf16 legs the lse row also times
   ``F.scaled_dot_product_attention`` on the first backend (flash first)
   that answers within the leg's tolerance (``sdpa_ms``): the same out
   without the lse.
   TF32 is off for every matmul and cuDNN call (set and printed).
3. Serving phase (the first main path): NeuralCF at the MovieLens-1M
   width (6040 users, 3706 items, embeds 20, MLP 40/20/10, 5 classes)
   with seeded weights, served through ``InferenceModel`` in float32,
   int8 and int4: single requests from several threads through a
   ``DynamicBatcher`` and one ``recommend_for_user`` over every item.
   Kernel launch counts are zeroed just before and read just after; the
   outputs are held against the same model run with every kernel call
   routed to its plain version on the card (``ops.dispatch.forced``),
   atol 1e-5.
4. Training phase (the second main path): the same NeuralCF trains
   through ``compile`` / ``fit`` on ``generate_movielens_like(seed=0)``
   (120,800 ratings, labels rating - 1) with Adam(lr=1e-3), batch 2048,
   3 epochs of shuffled host arrays, then one device-resident epoch
   from CUDA tensors; launch counts are zeroed just before and read just
   after.  The same 3 epochs from the same initial weights run again
   under ``forced("reference")``: the per-epoch losses must agree within
   rtol 1e-4, and one step from the same weights and batch must give
   weights within atol 1e-6; the loss must fall from epoch 1 to epoch
   3; every step launches exactly 4 bag forwards, 4 bag backwards and
   no dequantize-matmul.  The final weights after 3 epochs are reported
   beside a second plain run's, not held to a bound: the two paths add
   duplicate ids in different orders (the plain one, ``index_add_``, with
   atomics in a free order), and Adam turns those last-bit differences
   into larger ones on a few elements, so two plain runs differ from
   each other too.  One more epoch runs
   under ``torch.profiler`` for the device's busy share.
5. BERT serving phase (the third main path): BERTClassifier at the
   BERT-Base width (vocab 30522, hidden 768, 12 blocks, 12 heads,
   intermediate 3072), f32 weights from a seeded generator, served
   through ``InferenceModel`` behind a ``DynamicBatcher`` (buckets 1, 8,
   32): 48 single L=128 requests from six threads, then 8 single L=512
   requests from two, no mask.  Counts are zeroed just before and read
   just after; every forward must launch the flash kernel 12 times and
   select no reference attention; the answers are held against the same
   requests under ``forced("reference")`` (max |d logit| <= 1e-3, 12
   blocks of f32 sums in another order).  One masked request then takes
   the reference route (reported apart), and one forward at each length
   runs under ``torch.profiler``.
6. BERT training phase (the fourth main path): BERTClassifier at the
   BERT-Base width, ``attn_drop=0`` (probability dropout would take the
   blockwise route and no kernel), ``hidden_drop=0.1``, fine-tuned as
   google-research/bert ``run_classifier.py`` sets it: 256 seeded
   sequences of 128 real tokens (segments 0 then 1 at a seeded split;
   label 1 when the split falls in the first half), batch 32,
   AdamWeightDecay (lr 5e-5, warmup 0.1 of the 32 steps, weight decay
   0.01, eps 1e-6), 3 epochs of host arrays then one device-resident
   epoch.  Counts are zeroed just before and read just after: every step
   launches exactly 12 lse forwards, 12 dQ and 12 dK/dV kernels, no
   forward-only flash kernel and no reference attention.  evaluate and
   predict then run the forward-only kernel.  The same 3 epochs from the
   same weights and dropout seed under ``forced("reference")`` give
   per-epoch losses within rtol 1e-3, and one step from the same weights
   and batch every leaf's gradient within 1e-4 of that leaf's largest
   plain |g| plus 1e-6 of the largest over all leaves (f32 sums in
   another order through 12 blocks; the floor is for the key bias, whose
   gradient is 0 in exact arithmetic — softmax ignores a shift shared by
   a row's logits — so both paths hold only rounding noise there); the
   loss must fall from epoch 1 to epoch 3.  One more step runs under
   ``torch.profiler``.
7. Fault-tolerant bf16 fine-tuning phase (the fifth main path), in a
   temporary directory removed at the end; it first checks the disk has
   two BERT-Base snapshots (params, m and v in f32, 1.31 GB each) and
   1 GiB free, and fails naming the bytes if not.  BERTClassifier at the
   BERT-Base width with phase 6's data and optimizer (24 steps in all),
   ``compute_dtype="bfloat16"``, a checkpoint every epoch
   (``async_checkpoint``, the newest kept).  Run U: three epochs; counts
   are zeroed just before and read just after, and every step must launch
   exactly 12 lse forwards, 12 dQ and 12 dK/dV kernels on bf16 q, k, v
   (the launchers are wrapped to record q's dtype), no forward-only
   kernel and no reference attention; the loss must fall from epoch 1 to
   3.  The checkpoint costs: snapshot bytes, one synchronous save, one
   asynchronous save (the time to return, and the whole write), the ms
   per step of an epoch with no write in flight and of one while the
   asynchronous write runs, and a verified restore.  Run P: the same run
   from the same weights and seeds gets a real SIGTERM from the
   ``estimator.preempt`` fault site's ``sigterm`` action at epoch 2's
   fourth step; it must flush one synchronous checkpoint and raise
   ``TrainingPreempted`` there, and every restored value must equal the
   live state at the flush bit for bit (every parameter leaf, the flat
   optimizer state, the dropout generator's state, the step and epoch
   counters, the host RandomState).  A fresh Estimator then resumes
   with ``fit(resume=True)`` to epoch 3: its per-epoch losses within
   ``P_LOSS_RTOL`` of U's and its weights within ``P_WEIGHTS_REL`` of
   U's movement (L2), with the largest difference and whether the runs
   are bit-equal printed.  The fine-tuned net's ``save_weights`` →
   ``load_weights`` into another net gives bit-equal ``predict`` (the
   forward-only kernel, bf16, 12 launches a batch).  Run R: U's epochs
   under ``forced("reference")``, per-epoch losses within
   ``BF16_PLAIN_LOSS_RTOL``.  Then NeuralCF at the ML-1M width on phase
   4's data, on kernels 1–2: ``nan_policy="rollback"`` with
   ``max_bad_steps`` = 3 consecutive NaN batches in epoch 2 injected
   through ``estimator.step`` must roll back once to epoch 1's
   checkpoint, halve ``lr_scale`` and train on to epoch 3 with a finite,
   falling loss; ``grad_accum_steps=2`` at batch 1024 against batch 2048
   on the same shuffle (SGD at ``ACCUM_LR``, one epoch) within
   ``ACCUM_ATOL``, the weights having moved at least ten times that; and
   ``save_model`` → ``ZooModel.load_model`` → ``InferenceModel`` answers
   bit-equal to the saved model's; every training step launches 4 bag
   backwards.  bf16 ms per step and samples per second (an epoch with
   no write in flight, and one step under ``torch.profiler`` for the
   device's share) print beside phase 6's f32, with the card's name and
   power limit.
8. Graphed dispatch phase.  Every main path above already runs through
   CUDA graphs (``core/graphs.py``): a training step, or K of them, is one
   replay, a serving bucket signature one captured graph, and the launch
   counters count launches per replay times replays (a signature's first
   request runs eagerly as the warm-up, its second captures the graph).
   This phase
   holds graphed against eager (``graphs.disabled()``) and times both:
   NeuralCF at the ML-1M width on phase 4's data and optimizer, two
   epochs each from the same weights, on the host path and the resident
   path at ``steps_per_execution`` 1 and 8 (per-epoch losses within rtol
   1e-4, weights reported; every step 4 bag backwards; every replay 4
   bag forwards and 4 backwards per step it holds), one epoch of each
   profiled for device ms per step, the busy share and the host's graph
   and kernel launches; BERT-Base fine-tuned at phase 6/7's
   configuration in bf16 and f32, two epochs each (one step program, 12
   lse, dQ and dK/dV launches per replay; losses and weights equal bit
   for bit; the card's peak and held memory), one step profiled, then one graphed bf16 device-resident epoch (a program of
   its own, replayed every step after its first); BERT-Base (f32, buckets 1, 8, 32) and int8 NeuralCF (buckets
   1, 8, 64, 256) served from bucket graphs that fill a ``CompileCache``
   in a temporary directory, BERT at the batcher's 8-row batches from 8
   threads eager, graphed, graphed, eager (p50/p99, one forward
   profiled; answers within 1e-5); then a second process
   (``chip_smoke.py --serve-warm DIR``, a real restart) warms both
   models from the cache and serves 64 single requests each through
   ``DynamicBatcher`` with ``compile_count == 0``; its answers, the
   cover batches and the served requests, are held element by element
   against the first process's (within 1e-6 of the largest).  Phases 4, 6 and 7 run graphed: phase 7's run U and NCF
   rollback leg must each be one step program replayed at every step
   after its first (the NaN steps and the rolled-back epoch included),
   and its SIGTERM-and-resume runs graphed.  Capture seconds and launches
   per replay print for every program, with the card's name and power
   limit.
9. ClusterServing phase.  int8 NeuralCF at the ML-1M width (buckets 1,
   8, 64, 256; one (user, item) pair per record, split into the net's two
   inputs on the card inside each bucket graph) and BERT-Base f32
   (buckets 1, 8, 32; 128 ids per record) served together by one
   ``ClusterServing({"ncf": ..., "bert": ...})`` worker with
   ``postprocess_top_n=2`` (``torch.topk`` inside the bucket graphs) and
   ``supervise=True``.  A first pass runs every bucket of both models
   through a top-2 replica and ``predict`` into a ``CompileCache`` and
   computes every record's plain scores (``forced("reference")``); the
   worker's models are then made afresh and warm from the cache.  A
   client in a second process (``chip_smoke.py --serve-client BACKEND
   ADDRESS OUT``, which never touches CUDA) pushes 4,096 NCF records
   (pairs from ``generate_movielens_like(seed=0)``) and 64 BERT records,
   then one record without a tensor field and one with ``ttl_ms=1``,
   over a ``ShmQueue`` it attaches to by name, and reads every answer;
   then a second worker on the same models does the same over a
   ``FileQueue``.  Every answer's top-2 indices and values are held
   against the plain scores (phase 3's 1e-5 for NCF, phase 5's 1e-3 for
   BERT; an index may differ only where the plain scores tie within
   that), the two bad records must come back as typed error payloads
   (``malformed``; ``expired`` or ``overloaded``), no record may be lost,
   ``compile_count`` must stay 0, and no codec copy may be made.  In the
   shared-memory run one ``serving.replica_crash`` is injected through
   ``FaultInjector``: the slot's breaker opens, the batch is retried or
   served by the sync fallback, and the slot comes back (the
   supervisor's rebuild or the half-open probe).  Prints records per
   second, e2e p50/p99 per model and per queue, the stage p50/p99 of
   ``health()``, the launches of kernels 1, 3 and 4, breaker and
   supervisor counters, and the card's busy share (its time in the bucket
   graphs, by CUDA events each graph records at its start and end) over
   one second of the file-queue run and over each run, with the card's
   name and power limit (``cluster_serving`` and
   ``cluster_serving_summary`` lines).
10. Image phase (ResNet-50, BASELINE config #2).  ResNet-50 at
   ImageNet's width (``resnet50(1000, (224, 224, 3))``: 25,557,032
   parameters, 53,120 BN state values) trains as bench.py's
   ``bench_resnet50`` sets it: bf16 compute, Adam 1e-3, batch 256,
   ``sparse_categorical_crossentropy_with_logits``, on 1,024 seeded
   uint8 images scaled by 1/255 (device-resident), one epoch of 4 steps
   with each dispatch timed (the first eager, the second captures), two
   more timed (ms per step on the host's clock, imgs/s, peak memory), one
   more under ``torch.profiler`` (device ms per step, busy share, the
   heaviest kernels); the loss must be finite.  Then a graphed and an
   eager run from the same init, both with cuDNN's deterministic
   algorithms, must agree on the parameters and the BN state within
   ``GRAPHED_REL`` of their movement (L2; bit-equality printed).  Then
   bench.py's ``bench_resnet_accuracy`` recipe with the scenes drawn by
   numpy (4,096 at 32x32, 90% trained 3 epochs at batch 256,
   ``bn_momentum=0.3``, Adam 3e-4, bf16, ``steps_per_execution=4``): the
   held-out accuracy, through the moving statistics, must reach 0.9.
   ``SpaceToDepthStemConv`` and the plain 7x7/s2 convolution are timed
   on one leaf (forward and backward at batch 256 in bf16, forward at
   batch 64 in f32) and held together.  The trained net is then served through
   ``DynamicBatcher`` (buckets 1, 8, 32, 64) in f32, int8 and int4
   weights and over the uint8 wire (``imagenet_preprocess``, bf16): per
   form a first model covers every bucket into a ``CompileCache``, a
   second warms from it and serves 48 single images from 8 threads and
   8 requests of 8 from 2; ``compile_count`` must stay 0, kernel 3 must
   launch in int8 and int4 (its counts zeroed just before and read just
   after) and nowhere else, and the answers are held against the plain
   f32 eval forward on the card (``forced("reference")``): f32 and
   int8 / int4 (against the dequantized tree) within ``SERVE_F32_REL``
   of the largest logit, bf16 within ``SERVE_BF16_REL`` of it with the
   same top-1 wherever the plain top-1 leads by more than twice that.  The kernel phase adds
   kernel 3 at the ResNet-50 head's shape (M = 1, 8, 64, 256; K = 2048;
   N = 1000; int8 and int4; f32 and bf16 x).  ``resnet50_*`` lines carry
   the numbers, with the card's name and power limit.
11. Recommender phase.  WideAndDeep (BASELINE config #4) at bench.py's
   census shape (``WND_CONFIG``: wide 1000 + 1000, embed 5000 / 1000 to
   64 / 64, 11 continuous columns, hidden 100-75-50-25) trains as
   bench.py's ``bench_wide_and_deep`` sets it (bf16, Adam 1e-3, batch
   8192, K = 32 steps per graph) on 32 x 8192 device-resident rows
   labelled by a numpy rule on the wide ids and the first continuous
   column; SessionRecommender at the JAX defaults with both towers over
   37,483 items (``SESSION_CONFIG``) trains in bf16 at batch 1024 on
   65,536 Markov sessions (the example's rule).  Each: untimed graphed
   epochs, timed epochs with the bag kernels' counts zeroed just before
   and read just after (samples/s, ms per step wall), one more epoch
   under ``torch.profiler`` (device ms per step, busy share); the loss
   must fall and the accuracy reach its floor (WideAndDeep on held-out
   rows, the session model's top-5 on its sessions); a graphed and an
   eager run of two epochs from one init agree within
   ``REC_GRAPHED_REL`` of their movement (L2).  The trained model is
   served in f32, int8 and int4 from bucket graphs (1, 8, 64, 256)
   warmed from a ``CompileCache`` that a first model filled
   (``compile_count`` 0): 256 one-row requests from 8 threads through
   ``DynamicBatcher`` (WideAndDeep's with three inputs: wide and embed
   int32, continuous f32) and, for the session model,
   ``recommend_for_session`` over the same 256 sessions; the answers
   within ``REC_SERVE_REL`` of each row's largest probability of the
   plain f32 forward on the card (int8 / int4 against the dequantized
   tree), kernel 3 launching in int8 / int4 and in no f32 form.  The
   kernel phase adds kernels 1 and 2 at the wide tower's (2000, 2)
   table (8-byte f32 and 4-byte bf16 rows), the deep columns and the
   session and history gathers, and kernel 3 at the session head (K =
   40, N = 37,484, M = 1 ... 256), WideAndDeep's Dense layers and N = 2.
   ``wide_and_deep_*``, ``session_*`` and ``recommender_summary`` lines
   carry the numbers, with the card's name and power limit.
12. Text phase.  TextClassifier at the JAX defaults, which follow the
   reference TextClassifier.scala (``TEXT_CONFIG``: a 5001 x 200 table,
   T = 500, 256 filters of width 5, 20 classes as 20 Newsgroups), trains
   as the reference example does (batch 128; Adam 1e-3 as the JAX
   example; bf16, K = 8 steps per graph) on the smoke's corpus
   (``TEXT_CORPUS``, the smoke's choice: 16,384 documents of 100-500 Zipf
   word ids with per-class theme words, front-padded to 500 with id 0, a
   held-out eighth): untimed epochs, timed epochs with the bag kernels'
   counts read around them, one profiled epoch; the loss must fall, the
   held-out accuracy reach 0.9; a graphed and an eager f32 run of 24
   steps from one init give the same bits with cuDNN's deterministic
   convolutions, and agree within ``TEXT_GRAPHED_REL`` of their movement
   with cuDNN free (L2; its convolution backward has no fixed order), and
   of two epochs, f32 and bf16, in their last epoch's loss within
   ``TEXT_GRAPHED_LOSS_REL``.  The
   LSTM and GRU encoders at the same widths train graphed in bf16 over
   T = 500 on 2,048 rows (``TEXT_RNN_TRAIN``, the smoke's choice), the
   second of two epochs timed, one eager step profiled for its kernels.
   All three are served in f32, int8 and int4 from bucket graphs (1, 8,
   64, 128) warmed from a ``CompileCache`` (``compile_count`` 0): 256
   one-row requests from 8 threads through ``DynamicBatcher``, each
   answer within
   ``TEXT_SERVE_REL`` of the row's largest |logit| of the plain f32
   forward on the card (int8 / int4 against the dequantized tree), kernel
   1 launching in every form and kernel 3 in int8 / int4 only; then the
   int8 CNN behind ``ClusterServing`` over a ``ShmQueue`` with int32 id
   records, every record answered within ``CLUSTER_TOL``.  KNRM at the
   reference qaranker example's lengths (``KNRM_CONFIG``; vocabulary the
   smoke's choice) trains with rank_hinge on synthetic (pos, neg) pairs;
   ``Ranker`` NDCG@3 and MAP on held-out lists must reach 0.9, and
   ``evaluate`` on 1,001 rows equal the masked rule.  Seq2seq (the
   smoke's widths, ``SEQ2SEQ_CONFIG``) trains on the JAX test's copy
   task; greedy and beam decoding (beam 4, stop sign, length penalty 0.6)
   from graphs give the plain versions' tokens and scores within
   ``SEQ2SEQ_SCORE_TOL``; greedy decoding from int8 weights runs kernel 3
   at every step.  AnomalyDetector at the JAX defaults trains on a sine
   series and flags the spikes of a held-out continuation.  The kernel
   phase adds kernel 1 at the classifier's gather (f32 and bf16 tables),
   kernel 2 at its backward (front-padded, and Zipf without padding) and
   kernel 3 at ``tc_fc``, ``tc_out`` and the Seq2seq generator (M = 1,
   8, 64, 128).  ``text_*``, ``knrm``, ``seq2seq``, ``anomaly`` and
   ``text_summary`` lines carry the numbers, with the card's name and
   power limit.
13. Loadgen phase (open-loop load, ``analytics_zoo_tpu_torch.loadgen``).
   (a) Phase 9's int8 NeuralCF and BERT-Base, warmed from a compile
   cache as phase 9's (``cluster_cover``), behind one ClusterServing per
   leg over a ShmQueue (the leg fails on any other wire), with
   ``slo_p99_ms`` the JAX legs' 250 ms (steady) and 400 ms (burst).
   ``LOADGEN_CLIENTS`` client processes (``chip_smoke.py
   --loadgen-client SEGMENT OUT SPEC``, which never touch CUDA), released
   at one instant, each run an ``OpenLoopClient`` on a seeded Poisson
   schedule at 1/N of the leg's rate (their sum is the leg's Poisson
   stream): NCF : BERT = 64 : 1 by record, NCF (user,
   item) pairs Zipf s = 1.0 over ids 0 ... 3706 (``ZipfianIdPayload``),
   BERT 128 ids; steady at 0.5 R for 8 s, then a flash crowd (base 0.25
   R, 1.5 R for 2 s from 3 s, 12 s), R being phase 9's ShmQueue records
   per second in this run.  Per leg and model: p50 and p99 from schedule
   to answer, sustained QPS at SLO, shed fraction, recovery after the
   burst, send lag p99, open-loop drops, the card's busy share (the
   bucket graphs' CUDA events over the client's wall time), the launches
   of kernels 1, 3 and 4 (zeroed just before, read just after; each must
   run) and ``compile_count`` (must stay 0); every answered record's
   top-2 is held against the plain scores of its payload, re-drawn from
   its client's seed (phase 9's 1e-5 for NCF, 1e-3 for BERT).  (b) The
   kill and mix-shift legs of the port's
   ``loadgen.harness.default_report(quick=True)``, the two its checks
   read (the other legs serve host functions and are held in the CPU
   tests).  The kill leg's ``server_main`` runs on the card as users run
   it: a supervisor that imported the port once forks the worker that
   fits and serves; the worker is SIGKILLed mid-storm and the supervisor
   forks its successor, which must warm every signature from the same
   compile cache (``warm_compile_count`` 0), return to SLO within
   ``KILL_RECOVERY_S`` with at most ``KILL_LOST`` lost and exit 0; then a
   fresh interpreter starts on the same caches (``fresh_start_ready_s``,
   its captures must be 0 too).  The mix-shift leg's autoscaler must not
   flap.  ``loadgen``, ``loadgen_report`` and ``loadgen_summary`` lines
   carry the numbers and the wall seconds by part, with the card's name
   and power limit.
14. Training-surface phase (the STREAM tier, graphed evaluate / predict,
   AUC, TensorBoard).  (a) NeuralCF at phase 4's ML-1M width (two
   classes, implicit labels) trains for three epochs at batch 2048 from
   ``generate_movielens_like(ratings_per_user=166)`` (1,002,640
   positives, ML-1M's count) and as many negatives sampled on the card
   (``presample_implicit_epochs``), written as 8 ``.npy`` slices and read
   back through ``FeatureSet.from_npy_slices(...).cache("STREAM")`` with
   ``data_device_budget_bytes`` half the slices' bytes: four shards
   through two slots.  It must take the stream path, its loss must fall,
   the shard programs must capture once per slot and then only replay,
   with no fallback; the overlap share is printed.  With
   ``shuffle=False`` two epochs through the stream are held against two
   resident epochs of the same rows (within 1e-5 relative; the line says
   whether they match bit for bit); an injected ``data.shard_upload``
   crash on the third shard's upload must still train the epoch's every
   step, one fallback counted; a stream epoch inside
   ``profiling.trace()`` must capture its slots too.  (b) The trained
   model's ``evaluate(metrics=["auc", "accuracy"])`` and ``predict`` on
   100,001 held-out rows (a ragged last batch), graphed against eager on
   the plain path within ``SURFACE_EVAL_TOL``, with no capture after the
   first pass; the AUC against the exact rank AUC within the bound its
   200-threshold histogram allows (``histogram_auc_bound``).  (c)
   BERT-Base evaluate and predict at L=128, batch 32, on 135 rows,
   graphed against graphs off within phase 5's 1e-3, with ms per batch
   both ways.  (d) TensorBoard: ``read_scalars`` gives (a)'s per-epoch
   losses, and ``publish_metrics`` writes scalars.  Kernels 1 and 2 must
   launch 4 times a step in (a), kernel 1 4 times a batch in (b), kernel
   4 12 times a batch in (c).  The ``training_surface`` line carries the
   numbers with the card's name and power limit.
15. Detection phase (SSD300 on PASCAL VOC's shape, and image records).
   (a) 1,280 VOC-shaped uint8 scenes (375x500, 1-4 objects of 20
   classes, each a box of its class's colour and stripes) drawn from the
   seed, their annotations written as VOC XML and read back through
   ``read_pascal_voc``; 1,024 go through SSD's augmentation
   (``RandomSampler | ImageRandomPreprocessing(RoiHFlip(normalized=
   False)) | RoiResize(300, 300) | RoiNormalize |
   ImageChannelNormalize``, boxes padded to the largest count) and
   train the full-width ``ObjectDetector(21)`` (8,732 priors) through
   ``fit_detection`` on the card: bf16, Adam 1e-3, batch 32, graphed,
   device-resident, ``SSD_TRAIN`` epochs (the first timed dispatch by
   dispatch, the rest by wall clock, one more under ``torch.profiler``:
   device ms by kind); the loss must fall.  (b) ``detect`` (score 0.01,
   NMS 0.45, 100 boxes) on the 256 held-out scenes at batch 32, graphed,
   against graphs off (equal labels and boxes, scores within 1e-6); the
   card's f32 head outputs against the port on the CPU for 4 images
   (``SSD_CPU_REL``) and the card's decode, softmax and class NMS on
   them against the CPU's (equal labels, boxes and scores within 1e-6);
   ``PascalVocEvaluator``'s mAP at init and after training, which must
   rise.  An f32 run from the init, graphed and eager over the same 8
   steps with cuDNN deterministic, within ``GRAPHED_REL``.  (c) The
   trained detector behind ``InferenceModel(detection_forward)`` and
   ``ClusterServing`` over a ShmQueue (the JAX example
   streaming_od_example.py's setup), a client process (``python3
   chip_smoke.py --detect-client SEGMENT OUT SPEC``) streaming raw
   300x300 uint8 frames through ``enqueue_image``: every answer equal
   to offline ``detect`` on the same frames.  (d) int8 ResNet-50
   (``ImageClassifier("resnet-50")``) behind ClusterServing with its
   ``preprocessing()`` chain as the host preprocess, raw 375x500 frames
   through ``enqueue_image`` from a client thread, top-5 on the card,
   equal to offline ``predict_image_set`` of the same int8 net; kernel
   3's launches in the served run count under ``image_records``.
   ``detection_*`` and ``image_records`` lines carry the numbers with
   the card's name and power limit.
16. Model-import phase (``model_import_phase``): every file written to
   a temporary directory by a writer here that uses none of the port's
   decoders, and removed after.  (a) BERT-Base (``BERT_BASE``, L = 128,
   2 labels, seeded) written as ONNX in the exporters' vocabulary
   (Gather embeddings, decomposed LayerNorm, MatMul + Add Dense over
   (in, out) initializers, Shape -> Gather -> Unsqueeze -> Concat ->
   Reshape head chains, the mask through Unsqueeze / Cast / Sub / Mul,
   Softmax, the model's tanh GELU; about 440 MB); ``InferenceModel.
   load_onnx`` answers as the native ``BERTClassifier`` within 1e-3 on
   a logit; ``load_onnx(int8=True)`` with 8 calibration batches (at
   least 74 quantized Dense) behind ``DynamicBatcher`` within 10% of the
   largest f32 logit; ms a batch at buckets 8 and 32; the int8 product
   (``torch._int_mm``) at BERT's Dense shapes, exact, beside
   ``torch.matmul`` in f32 and bf16.  (b) ResNet-50 as a Caffe
   deploy prototxt (KaimingHe/deep-residual-networks' layers) and
   caffemodel from a seeded port net of the same form; ``Net.
   load_caffe`` at batch 32 against that net's plain versions (f32,
   cuDNN deterministic), centred log-probabilities within 1e-3 of the
   largest, eager and from a bucket graph; ``to_model`` -> ``fit`` (the loss must
   fall), graphed against eager over 4 f32 steps within
   ``GRAPHED_REL``.  (c) VGG-16 as a BigDL ``.model`` (about 553 MB,
   Analytics Zoo's layer names) from a seeded port ``vgg16``, imported
   by name into another (equal weights), served int8 at buckets 1, 8
   and 32 against the plain versions within ``IMPORT_VGG_REL``, kernel 3
   launched 3 times a replay (``vgg16_int8_serving``); ``GraphNet.
   new_graph`` at the second 4096 Dense against the source net's
   intermediate output; a new 10-class head fine-tuned over the frozen
   backbone.  (d) torchvision's VGG-11 sequence through ``Net.
   load_torch`` at 224x224 against the module within 1e-4, then 2 steps
   under ``TorchCriterion(CrossEntropyLoss())``.  Kernel 3 is timed at
   VGG-16's three Dense shapes (M = 1, 8, 32, int8 and int4) and
   ``int8_dot(weight_only=True)`` at ResNet-50's head.  ``import_*`` and
   ``model_import_summary`` lines carry the numbers with the card's name
   and power limit.  Kernel 3 at fc6 (M = 1, 8, 32) and its plain
   version are each held against an f64 product of the same dequantized
   weights beside the summation bound K * 2^-24 * sum |x| |w|
   (``c4_fc6_f64``): the kernel over the bound where the plain version
   is within it fails.
17. Quantized BERT-Base and the layer vocabulary (``vocabulary_phase``).
   (a) ``BERTClassifier(2, BERT_BASE)`` from a seed, served at L = 128 in
   f32, int8 and int4 through ``InferenceModel.from_keras_net`` (buckets
   1, 8, 32): int8 and int4 behind a ``DynamicBatcher`` (64 single
   requests from 4 threads), every quantized Dense on kernel 3 (74 a
   replay: q, k, v, o, ffn1, ffn2 of 12 blocks, the pooler, the head)
   and attention on kernel 4 (12 a replay), within ``QBERT_PLAIN_TOL``
   of the plain versions; against the f32 model (max abs logit over the
   largest, argmax agreement); ``weight_nbytes()``; device ms a replay
   at buckets 8 and 32 beside the f32 model's; the device ms of
   dequantizing the three embedding tables; 512 records through a
   ``ClusterServing`` of the phase's own over a ``ShmQueue``.  Kernel 3
   is timed alone at BERT-Base's block shapes, M = 1024 (int8, int4) and
   4096 (int4).  (b) ``SparseEmbedding`` at V = 2^20, D = 64, B = 4096,
   32 ids a bag, pad id 0, with sum, mean and sqrtn: forward and table
   gradient through kernels 1 and 2 against the plain versions, timed;
   then trained through ``compile`` / ``fit`` (one launch of each a
   step, the loss falling).  (c) A seeded GloVe-format file of 5001
   words x 200 read by ``WordEmbedding.from_glove`` into a frozen table
   feeding the TextClassifier's layers: after ``fit`` the table equals
   the file bit for bit, kernel 1 launched once a step, kernel 2 never.
   (d) One net of keras2 names, every merge mode, the advanced
   activations and torch-style layers (``vocabulary_net``) served int8:
   graphed equal to eager bit for bit, both within ``SERVE_F32_REL`` of
   the plain versions.  ``quantized_bert``, ``sparse_embedding``,
   ``glove_text``, ``vocabulary_net`` and ``vocabulary_summary`` lines
   carry the numbers with the card's name and power limit.
18. AutoML forecasting and the host data modules
   (``automl_host_phase``).  (a) ``native``: crc32c MB/s over 4 MB, the
   C++ library against the Python table (equal values); ``gather_rows``
   against numpy fancy indexing at a 4 MiB batch (GB/s, equal bytes);
   the library must build.  (b) 100,000 ML-1M-shaped ratings (6,040
   users, 3,706 items) written as ``tf.Example`` TFRecords (write and
   read records/s), read back by ``TFDataset.from_tfrecord_file`` and
   trained 2 epochs through ``TFEstimator`` on phase 4's NeuralCF and
   Adam at batch 2048: the losses equal ``Estimator.fit``'s on the same
   arrays from the same init and order bit for bit, with kernel 1 and 2
   launched 4 + 4 times a step.  (c) ``SyntheticGiantTable(10**8, 2,
   seed=11)`` (0.8 GB, one shard) filled on the card in chunks through
   pinned buffers (fill seconds); kernel 1 on 8,192 seeded ids (N = 1)
   against its plain version, its bound and ``F.embedding_bag``; the rows
   equal ``rows()`` on the host bit for bit.  (d) A seeded series of
   10,320 half-hourly points (nyc_taxi's length) with one extra feature,
   rolled into windows with numpy: ``MTNetGridRandomRecipe()`` at its
   defaults through ``SearchEngine(max_parallel=4, backend="thread")``
   with a trainable of ``TimeSequencePredictor.fit``'s form, then
   ``BayesRecipe(num_samples=8)`` (TPE over ``VanillaLSTM``,
   ``max_parallel=2``): per-trial wall, trials/s and the card's busy
   share (``nvidia-smi``'s utilization, sampled); the best validation
   MSE below a last-value persistence forecast on the same windows; the
   losers' graphs released; the best model saved, restored and
   predicting equal bit for bit.  (e) 64 configs of a small MLP
   trainable (lr x init scale, 60 full-batch steps) as one
   ``backend="vmap"`` call against the same 64 one by one: scores
   within 1e-4 relative, both walls.  (f) Where pandas imports:
   ``TimeSequencePredictor(...).fit(df, recipe=MTNetSmokeRecipe())`` ->
   ``predict`` -> ``save`` -> ``load_ts_pipeline`` -> ``predict``, equal
   bit for bit.  ``native``, ``tfrecord_estimator``, ``giant_table``,
   ``automl_search``, ``vmap_population``, ``automl_dataframe`` and
   ``automl_host_summary`` lines carry the numbers with the card's name
   and power limit.
19. Prints the kernels JSON line and, last, the ok line.

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

SEED = 0
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
PEAK_TF32_FLOPS = 495e12         # H100 SXM TF32 tensor cores, dense
# f32-accurate products on the tensor cores: split-TF32, three TF32
# products per product (the attention kernels' f32 bound)
PEAK_F32_TENSOR_FLOPS = PEAK_TF32_FLOPS / 3
# The share of a flash kernel's bf16 outputs that may differ from the
# plain version's (bf16_mismatch_share).  On an H100 the kernel's split P
# moves 0.13-0.25% of them, a P rounded once to bf16 26-39%.
BF16_MISMATCH_LIMIT = 0.02
# H100's L2; a bag leg whose table is larger is also timed cold
# (``cold_ms``: each launch on one of COLD_COPIES copies of the table)
L2_BYTES = 50 << 20
COLD_COPIES = 8
BAG_SRC = "analytics_zoo_tpu_torch/csrc/embedding_bag.cu"
DQ_SRC = "analytics_zoo_tpu_torch/csrc/dequant_matmul.cu"
FLASH_SRC = "analytics_zoo_tpu_torch/csrc/flash_attention.cu"
FLASH_BWD_SRC = "analytics_zoo_tpu_torch/csrc/flash_attention_bwd.cu"
BAG_TPU = "analytics_zoo_tpu/ops/embedding_bag.py:98"
BAG_BWD_TPU = "analytics_zoo_tpu/ops/embedding_bag.py:183"
DQ_TPU = "analytics_zoo_tpu/ops/dequant_matmul.py:112"
FLASH_TPU = "analytics_zoo_tpu/ops/flash_attention.py:41"
FLASH_LSE_TPU = "analytics_zoo_tpu/ops/flash_attention.py:94"
FLASH_DQ_TPU = "analytics_zoo_tpu/ops/flash_attention.py:206"
FLASH_DKV_TPU = "analytics_zoo_tpu/ops/flash_attention.py:240"
USERS, ITEMS = 6040, 3706
TRAIN_BATCH, TRAIN_EPOCHS = 2048, 3
# BERT-Base (google-research/bert uncased_L-12_H-768_A-12/bert_config.json)
BERT_BASE = dict(vocab=30522, hidden_size=768, n_block=12, nhead=12,
                 intermediate_size=3072, max_position_len=512,
                 type_vocab_size=2)
# fine-tuning as run_classifier.py: batch 32, max_seq_length 128, lr from
# Devlin et al.'s grid, warmup 0.1; hidden dropout 0.1, attention dropout
# 0 (the flash kernels take none)
BERT_TRAIN = dict(rows=256, length=128, batch=32, epochs=3, lr=5e-5)
# The fault-tolerant phase's tolerances.  In bf16 a logit near the
# final margin of about 5.5 (epoch 3's loss of about 0.004 in f32) moves
# in steps of 2^-5, and the loss, about exp(-margin), by the same share.
# The resumed run P against the uninterrupted U: the two differ only
# where PyTorch's indexing backward on the embedding tables adds
# duplicate ids in another order (f32 last bits, which the bf16 casts of
# the masters mostly round away), so per-epoch losses within 2^-9, one
# such step on 1 in 16 of the 256 sequences; weights within 5% of U's
# movement from the initial weights in L2 (the key biases' gradient is 0
# in exact arithmetic, so Adam steps them by rounding noise, up to the
# learning rate, differently in any two runs: at most 2 x 6e-4 per
# element over the run, under 2% of the movement).  U against the plain
# versions, which round attention's output to bf16 apart on up to 2% of
# elements, and whose AdamW updates then part on every gradient element
# near 0: per-epoch losses within one step of the final margin, 2^-5.
P_LOSS_RTOL = 2.0 ** -9
P_WEIGHTS_REL = 5e-2
BF16_PLAIN_LOSS_RTOL = 2.0 ** -5
# grad_accum_steps=2 at batch 1024 against batch 2048 (SGD, lr 0.05): f32
# sums of the two half-batch means against one mean, duplicate ids added
# in another order, over 58 steps.  At lr 0.5 the two runs part
# on the card after 8 to 16 steps by up to 6e-3 (and stay within 1e-7 on
# the CPU): a step that large carries one run across a kink the other
# does not cross (a ReLU's, or the loss's clip at 1e-7), while at 0.05 and
# 0.005 they agree within 1.5e-8 and 1.2e-7 over the whole epoch.
ACCUM_LR = 0.05
ACCUM_ATOL = 1e-5


def log(*a):
    print(*a, flush=True)


def call_ms(torch, fn, iters):
    """Milliseconds per call of ``fn`` from the host, by CUDA events over
    ``iters`` back-to-back calls after warm-up: the host's launch cost is
    in the number wherever it exceeds the device's work."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters):
    """Device milliseconds per call of ``fn``: ``iters`` calls captured
    into one CUDA graph, replayed and timed by CUDA events, so the host's
    launch cost is out of the number."""
    from analytics_zoo_tpu_torch.core.graphs import collector_off

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with collector_off(), torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timings(torch, fns, iters):
    """``{name}_ms`` (device, CUDA graph) and ``{name}_call_ms`` (host
    loop) for each named function; None where the function is None."""
    out = {}
    for name, fn in fns.items():
        key = "ms" if name == "kernel" else f"{name}_ms"
        out[key] = device_ms(torch, fn, iters) if fn else None
        out[key.replace("ms", "call_ms")] = (call_ms(torch, fn, iters)
                                             if fn else None)
    return out


def cold_cycle(make, copies=None):
    """A function that calls ``make(i)()`` for i = 0, 1, ... in turn over
    ``copies`` inputs (default ``COLD_COPIES``): where each copy's bytes
    are tens of MB, a copy's data has left the 50 MB L2 by the time it
    comes round again, so each call reads it from device memory."""
    copies = copies or COLD_COPIES
    fns = [make(i) for i in range(copies)]
    turn = [0]

    def call():
        fns[turn[0] % copies]()
        turn[0] += 1
    return call


def bound(nbytes, flops, peak_flops=PEAK_F32_FLOPS):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the rate for their type (f32 unless
    ``peak_flops`` says otherwise)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops}


def device_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def kernel_events(torch, prof):
    """``key_averages`` rows of the device's kernels only.  The row of a
    host op (``aten::mm``, an autograd Function) carries the device time
    of the kernels it launched as well, so summing every row counts each
    kernel twice."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and device_us(e) > 0]


# ---------------------------------------------------------------------------
# kernel phase


def bag_case(torch, eb, label, vocab, dim, bags, nnz, combiner, pad_id,
             clip=False, iters=200, dtype=None, zipf=False, offset=0,
             ids=None):
    """The bag forward kernel against its plain version.  ``dtype`` is
    the table's (f32 by default); ``zipf`` draws the ids from
    ``zipf_ids``; ``ids`` (a (bags, nnz) int32 CUDA tensor) gives them;
    ``offset`` places the table that many elements into its buffer (rows
    off 16 bytes: narrower pieces).  Tolerance: f32 rtol
    1e-5 / atol 1e-5 elementwise; bf16 and f16 2^-7 or 2^-10 of |plain|
    (both sides round an f32 sum once into the table's type, and may land
    one unit apart) plus 1e-5 of the summed magnitude of the terms.  The
    bound counts the distinct live rows this run's ids read, in the
    table's element size."""
    import torch.nn.functional as F

    dtype = dtype or torch.float32
    g = torch.Generator(device="cuda").manual_seed(SEED + vocab + bags + nnz)
    buf = torch.randn(vocab * dim + offset, device="cuda", generator=g) * 0.5

    def make_table():
        return buf.to(dtype).clone()[offset:].view(vocab, dim)
    table = make_table()
    ids_given = ids is not None
    if not ids_given and zipf:
        ids = zipf_ids(torch, g, vocab, (bags, nnz))
    elif not ids_given:
        lo, hi = (-vocab // 8, vocab + vocab // 8) if clip else (0, vocab)
        ids = torch.randint(lo, hi, (bags, nnz), device="cuda", generator=g,
                            dtype=torch.int32)
    if pad_id is not None:
        ids[torch.rand(bags, nnz, device="cuda", generator=g) < 0.25] = pad_id
    out = eb.embedding_bag(table, ids, combiner, pad_id)
    ref = eb.embedding_bag_reference(table, ids, combiner, pad_id)
    torch.cuda.synchronize()
    err = (out.double() - ref.double()).abs()
    if dtype == torch.float32:
        ok = bool(torch.all(err <= 1e-5 + 1e-5 * ref.abs()))
    else:
        terms = eb.embedding_bag_reference(table.double().abs(), ids,
                                           combiner, pad_id)
        rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
        ok = bool(torch.all(err <= rtol * ref.double().abs() + 1e-5 * terms))
    live = ids if pad_id is None else ids[ids != pad_id]
    rows = int(torch.unique(live.clamp(0, vocab - 1)).numel())
    elem = table.element_size()
    nbytes = elem * (rows * dim + bags * dim) + 4 * bags * nnz
    flops = int(live.numel()) * dim + bags * dim
    library = None
    if combiner != "sqrtn" and not clip:
        lids = ids.long()

        def library():
            return F.embedding_bag(lids, table, mode=combiner,
                                   padding_idx=pad_id)
    case = {
        "case": label, "vocab": vocab, "dim": dim, "bags": bags,
        "nnz": nnz, "combiner": combiner, "pad_id": pad_id, "clip": clip,
        "zipf": zipf, "given_ids": ids_given,
        "dtype": str(dtype).replace("torch.", ""),
        "piece_bytes": eb.piece_bytes(elem, dim, table.data_ptr()),
        "distinct_rows": rows,
        "max_abs_err": float(err.max()),
        "max_rel_err": float(err.max() / ref.abs().max().clamp_min(1e-30)),
        **bound(nbytes, flops),
        **timings(torch, {
            "kernel": lambda: eb.embedding_bag(table, ids, combiner, pad_id),
            "plain": lambda: eb.embedding_bag_reference(table, ids,
                                                        combiner, pad_id),
            "library": library}, iters),
    }
    if vocab * dim * elem > L2_BYTES:
        # the same launches on rows that are not in L2
        copies = [make_table() for _ in range(COLD_COPIES)]
        case["cold_ms"] = device_ms(torch, cold_cycle(
            lambda i: lambda: eb.embedding_bag(copies[i], ids, combiner,
                                               pad_id)), 3 * COLD_COPIES)
        case["library_cold_ms"] = library and device_ms(torch, cold_cycle(
            lambda i: lambda: F.embedding_bag(lids, copies[i], mode=combiner,
                                              padding_idx=pad_id)),
            3 * COLD_COPIES)
        del copies
    if not ok:
        raise AssertionError(f"embedding_bag kernel disagrees with its "
                             f"plain version: {case}")
    return case


def zipf_ids(torch, gen, vocab, shape, s=1.0):
    """Ids drawn with P(row k) proportional to 1 / (k + 1)^s: row 0 is
    the hottest, as in skewed recommender traffic."""
    weights = torch.arange(1, vocab + 1, device="cuda",
                           dtype=torch.float64) ** -s
    cdf = torch.cumsum(weights, 0)
    u = torch.rand(shape, device="cuda", generator=gen,
                   dtype=torch.float64) * cdf[-1]
    return torch.searchsorted(cdf, u).clamp_(max=vocab - 1).to(torch.int32)


def replayed(torch, fn):
    """``fn()``'s result from one replay of a CUDA graph that captured it
    (after a warm-up call on a side stream, as ``device_ms`` does)."""
    from analytics_zoo_tpu_torch.core.graphs import collector_off

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with collector_off(), torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    del graph
    return out


def bag_bwd_case(torch, eb, label, vocab, dim, bags, nnz, combiner,
                 pad_id, clip=False, zipf=False, iters=200, ids=None):
    """The backward kernel against its plain version (``ids``, a (bags,
    nnz) int32 CUDA tensor, gives the ids).  Tolerance: 1e-6 + 1e-5 of
    each element's summed magnitude (the kernel adds in another fixed
    order than ``index_add_``).  The kernel is deterministic, and this is
    held bit for bit: a second call and one replay of a CUDA graph that
    captured it give the first call's bits.  A table of 2^31 elements or
    more also gets ids at both of its ends and at the first row past 2^31
    elements; its 8 GiB buffers are freed before the timings."""
    g_ = torch.Generator(device="cuda").manual_seed(SEED + 7 * vocab + nnz)
    ids_given = ids is not None
    if not ids_given and zipf:
        ids = zipf_ids(torch, g_, vocab, (bags, nnz))
    elif not ids_given:
        lo, hi = (-vocab // 8, vocab + vocab // 8) if clip else (0, vocab)
        ids = torch.randint(lo, hi, (bags, nnz), device="cuda",
                            generator=g_, dtype=torch.int32)
    if vocab * dim >= 1 << 31:
        ids[0, :3] = torch.tensor([0, vocab - 1, -(-(1 << 31) // dim)],
                                  dtype=torch.int32)
    if pad_id is not None:
        ids[torch.rand(bags, nnz, device="cuda", generator=g_) < 0.25] = \
            pad_id
    grad = torch.randn(bags, dim, device="cuda", generator=g_)
    plan = eb.bag_bwd_plan(vocab, dim, bags, nnz)

    def kernel():
        return eb.embedding_bag_backward(vocab, ids, grad, combiner, pad_id)

    got = kernel()
    bits = {"bit_equal_repeat": bool(torch.equal(kernel(), got)),
            "bit_equal_graph_replay": bool(torch.equal(
                replayed(torch, kernel), got))}
    torch.cuda.empty_cache()
    ref = eb.embedding_bag_backward_reference(vocab, ids, grad, combiner,
                                              pad_id)
    mass = eb.embedding_bag_backward_reference(vocab, ids, grad.abs(),
                                               combiner, pad_id)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    ok = bool(torch.all(err <= 1e-6 + 1e-5 * mass)) and all(bits.values())
    max_abs_err = float(err.max())
    max_rel_err = float((err / mass.clamp_min(1e-30)).max())
    del got, ref, mass, err
    torch.cuda.empty_cache()
    live = (torch.ones_like(ids, dtype=torch.bool) if pad_id is None
            else ids != pad_id)
    n_live = int(live.sum())
    # the same contributions for the one-call yardstick
    mask = live.float()
    scale = eb._combiner_scale(mask, combiner)
    contrib = ((grad * scale)[:, None, :] * mask[..., None])[live]
    lids = ids.long().clamp(0, vocab - 1)[live]

    def library():
        return torch.zeros(vocab, dim, device="cuda").index_add_(
            0, lids, contrib)

    rows = int(torch.unique(lids).numel())
    hottest = int(torch.bincount(lids).max()) if n_live else 0
    case = {
        "case": label, "vocab": vocab, "dim": dim, "bags": bags,
        "nnz": nnz, "combiner": combiner, "pad_id": pad_id, "clip": clip,
        "zipf": zipf, "given_ids": ids_given, "live_slots": n_live,
        "distinct_rows": rows, "hottest_row_slots": hottest,
        "table_elements": vocab * dim,
        "route": plan.route, "chunks": plan.chunks,
        "device_kernels_per_call": plan.device_ops,
        "workspace_bytes": plan.workspace_bytes,
        "zeroed_bytes": plan.zeroed_bytes, **bits,
        "max_abs_err": max_abs_err, "max_rel_err": max_rel_err,
        **bound(4 * (vocab * dim + bags * dim + bags * nnz),
                n_live * dim + bags * dim),
        **timings(torch, {
            "kernel": kernel,
            "plain": lambda: eb.embedding_bag_backward_reference(
                vocab, ids, grad, combiner, pad_id),
            "library": library}, iters),
    }
    if not ok:
        raise AssertionError(f"embedding_bag backward kernel disagrees with "
                             f"its plain version or is not deterministic: "
                             f"{case}")
    return case


def dq_bound(torch, dtype, nbytes, flops):
    """``bound`` for the dequantize-matmul: f32 x at the card's
    f32-accurate tensor rate, three bf16 products per product (989 / 3 =
    330 TFLOP/s), bf16 and f16 x at 989 TFLOP/s; the time at the CUDA
    cores' 67 TFLOP/s kept beside it."""
    peak = PEAK_BF16_FLOPS / 3 if dtype == torch.float32 else PEAK_BF16_FLOPS
    return {**bound(nbytes, flops, peak),
            "ops_bound_ms_cuda_cores": flops / PEAK_F32_FLOPS * 1e3}


def dq_case(torch, dq, label, m, k, n, bits, iters=200, dtype=None):
    """The dequantize-matmul kernel against its plain version.  Tolerance:
    f32 x max |err| <= 1e-4 * max |plain| (K-long f32 sums in another
    order); bf16 and f16 x |err| <= 2^-7 (bf16) or 2^-10 (f16) * |plain|
    + 1e-5 * max |plain| elementwise: both sides are f32 results rounded
    once to x's type, and two f32 values a few ulps apart may round to
    neighbouring values of it.  The yardstick (``library``) is one
    ``torch.matmul`` of x and the dequantized weight, cast to x's type
    for bf16 and f16 x (``library_call``)."""
    dtype = dtype or torch.float32
    rs = np.random.RandomState(SEED + m + k + bits)
    w = torch.from_numpy(rs.randn(k, n).astype(np.float32))
    q, scale = dq.quantize_weights(w, bits=bits)
    q, scale = q.cuda(), scale.cuda()
    g = torch.Generator(device="cuda").manual_seed(SEED + m + k)
    x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
    out = dq.dequant_matmul(x, q, scale, bits=bits, rows=k)
    ref = dq.dequant_matmul_reference(x, q, scale, bits=bits, rows=k)
    torch.cuda.synchronize()
    diff = (out.double() - ref.double()).abs()
    err = float(diff.max())
    top = float(ref.abs().max())
    if dtype == torch.float32:
        ok = err <= 1e-4 * top
    else:
        rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
        ok = bool(torch.all(diff <= rtol * ref.double().abs() + 1e-5 * top))
    w_lib = ((dq.unpack_int4(q, k) if bits == 4 else q).float()
             * scale.reshape(1, -1)).to(dtype)
    esize = x.element_size()
    case = {
        "case": label, "m": m, "k": k, "n": n, "bits": bits,
        "dtype": str(dtype).replace("torch.", ""), "out_dtype":
        str(out.dtype).replace("torch.", ""),
        "max_abs_err": err, "max_rel_err": err / max(top, 1e-30),
        **dq_bound(torch, dtype, esize * m * k + q.numel() + 4 * n
                   + esize * m * n, 2 * m * n * k),
        "library_call": "torch.matmul(x, dequant(q)"
                        + ("" if dtype == torch.float32 else
                           f".to({str(dtype).replace('torch.', '')})") + ")",
        **timings(torch, {
            "kernel": lambda: dq.dequant_matmul(x, q, scale, bits=bits,
                                                rows=k),
            "plain": lambda: dq.dequant_matmul_reference(
                x, q, scale, bits=bits, rows=k),
            "library": lambda: torch.matmul(x, w_lib)}, iters),
    }
    if not ok or out.dtype != x.dtype:
        raise AssertionError(f"dequant_matmul kernel disagrees with its "
                             f"plain version: {case}")
    return case


def sdpa_call(torch, q, k, v, causal, ref, tol, flash=True):
    """The one-call yardstick for flash attention:
    ``F.scaled_dot_product_attention`` on the same inputs, pinned to the
    first backend of flash (left out when ``flash`` is false),
    memory-efficient, cuDNN and math that takes them and answers within
    ``tol`` = (atol, rtol) of the plain version's ``ref``.  Its
    ``is_causal`` is top-left aligned, so a causal call with
    Lq < Lk passes the bottom-right mask explicitly; with Lq > Lk some
    rows see no key, which SDPA does not answer with 0, so there is no
    yardstick (None, None)."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    lq, lk = q.shape[2], k.shape[2]
    if causal and lq > lk:
        return None, None
    kw = {}
    if causal and lq == lk:
        kw["is_causal"] = True
    elif causal:
        qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        kw["attn_mask"] = qpos >= torch.arange(lk, device=q.device)[None, :]
    backends = ((SDPBackend.FLASH_ATTENTION,) if flash else ()) + (
        SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
        SDPBackend.MATH)
    for backend in backends:
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v, **kw)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                err = (call().float() - ref.float()).abs()
                torch.cuda.synchronize()
        except RuntimeError:
            continue
        if not bool(torch.all(err <= tol[0] + tol[1] * ref.float().abs())):
            log("sdpa backend disagrees with the plain version",
                backend.name, tuple(q.shape), q.dtype, float(err.max()))
            continue
        return call, backend.name
    return None, None


def bf16_mismatch_share(torch, out, ref):
    """For bf16 outputs, the share of elements whose bf16 value differs
    from the plain version's (an f32 result rounded once), else None.
    The kernel's p enters P.V as two bf16 terms, 16 bits; p rounded once
    to bf16 keeps 8 and moves many more outputs to a neighbouring bf16
    value, while every output stays within the tolerance."""
    if out.dtype != torch.bfloat16:
        return None
    return float((out != ref).float().mean())


def flash_inputs(torch, g, b, h, d, dtype, lengths, offset):
    """Seeded (B, H, L, D) tensors, one per length; with ``offset``
    each is ``x[..., offset:]`` of a (B, L, H, D + offset) buffer seen as
    (B, H, L, D), so rows start off 16 bytes (offset 1)."""
    if offset:
        return tuple(torch.randn(b, n, h, d + offset, device="cuda",
                                 generator=g).to(dtype)[..., offset:]
                     .transpose(1, 2) for n in lengths)
    return tuple(torch.randn(b, h, n, d, device="cuda", generator=g)
                 .to(dtype) for n in lengths)


def attention_bound(torch, dtype, nbytes, flops):
    """``bound`` for attention: f32 operations at the f32-accurate
    tensor rate (split-TF32, 165 TFLOP/s), bf16 at 989 TFLOP/s; the f32
    time at the CUDA cores' 67 TFLOP/s kept beside it."""
    if dtype == torch.bfloat16:
        return bound(nbytes, flops, PEAK_BF16_FLOPS)
    return {**bound(nbytes, flops, PEAK_F32_TENSOR_FLOPS),
            "ops_bound_ms_cuda_cores": flops / PEAK_F32_FLOPS * 1e3}


def flash_case(torch, fa, label, b, h, lq, lk, d, causal,
               dtype=None, iters=50, offset=0):
    """The flash kernel against its plain version.  Tolerance: f32
    |err| <= 2e-5 + 1e-4 * |plain| elementwise (split-TF32 products and
    sums in another order); bf16 outputs differ by at most one bf16
    rounding of an f32 result: |err| <= 8e-3 + 8e-3 * |plain|, and at
    most ``BF16_MISMATCH_LIMIT`` of them differ from the plain version's
    bf16 value (split P).  Rows with no live key must be exactly 0."""
    dtype = dtype or torch.float32
    g = torch.Generator(device="cuda").manual_seed(SEED + lq + 3 * lk + d)
    q, k, v = flash_inputs(torch, g, b, h, d, dtype, (lq, lk, lk), offset)
    out = fa.flash_attention(q, k, v, causal=causal)
    ref = fa.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    atol, rtol = (8e-3, 8e-3) if dtype == torch.bfloat16 else (2e-5, 1e-4)
    ok = bool(torch.all(err <= atol + rtol * ref.float().abs()))
    mismatch = bf16_mismatch_share(torch, out, ref)
    ok = ok and (mismatch is None or mismatch <= BF16_MISMATCH_LIMIT)
    zero_rows = max(lq - lk, 0) if causal else 0
    if zero_rows:
        ok = ok and not bool(out[:, :, :zero_rows].any())
    pairs = live_pairs(torch, lq, lk, causal)
    elt = out.element_size()
    # SDPA's flash backend faults on rows off 16 bytes (misaligned
    # address), which ends the process's CUDA context: those legs take
    # the next backend that answers right (the memory-efficient one
    # refuses them, cuDNN's bf16 answer is wrong there)
    library, backend = sdpa_call(torch, q, k, v, causal, ref, (atol, rtol),
                                 flash=not offset)
    lib_err = None
    if library is not None:
        lib_err = float((library().float() - ref.float()).abs().max())
    case = {
        "case": label, "b": b, "h": h, "lq": lq, "lk": lk, "d": d,
        "causal": causal, "dtype": str(dtype).replace("torch.", ""),
        "row_offset": offset,
        "tolerance": {"atol": atol, "rtol": rtol}, "zero_rows": zero_rows,
        "max_abs_err": float(err.max()),
        "max_rel_err": float(err.max() / ref.float().abs().max()
                             .clamp_min(1e-30)),
        "bf16_mismatch_share": mismatch,
        "library_call": (f"scaled_dot_product_attention[{backend}]"
                         if backend else None),
        "library_max_abs_err_vs_plain": lib_err,
        **attention_bound(torch, dtype, elt * b * h * (2 * lq + 2 * lk) * d,
                          4 * b * h * pairs * d),
        **timings(torch, {
            "kernel": lambda: fa.flash_attention(q, k, v, causal=causal),
            "plain": lambda: fa.flash_attention_reference(q, k, v,
                                                          causal=causal),
            "library": library}, iters),
    }
    if not ok:
        raise AssertionError(f"flash_attention kernel disagrees with its "
                             f"plain version: {case}")
    return case


def flash_cases(torch, fa):
    bf16 = torch.bfloat16
    return [
        flash_case(torch, fa, "bert_l128", 32, 12, 128, 128, 64, False),
        flash_case(torch, fa, "bert_l512", 8, 12, 512, 512, 64, False),
        flash_case(torch, fa, "bench_l2048", 4, 8, 2048, 2048, 64, False,
                   iters=5),
        flash_case(torch, fa, "bench_l2048_d128_causal", 4, 8, 2048, 2048,
                   128, True, iters=5),
        flash_case(torch, fa, "ragged_l77_causal", 8, 12, 77, 77, 64, True),
        flash_case(torch, fa, "causal_lq128_lk384", 8, 12, 128, 384, 64,
                   True),
        flash_case(torch, fa, "causal_lq384_lk128", 8, 12, 384, 128, 64,
                   True),
        flash_case(torch, fa, "bert_l512_bf16", 8, 12, 512, 512, 64, False,
                   dtype=bf16),
        flash_case(torch, fa, "bert_l128_bf16", 32, 12, 128, 128, 64, False,
                   dtype=bf16),
        flash_case(torch, fa, "ragged_d24", 8, 12, 256, 256, 24, False),
        flash_case(torch, fa, "ragged_d72_bf16", 8, 12, 256, 256, 72, False,
                   dtype=bf16),
        flash_case(torch, fa, "misaligned_l128", 32, 12, 128, 128, 64, False,
                   offset=1),
        flash_case(torch, fa, "misaligned_l128_bf16", 32, 12, 128, 128, 64,
                   False, dtype=bf16, offset=1),
    ]


def live_pairs(torch, lq, lk, causal):
    """(query, key) pairs with a live logit: this run's work."""
    if not causal:
        return lq * lk
    i = torch.arange(lq, dtype=torch.int64)
    return int((i + (lk - lq) + 1).clamp(0, lk).sum())


def efficient_attention(torch, q, k, v, do, causal):
    """aten's memory-efficient attention, SDPA's backend for f32 (the
    flash backend refuses f32), on the same inputs: ``(fwd, bwd)``, its
    forward with the logsumexp and its backward (dQ, dK, dV and delta
    together); (None, None) where it refuses the case.  Its ``is_causal``
    is top-left aligned, so a causal call with Lq < Lk passes the
    bottom-right mask as an additive bias; with Lq > Lk some rows see no
    key, which it does not answer with 0, so there is no yardstick."""
    import warnings

    b, h, lq, d = q.shape
    lk = k.shape[2]
    if causal and lq > lk:
        return None, None
    bias, is_causal = None, False
    if causal and lq == lk:
        is_causal = True
    elif causal:
        qpos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        live = qpos >= torch.arange(lk, device=q.device)[None, :]
        bias = torch.zeros(b, h, lq, lk, device=q.device,
                           dtype=q.dtype).masked_fill(~live, float("-inf"))
    scale = d ** -0.5
    fwd_op = torch.ops.aten._scaled_dot_product_efficient_attention
    bwd_op = torch.ops.aten._scaled_dot_product_efficient_attention_backward

    def fwd():
        return fwd_op(q, k, v, bias, True, 0.0, is_causal, scale=scale)

    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out, lse, seed, offset = fwd()

            def bwd():
                return bwd_op(do, q, k, v, bias, out, lse, seed, offset, 0.0,
                              [True, True, True, False], is_causal,
                              scale=scale)
            bwd()
            torch.cuda.synchronize()
    except (RuntimeError, TypeError, NotImplementedError) as e:
        log("efficient_attention refused", tuple(q.shape), tuple(k.shape),
            causal, str(e)[:160])
        return None, None
    return fwd, bwd


def flash_train_case(torch, fa, label, b, h, lq, lk, d, causal, dtype=None,
                     iters=20, offset=0):
    """The training kernels against their plain versions on one input:
    the lse forward (out and lse), then dQ and dK/dV from its out and
    lse.  Returns three cases, one per kernel."""
    dtype = dtype or torch.float32
    g = torch.Generator(device="cuda").manual_seed(SEED + 5 * lq + lk + d)
    q, k, v, do = flash_inputs(torch, g, b, h, d, dtype, (lq, lk, lk, lq),
                               offset)
    scale = d ** -0.5
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    ref_out, ref_lse = fa.flash_attention_lse_reference(q, k, v,
                                                        causal=causal)
    ops = fa.bwd_operands(q, k, v, out, lse, do)
    grads = (fa.launch_bwd_dq(*ops, causal, scale),
             *fa.launch_bwd_dkv(*ops, causal, scale))
    again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    atol, rtol = (8e-3, 8e-3) if bf16 else (2e-5, 1e-4)

    def check(got, want):
        err = (got.float() - want.float()).abs()
        top = want.float().abs()
        return (float(err.max()), float(err.max() / top.max().clamp_min(
            1e-30)), bool(torch.all(err <= atol + rtol * top)))

    live = ref_lse > fa.NEG_INF / 2
    lse_err = (lse - ref_lse.float()).abs()[live]
    lse_ok = (bool(torch.all(lse_err <= 2e-5 + 1e-5 * ref_lse[live].abs()))
              and bool(torch.all(lse[~live] <= fa.NEG_INF / 2)))
    zero_rows = max(lq - lk, 0) if causal else 0
    zero_ok = not zero_rows or not bool(grads[0][:, :, :zero_rows].any())
    bitwise = all(torch.equal(x, y) for x, y in zip(grads, again))
    pairs = live_pairs(torch, lq, lk, causal)
    elt, bh = q.element_size(), b * h
    lib_fwd, lib_bwd = efficient_attention(torch, q, k, v, do, causal)
    lib_err = None
    if lib_bwd is not None:
        lib_err = float((lib_bwd()[0].float() - ref[0].float()).abs().max())
    pair = timings(torch, {
        "kernel": lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                 causal),
        "plain": lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse,
                                                          do, causal),
        "library": lib_bwd}, iters)
    common = {"case": label, "b": b, "h": h, "lq": lq, "lk": lk, "d": d,
              "causal": causal, "dtype": str(dtype).replace("torch.", ""),
              "row_offset": offset, "tolerance": {"atol": atol, "rtol": rtol},
              "zero_rows": zero_rows, "live_pairs_per_head": pairs}
    o_abs, o_rel, o_ok = check(out, ref_out)
    mismatch = bf16_mismatch_share(torch, out, ref_out)
    o_ok = o_ok and (mismatch is None or mismatch <= BF16_MISMATCH_LIMIT)
    # bf16: F.scaled_dot_product_attention (flash backend first) beside
    # aten's lse forward, for the same out without the lse
    sdpa, sdpa_backend = (sdpa_call(torch, q, k, v, causal, ref_out,
                                    (atol, rtol), flash=not offset)
                          if bf16 else (None, None))
    sdpa_ms = timings(torch, {"library": sdpa}, iters) if sdpa else {}
    cases = [{
        **common, "kernel": "flash_attention_fwd_lse", "max_abs_err": o_abs,
        "sdpa_backend": sdpa_backend,
        "sdpa_ms": sdpa_ms.get("library_ms"),
        "sdpa_call_ms": sdpa_ms.get("library_call_ms"),
        "max_rel_err": o_rel,
        "lse_max_abs_err": float(lse_err.max()) if live.any() else 0.0,
        "bf16_mismatch_share": mismatch,
        "library_call": ("aten._scaled_dot_product_efficient_attention"
                         "(compute_log_sumexp=True)" if lib_fwd else None),
        **attention_bound(torch, dtype,
                          bh * (elt * (2 * lq + 2 * lk) * d + 4 * lq),
                          4 * bh * pairs * d),
        **timings(torch, {
            "kernel": lambda: fa.flash_attention_lse(q, k, v, causal=causal),
            "plain": lambda: fa.flash_attention_lse_reference(
                q, k, v, causal=causal),
            "library": lib_fwd}, iters)}]
    oks = [o_ok, lse_ok, zero_ok, bitwise]
    for name, got, want, nbytes, n_ops, fn in (
            ("flash_attention_bwd_dq", grads[:1], ref[:1],
             bh * (elt * (3 * lq + 2 * lk) * d + 8 * lq), 6,
             lambda: fa.launch_bwd_dq(*ops, causal, scale)),
            ("flash_attention_bwd_dkv", grads[1:], ref[1:],
             bh * (elt * (2 * lq + 4 * lk) * d + 8 * lq), 8,
             lambda: fa.launch_bwd_dkv(*ops, causal, scale))):
        checks = [check(x, y) for x, y in zip(got, want)]
        shares = [bf16_mismatch_share(torch, x, y) for x, y in zip(got, want)]
        oks.append(all(c[2] for c in checks) and all(
            x is None or x <= BF16_MISMATCH_LIMIT for x in shares))
        cases.append({
            **common, "kernel": name,
            "max_abs_err": max(c[0] for c in checks),
            "max_rel_err": max(c[1] for c in checks),
            "bf16_mismatch_share": max(shares) if bf16 else None,
            "bf16_mismatch_shares": shares if bf16 else None,
            "bitwise_reproducible": bitwise,
            "library_call": (
                "aten._scaled_dot_product_efficient_attention_backward "
                "(dQ, dK, dV and delta together)" if lib_bwd else None),
            "library_dq_max_abs_err_vs_plain": lib_err,
            **attention_bound(torch, dtype, nbytes, n_ops * bh * pairs * d),
            **timings(torch, {"kernel": fn}, iters),
            "pair_ms": pair["ms"], "pair_call_ms": pair["call_ms"],
            "plain_ms": pair["plain_ms"],
            "plain_call_ms": pair["plain_call_ms"],
            "library_ms": pair["library_ms"],
            "library_call_ms": pair["library_call_ms"],
            "plain_and_library_are_the_pair": True})
    if not all(oks):
        raise AssertionError(f"flash training kernels disagree with their "
                             f"plain versions (out/lse/zero rows/bitwise/"
                             f"dq/dkv ok, dq/dkv with their bf16 mismatch "
                             f"shares: {oks}): {cases}")
    return cases


def flash_train_cases(torch, fa):
    """Lists of lse, dQ and dK/dV cases at the training kernels' shapes."""
    rows = [
        flash_train_case(torch, fa, "bert_train_l128", 32, 12, 128, 128, 64,
                         False),
        flash_train_case(torch, fa, "bench_l2048", 4, 8, 2048, 2048, 64,
                         False, iters=3),
        flash_train_case(torch, fa, "bench_l2048_d128_causal", 4, 8, 2048,
                         2048, 128, True, iters=3),
        flash_train_case(torch, fa, "ragged_l77_causal", 8, 12, 77, 77, 64,
                         True),
        flash_train_case(torch, fa, "causal_lq128_lk384", 8, 12, 128, 384,
                         64, True),
        flash_train_case(torch, fa, "causal_lq384_lk128", 8, 12, 384, 128,
                         64, True),
        flash_train_case(torch, fa, "bert_l512_bf16", 8, 12, 512, 512, 64,
                         False, dtype=torch.bfloat16),
        flash_train_case(torch, fa, "bert_train_l128_bf16", 32, 12, 128, 128,
                         64, False, dtype=torch.bfloat16),
        flash_train_case(torch, fa, "ragged_d24", 8, 12, 256, 256, 24, False),
        flash_train_case(torch, fa, "ragged_d72_bf16", 8, 12, 256, 256, 72,
                         False, dtype=torch.bfloat16),
        flash_train_case(torch, fa, "misaligned_l128", 32, 12, 128, 128, 64,
                         False, offset=1),
        flash_train_case(torch, fa, "misaligned_l128_bf16", 32, 12, 128, 128,
                         64, False, dtype=torch.bfloat16, offset=1),
    ]
    return [list(c) for c in zip(*rows)]


def kernel_phase(torch, eb, dq):
    bag_cases, dq_cases = [], []
    for vocab in (USERS + 1, ITEMS + 1):
        for bags in (1, 8, 64, 256):
            bag_cases.append(bag_case(
                torch, eb, "slice", vocab, 20, bags, 1, "sum", None))
    for combiner in ("sum", "mean", "sqrtn"):
        for pad_id in (0, None):
            bag_cases.append(bag_case(
                torch, eb, "large", 1 << 20, 64, 4096, 32, combiner,
                pad_id, iters=20))
    bag_cases.append(bag_case(torch, eb, "large_clip", 1 << 20, 64, 4096,
                              32, "sum", None, clip=True, iters=20))
    for dtype in (torch.bfloat16, torch.float16):
        bag_cases.append(bag_case(torch, eb, "large", 1 << 20, 64, 4096, 32,
                                  "sum", None, iters=20, dtype=dtype))
    bag_cases.append(bag_case(torch, eb, "large_zipf", 1 << 20, 64, 4096,
                              32, "sum", None, iters=20, zipf=True))
    # the table one element into its buffer: rows on 4 bytes, 4-byte pieces
    bag_cases.append(bag_case(torch, eb, "large_off16", 1 << 20, 64, 4096,
                              32, "sum", None, iters=20, offset=1))
    bwd_cases = [bag_bwd_case(torch, eb, "slice", USERS + 1, 20,
                              TRAIN_BATCH, 1, "sum", None),
                 bag_bwd_case(torch, eb, "slice", ITEMS + 1, 20,
                              TRAIN_BATCH, 1, "sum", None)]
    for combiner in ("sum", "mean", "sqrtn"):
        for pad_id in (None, 0):
            bwd_cases.append(bag_bwd_case(
                torch, eb, "large", 1 << 20, 64, 4096, 32, combiner, pad_id,
                iters=20))
    bwd_cases.append(bag_bwd_case(torch, eb, "large_zipf", 1 << 20, 64, 4096,
                                  32, "sum", None, zipf=True, iters=20))
    bwd_cases.append(bag_bwd_case(torch, eb, "large_clip", 1 << 20, 64, 4096,
                                  32, "sum", None, clip=True, iters=20))
    # V * D just past 2^31: an 8 GiB table gradient
    bwd_cases.append(bag_bwd_case(torch, eb, "past_2^31", (1 << 25) + 3, 64,
                                  4096, 32, "sum", None, iters=3))
    for bits in (8, 4):
        for m in (1, 8, 64, 256):
            dq_cases.append(dq_case(torch, dq, "slice", m, 40, 40, bits))
        dq_cases.append(dq_case(torch, dq, "large", 1024, 4096, 4096, bits,
                                iters=10))
    dq_cases.append(dq_case(torch, dq, "large_odd_k", 1024, 4095, 4096, 4,
                            iters=10))
    for dtype in (torch.bfloat16, torch.float16):
        dq_cases.append(dq_case(torch, dq, "large", 1024, 4096, 4096, 8,
                                iters=10, dtype=dtype))
    # BERT-Base's Dense layers at B L = 32 x 128
    for k, n, bits in ((768, 768, 8), (768, 3072, 8), (3072, 768, 8),
                       (768, 3072, 4)):
        dq_cases.append(dq_case(torch, dq, "bert", 4096, k, n, bits,
                                iters=10))
    # M past 65,535 tiles of 64 rows (the former grid y limit)
    dq_cases.append(dq_case(torch, dq, "rows_past_grid_y", 4194305, 40, 40,
                            8, iters=3))
    for c in bag_cases + bwd_cases + dq_cases:
        log("kernel_case", json.dumps(c))
    return bag_cases, bwd_cases, dq_cases


# ---------------------------------------------------------------------------
# serving phase


def seeded_params(model, seed):
    """Random weights in the JAX package's tree layout (tables and dense
    kernels scaled so the softmax head is far from uniform)."""
    rs = np.random.RandomState(seed)
    return {layer: {leaf: (rs.randn(*v.shape) * 0.5).astype(np.float32)
                    for leaf, v in sub.items()}
            for layer, sub in model.params().items()}


def serve(ncf, im, weight_dtype, batcher_cls, users, items):
    """Answer single requests from six threads through a DynamicBatcher,
    then one recommend_for_user over every item.  Returns the answers,
    the recommendation and the request latencies in ms."""
    batcher = batcher_cls(im, max_batch=32, max_latency_ms=2.0)
    answers = [None] * len(users)
    lat_ms = [None] * len(users)
    errors = []

    def client(rows):
        for r in rows:
            t0 = time.perf_counter()
            try:
                answers[r] = batcher.predict([users[r:r + 1],
                                              items[r:r + 1]])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
            lat_ms[r] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=client,
                                args=(range(t, len(users), 6),))
               for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    batcher.close()
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"{weight_dtype} serving failed: {errors[:1]}")
    rec = ncf.recommend_for_user(1, np.arange(1, ITEMS + 1), max_items=10)
    return np.concatenate(answers), rec, lat_ms


def serving_phase(torch, eb, dq):
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.deploy import DynamicBatcher
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.observe.metrics import METRICS
    from analytics_zoo_tpu_torch.ops.dispatch import PATH_REFERENCE, forced

    ncf = NeuralCF(USERS, ITEMS, class_num=5, user_embed=20, item_embed=20,
                   hidden_layers=(40, 20, 10), mf_embed=20, device="cuda")
    load_jax_params(ncf.model, seeded_params(ncf.model, SEED))
    rs = np.random.RandomState(SEED + 1)
    users = rs.randint(1, USERS + 1, (48, 1)).astype(np.int32)
    items = rs.randint(1, ITEMS + 1, (48, 1)).astype(np.int32)
    all_items = np.arange(1, ITEMS + 1).reshape(-1, 1).astype(np.int32)
    results = {}

    # the main path's window: the launch counts start at 0 here, and the
    # routing counters are read as the window since this snapshot
    eb.LAUNCHES.reset()
    eb.BWD_LAUNCHES.reset()
    dq.LAUNCHES.reset()
    window = METRICS.snapshot()
    for wd in ("float32", "int8", "int4"):
        init_zoo_context()
        im = ncf.inference_model(weight_dtype=wd)
        n0 = (eb.LAUNCHES.value, dq.LAUNCHES.value)
        im.predict([users[:1], items[:1]])
        per_forward = (eb.LAUNCHES.value - n0[0], dq.LAUNCHES.value - n0[1])
        want = (4, 0 if wd == "float32" else 1)
        if per_forward != want:
            raise AssertionError(f"{wd}: one forward launched "
                                 f"{per_forward} (bag, dq), want {want}")
        t0 = time.perf_counter()
        answers, rec, lat = serve(ncf, im, wd, DynamicBatcher, users, items)
        wall = time.perf_counter() - t0
        got_scores = (im.predict([np.full_like(all_items, 1), all_items],
                                 batch_size=1024) * np.arange(1, 6)).sum(-1)
        n1 = (eb.LAUNCHES.value, dq.LAUNCHES.value)

        # the same model through the plain versions, on the card
        with forced(PATH_REFERENCE):
            ref = im.predict([users, items])
            ref_scores = (im.predict([np.full_like(all_items, 1), all_items],
                                     batch_size=1024)
                          * np.arange(1, 6)).sum(-1)
        if (eb.LAUNCHES.value, dq.LAUNCHES.value) != n1:
            raise AssertionError("a kernel launched on the plain path")

        if answers.shape != (48, 5) or not np.all(np.isfinite(answers)):
            raise AssertionError(f"{wd}: bad answers {answers.shape}")
        if not np.allclose(answers.sum(-1), 1.0, atol=1e-5):
            raise AssertionError(f"{wd}: rows do not sum to 1")
        err = float(np.abs(answers - ref).max())
        score_err = float(np.abs(got_scores - ref_scores).max())
        tenth = np.sort(ref_scores)[-10]
        rec_ok = (len(rec) == 10 and all(
            ref_scores[item - 1] >= tenth - 1e-5 for item, _ in rec))
        if err > 1e-5 or score_err > 1e-5 or not rec_ok:
            raise AssertionError(
                f"{wd}: kernels disagree with the plain path: answers "
                f"{err}, scores {score_err}, top-10 ok {rec_ok}")
        results[wd] = {
            "requests": len(lat), "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "batcher_wall_s": wall, "max_abs_err_vs_plain": err,
            "launches_one_forward": list(per_forward),
            "weight_nbytes": im.weight_nbytes(),
            "top1_item": rec[0][0]}
        log("serving", wd, json.dumps(results[wd]))

    launches = {"embedding_bag": eb.LAUNCHES.value,
                "dequant_matmul": dq.LAUNCHES.value}
    counters = METRICS.delta(window)["counters"]
    routed = {k: counters.get(
        f'ops_kernel_selected_total{{kernel="{k}",path="cuda"}}', 0)
        for k in ("embedding_gather", "dequant_matmul")}
    log("serving_launches", json.dumps(launches),
        "ops_kernel_selected_total{path=cuda}", json.dumps(routed))
    if not all(routed.values()) or not all(launches.values()):
        raise AssertionError(f"main path missed a kernel: {launches} "
                             f"{routed}")
    if eb.BWD_LAUNCHES.value:
        raise AssertionError("serving launched the backward kernel")
    return launches


# ---------------------------------------------------------------------------
# BERT serving phase


def bert_requests(n, length, seed):
    rs = np.random.RandomState(seed)
    return [[rs.randint(0, BERT_BASE["vocab"], (1, length)).astype(np.int32),
             rs.randint(0, 2, (1, length)).astype(np.int32)]
            for _ in range(n)]


def serve_requests(batcher, reqs, n_threads):
    """Each request alone through the batcher, from ``n_threads``
    threads; returns the answers and their latencies in ms."""
    answers = [None] * len(reqs)
    lat_ms = [None] * len(reqs)
    errors = []

    def client(rows):
        for r in rows:
            t0 = time.perf_counter()
            try:
                answers[r] = batcher.predict(reqs[r])
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
            lat_ms[r] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=client,
                                args=(range(t, len(reqs), n_threads),))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"BERT serving failed: {errors[:1]}")
    return np.concatenate(answers), lat_ms


def batch_of(reqs):
    """One batch from single-row requests."""
    return [np.concatenate([r[i] for r in reqs]) for i in range(2)]


def profile_forward(torch, im, xs):
    """One served forward under ``torch.profiler``: device time by kernel
    and the flash kernel's share of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        im.predict(xs)
        wall = time.perf_counter() - t0

    events = kernel_events(torch, prof)
    busy = sum(device_us(e) for e in events) / 1e3
    flash = sum(device_us(e) for e in events if "flash_fwd" in e.key) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:8]
    return {"rows": int(xs[0].shape[0]), "length": int(xs[0].shape[1]),
            "wall_ms": 1e3 * wall, "device_ms": busy,
            "device_busy_share": busy / (1e3 * wall) if wall else None,
            "flash_ms": flash, "flash_share_of_device": flash / busy
            if busy else None,
            "top_device_ms": {e.key[:60]: device_us(e) / 1e3 for e in top}}


def bert_serving_phase(torch, eb, dq, fa):
    """BERT-Base (12 blocks) served through ``InferenceModel`` behind a
    ``DynamicBatcher``: 48 single L=128 requests from six threads, then 8
    single L=512 requests from two, all tokens real (no mask).  Every
    block's self-attention launches the flash kernel."""
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.deploy import DynamicBatcher, InferenceModel
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.observe.metrics import METRICS
    from analytics_zoo_tpu_torch.ops.dispatch import PATH_REFERENCE, forced
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    init_zoo_context()
    reset_name_scope()
    t0 = time.perf_counter()
    net = BERTClassifier(num_classes=2, bert_config=BERT_BASE,
                         generator=torch.Generator().manual_seed(SEED))
    im = InferenceModel.from_keras_net(net, device="cuda",
                                       batch_buckets=(1, 8, 32))
    del net
    setup_s = time.perf_counter() - t0
    forwards = [0]
    plain_forward = im._bucket_forward

    rows = []

    def counted(xs):
        forwards[0] += 1
        rows.append(int(xs[0].shape[0]))
        return plain_forward(xs)

    im._bucket_forward = counted
    short = bert_requests(48, 128, SEED + 2)
    long = bert_requests(8, 512, SEED + 3)
    # first calls: cuBLAS, the kernels' loads, and one graph per bucket
    # signature (every bucket at both lengths: a signature's first
    # request runs eagerly, its second captures it)
    for reqs in (short, long):
        for b in (1, 8, 32):
            for _ in range(2):
                im.predict(batch_of((reqs * 4)[:b]))

    # the main path's window: counts start at 0 here
    reset_counts(eb, dq, fa)
    forwards[0] = 0
    rows.clear()
    window = METRICS.snapshot()
    im.predict(short[0])
    per_forward = fa.LAUNCHES.value
    batcher = DynamicBatcher(im, max_batch=32, max_latency_ms=2.0)
    t0 = time.perf_counter()
    ans128, lat128 = serve_requests(batcher, short, 6)
    wall128 = time.perf_counter() - t0
    t0 = time.perf_counter()
    ans512, lat512 = serve_requests(batcher, long, 2)
    wall512 = time.perf_counter() - t0
    batcher.close()
    torch.cuda.synchronize()
    launches = {"embedding_bag": eb.LAUNCHES.value,
                "embedding_bag_bwd": eb.BWD_LAUNCHES.value,
                "dequant_matmul": dq.LAUNCHES.value,
                "flash_attention": fa.LAUNCHES.value,
                "flash_training_kernels": sum(flash_counts(fa).values())
                - fa.LAUNCHES.value}
    n_forwards = forwards[0]
    bucket_rows = {str(b): rows.count(b) for b in sorted(set(rows))}
    counters = METRICS.delta(window)["counters"]
    sel = {p: counters.get(f'ops_kernel_selected_total{{kernel='
                           f'"flash_attention",path="{p}"}}', 0)
           for p in ("cuda", "reference")}

    # the same requests through the plain versions, on the card
    with forced(PATH_REFERENCE):
        ref128 = im.predict(batch_of(short))
        ref512 = im.predict(batch_of(long))
    err128 = float(np.abs(ans128 - ref128).max())
    err512 = float(np.abs(ans512 - ref512).max())

    # one masked request: the JAX package's other route, counted apart
    ids, seg = short[1]
    mask = np.ones_like(ids)
    mask[:, 100:] = 0
    w2 = METRICS.snapshot()
    n2 = fa.LAUNCHES.value
    masked = im.predict([ids, seg, mask])
    c2 = METRICS.delta(w2)["counters"]
    masked_sel = {p: c2.get(f'ops_kernel_selected_total{{kernel='
                            f'"flash_attention",path="{p}"}}', 0)
                  for p in ("cuda", "reference")}
    masked_launches = fa.LAUNCHES.value - n2

    profiles = [profile_forward(torch, im, batch_of(short[:32])),
                profile_forward(torch, im, batch_of(short[:8])),
                profile_forward(torch, im, batch_of(long))]
    out = {
        "model": {**BERT_BASE, "num_classes": 2, "weights": "float32",
                  "params": sum(int(np.prod(p.shape))
                                for p in im._net.parameters())},
        "setup_s": setup_s, "buckets": [1, 8, 32],
        "l128": {"requests": len(lat128),
                 "p50_ms": float(np.percentile(lat128, 50)),
                 "p99_ms": float(np.percentile(lat128, 99)),
                 "batcher_wall_s": wall128,
                 "max_abs_logit_diff_vs_plain": err128},
        "l512": {"requests": len(lat512),
                 "p50_ms": float(np.percentile(lat512, 50)),
                 "p99_ms": float(np.percentile(lat512, 99)),
                 "batcher_wall_s": wall512,
                 "max_abs_logit_diff_vs_plain": err512},
        "forwards": n_forwards, "forwards_by_bucket_rows": bucket_rows,
        "launches": launches,
        "flash_launches_one_forward": per_forward,
        "flash_selected": sel,
        "masked_request": {"flash_selected": masked_sel,
                           "flash_launches": masked_launches,
                           "finite": bool(np.all(np.isfinite(masked)))},
        "profile": profiles,
    }
    log("bert_serving", json.dumps(out))
    if per_forward != BERT_BASE["n_block"]:
        raise AssertionError(f"one BERT-Base forward launched {per_forward} "
                             f"flash kernels, want {BERT_BASE['n_block']}")
    if (launches["flash_attention"] != BERT_BASE["n_block"] * n_forwards
            or sel["reference"] or sel["cuda"] != launches["flash_attention"]
            or launches["embedding_bag"] or launches["dequant_matmul"]
            or launches["embedding_bag_bwd"]
            or launches["flash_training_kernels"]):
        raise AssertionError(f"BERT serving path: {launches} over "
                             f"{n_forwards} forwards, selections {sel}")
    for name, ans, n in (("l128", ans128, 48), ("l512", ans512, 8)):
        if ans.shape != (n, 2) or not np.all(np.isfinite(ans)):
            raise AssertionError(f"BERT {name}: bad answers {ans.shape}")
    if max(err128, err512) > 1e-3:
        raise AssertionError(f"BERT served through the kernel disagrees "
                             f"with the plain path: {err128}, {err512}")
    if (masked_launches or masked_sel["cuda"] or not out[
            "masked_request"]["finite"]):
        raise AssertionError(f"masked request: {out['masked_request']}")
    return launches


# ---------------------------------------------------------------------------
# training phase


def train_ncf(torch, init, u, i, y, epochs=TRAIN_EPOCHS):
    """NeuralCF at the ML-1M width from ``init``, ``epochs`` epochs of
    shuffled host arrays; returns the model and its history."""
    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.train.optimizers import Adam

    reset_name_scope()
    ncf = NeuralCF(USERS, ITEMS, class_num=5, user_embed=20, item_embed=20,
                   hidden_layers=(40, 20, 10), mf_embed=20, device="cuda")
    load_jax_params(ncf.model, init)
    ncf.compile(optimizer=Adam(lr=1e-3),
                loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    hist = ncf.fit([u, i], y, batch_size=TRAIN_BATCH, epochs=epochs,
                   shuffle=True, verbose=False)
    return ncf, [dict(h) for h in hist]


def max_diff(a, b):
    """Largest |a - b| over two weight trees, and how many elements
    differ by more than 1e-4."""
    d = [np.abs(a[k][j] - b[k][j]) for k in a for j in a[k]]
    return float(max(x.max() for x in d)), int(sum((x > 1e-4).sum()
                                                   for x in d))


def rates(hist, steps):
    """Samples/s (epochs 2 and later: the first holds warm-up) and ms per
    step, from the epochs' host clocks (each epoch ends in its one read
    of the device)."""
    per_s = [h["throughput"] for h in hist[1:]]
    sps = float(np.mean(per_s))
    return {"samples_per_s": sps, "samples_per_s_epochs": per_s,
            "ms_per_step": 1e3 * TRAIN_BATCH / sps, "steps_per_epoch": steps,
            "epoch_loss": [h["loss"] for h in hist]}


def profile_epoch(torch, ncf, u, i, y):
    """One more host-array epoch of the trained model under
    ``torch.profiler``: device time per step (the kernels' self time
    summed) against the epoch's wall time per step, so the device's busy
    share says how far the host's launch work holds the card back.  The
    profiler's own cost is inside the wall time."""
    from torch.profiler import ProfilerActivity, profile

    epochs = ncf.estimator.finished_epochs + 1
    steps0 = ncf.estimator.global_step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ncf.fit([u, i], y, batch_size=TRAIN_BATCH, epochs=epochs,
                verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = ncf.estimator.global_step - steps0

    events = kernel_events(torch, prof)
    busy = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:8]
    out = {"steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
           "device_ms_per_step": busy / steps if events else None,
           "device_busy_share": busy / (1e3 * wall) if events else None,
           "top_device_ms_per_step": {e.key[:60]: device_us(e) / 1e3 / steps
                                      for e in top}}
    log("training_profile", json.dumps(out))
    return out


def training_phase(torch, eb, dq):
    from analytics_zoo_tpu_torch.convert import export_params
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.data import generate_movielens_like
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.ops.dispatch import PATH_REFERENCE, forced

    init_zoo_context()
    users, items, ratings = generate_movielens_like(seed=SEED)
    u = users[:, None].astype(np.int32)
    i = items[:, None].astype(np.int32)
    y = (ratings - 1).astype(np.int32)
    steps = len(y) // TRAIN_BATCH
    reset_name_scope()
    init = export_params(NeuralCF(USERS, ITEMS, device="cuda").model)

    # the main path's window: counts start at 0 here, read after the
    # device-resident epoch
    eb.LAUNCHES.reset()
    eb.BWD_LAUNCHES.reset()
    dq.LAUNCHES.reset()
    ncf, hist = train_ncf(torch, init, u, i, y)
    host_steps = ncf.estimator.global_step
    after_host = (eb.LAUNCHES.value, eb.BWD_LAUNCHES.value, dq.LAUNCHES.value)
    weights = export_params(ncf.model)
    cuda_in = [torch.from_numpy(a).cuda() for a in (u, i, y)]
    t0 = time.perf_counter()
    res_hist = ncf.fit(cuda_in[:2], cuda_in[2], batch_size=TRAIN_BATCH,
                       epochs=TRAIN_EPOCHS + 1, verbose=False)
    torch.cuda.synchronize()
    res_wall = time.perf_counter() - t0
    path = ncf.estimator.last_data_path
    total_steps = ncf.estimator.global_step
    launches = {"embedding_bag_fwd": eb.LAUNCHES.value,
                "embedding_bag_bwd": eb.BWD_LAUNCHES.value,
                "dequant_matmul": dq.LAUNCHES.value}

    ev = ncf.evaluate([u, i], y, batch_size=8192)
    probs = ncf.predict([u[:4096], i[:4096]], batch_size=1024)

    # the same three epochs through the plain versions, on the card, twice:
    # the second run is the yardstick of the plain path's own order noise
    before = (eb.LAUNCHES.value, eb.BWD_LAUNCHES.value, dq.LAUNCHES.value)
    with forced(PATH_REFERENCE):
        ref, ref_hist = train_ncf(torch, init, u, i, y)
        ref2, _ = train_ncf(torch, init, u, i, y)
        plain_step, _ = train_ncf(torch, init, u[:TRAIN_BATCH],
                                  i[:TRAIN_BATCH], y[:TRAIN_BATCH], epochs=1)
    plain_launched = (eb.LAUNCHES.value, eb.BWD_LAUNCHES.value,
                      dq.LAUNCHES.value) != before
    kernel_step, _ = train_ncf(torch, init, u[:TRAIN_BATCH], i[:TRAIN_BATCH],
                               y[:TRAIN_BATCH], epochs=1)
    step_err, _ = max_diff(export_params(kernel_step.model),
                           export_params(plain_step.model))
    loss = [h["loss"] for h in hist]
    ref_loss = [h["loss"] for h in ref_hist]
    ref_weights = export_params(ref.model)
    w_err, w_far = max_diff(weights, ref_weights)
    noise_err, noise_far = max_diff(export_params(ref2.model), ref_weights)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss, ref_loss))
    moved = {k: float(np.abs(weights[k]["table"] - init[k]["table"]).max())
             for k in weights if k.endswith("_embed")}
    out = {
        "data": {"ratings": int(len(y)), "users": USERS, "items": ITEMS,
                 "batch": TRAIN_BATCH, "epochs": TRAIN_EPOCHS},
        "kernels": rates(hist, steps), "plain": rates(ref_hist, steps),
        "resident_epoch": {"loss": res_hist[-1]["loss"],
                           "samples_per_s": res_hist[-1]["throughput"],
                           "wall_s": res_wall, "path": path},
        "loss_max_rel_diff_vs_plain": loss_rel,
        "one_step_weights_max_abs_diff_vs_plain": step_err,
        "weights_max_abs_diff_vs_plain": w_err,
        "weights_beyond_1e-4_vs_plain": w_far,
        "plain_vs_plain_weights_max_abs_diff": noise_err,
        "plain_vs_plain_weights_beyond_1e-4": noise_far,
        "tables_max_abs_move": moved, "evaluate": ev,
        "launches": launches, "steps": total_steps,
        "launches_per_step": {k: v / total_steps
                              for k, v in launches.items()},
    }
    out["profile"] = profile_epoch(torch, ncf, u, i, y)
    log("training", json.dumps(out))
    want = (4 * host_steps, 4 * host_steps, 0)
    if after_host != want or path != "device_resident" or tuple(
            launches.values()) != (4 * total_steps, 4 * total_steps, 0):
        raise AssertionError(
            f"training launches {after_host} after {host_steps} host steps "
            f"(want {want}), {launches} after {total_steps} steps, data "
            f"path {path}")
    if plain_launched:
        raise AssertionError("a kernel launched on the plain path")
    if (probs.shape != (4096, 5) or not np.all(np.isfinite(probs))
            or not np.allclose(probs.sum(-1), 1.0, atol=1e-5)
            or not all(np.isfinite(v) for v in ev.values())):
        raise AssertionError(f"bad evaluate/predict: {ev} {probs.shape}")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"loss did not fall: {loss}")
    if loss_rel > 1e-4 or step_err > 1e-6:
        raise AssertionError(f"kernel training disagrees with the plain "
                             f"path: losses {loss} vs {ref_loss}, one-step "
                             f"weights max |diff| {step_err}")
    if not all(np.all(np.isfinite(w)) for t in weights.values()
               for w in t.values()):
        raise AssertionError("non-finite weights after training")
    if not all(v > 0 for v in moved.values()) or len(moved) != 4:
        raise AssertionError(f"an embedding table did not train: {moved}")
    return launches


# ---------------------------------------------------------------------------
# BERT training phase


def flash_counts(fa):
    return {"flash_attention_fwd": fa.LAUNCHES.value,
            "flash_attention_fwd_lse": fa.LSE_LAUNCHES.value,
            "flash_attention_bwd_dq": fa.BWD_DQ_LAUNCHES.value,
            "flash_attention_bwd_dkv": fa.BWD_DKV_LAUNCHES.value}


def reset_counts(eb, dq, fa):
    for c in (eb.LAUNCHES, eb.BWD_LAUNCHES, dq.LAUNCHES, fa.LAUNCHES,
              fa.LSE_LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES):
        c.reset()


def bert_train_data(n, length, seed):
    """``n`` sequences of ``length`` real tokens; segments 0 then 1 from a
    seeded split, and label 1 when the split falls in the first half (a
    rule the pooled [CLS] output can read from the segment embeddings)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, BERT_BASE["vocab"], (n, length)).astype(np.int32)
    split = rs.randint(1, length, n)
    seg = (np.arange(length)[None, :] >= split[:, None]).astype(np.int32)
    return ids, seg, (split < length // 2).astype(np.int32)


def profile_bert_step(torch, net, xs, y):
    """One more training step under ``torch.profiler``: device time (the
    kernels' self time summed) against the step's wall time, the host's
    kernel launches, and the share of the three training flash
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    epochs = net.estimator.finished_epochs + 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(xs, y, batch_size=len(y), epochs=epochs, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = kernel_events(torch, prof)
    busy = sum(device_us(e) for e in events) / 1e3
    flash = {name: sum(device_us(e) for e in events if name in e.key) / 1e3
             for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    top = sorted(events, key=device_us, reverse=True)[:10]
    launches = sum(e.count for e in prof.key_averages() if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    return {"wall_ms": 1e3 * wall, "device_ms": busy, "launches": launches,
            "device_busy_share": busy / (1e3 * wall) if wall else None,
            "flash_ms": flash,
            "flash_share_of_device": sum(flash.values()) / busy
            if busy else None,
            "top_device_ms": {e.key[:60]: device_us(e) / 1e3 for e in top}}


def bert_training_phase(torch, eb, dq, fa):
    """BERT-Base fine-tuned through ``compile`` / ``fit`` (docstring item
    6): returns the launch counts of its window and of the no-grad
    forwards after it."""
    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.observe.metrics import METRICS
    from analytics_zoo_tpu_torch.ops.dispatch import PATH_REFERENCE, forced
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    from analytics_zoo_tpu_torch.train.optimizers import AdamWeightDecay

    cfg = BERT_TRAIN
    init_zoo_context()
    reset_name_scope()
    t0 = time.perf_counter()
    net = BERTClassifier(num_classes=2, bert_config=dict(
        BERT_BASE, attn_drop=0.0, hidden_drop=0.1),
        generator=torch.Generator().manual_seed(SEED))
    init = export_params(net)
    setup_s = time.perf_counter() - t0
    ids, seg, y = bert_train_data(cfg["rows"], cfg["length"], SEED + 4)
    steps = cfg["rows"] // cfg["batch"]
    total = steps * (cfg["epochs"] + 1)

    def fresh():
        """The initial weights and a new Estimator: a fresh optimizer
        state and dropout generator, seeded as the first run's."""
        load_jax_params(net, init)
        net.compile(AdamWeightDecay(cfg["lr"], warmup_portion=0.1,
                                    total=total),
                    "sparse_categorical_crossentropy_with_logits",
                    device="cuda")

    def one_step_grads():
        """Every leaf's gradient in one step from the initial weights on
        the first batch, read by hooks on the parameters."""
        fresh()
        grads = {}
        hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(
            n, g.detach().clone())) for n, p in net.named_parameters()]
        try:
            hist = net.fit([ids[:cfg["batch"]], seg[:cfg["batch"]]],
                           y[:cfg["batch"]], batch_size=cfg["batch"],
                           epochs=1, verbose=False)
        finally:
            for hk in hooks:
                hk.remove()
        return grads, hist[0]["loss"]

    # the main path's window: counts start at 0 here, read after the
    # device-resident epoch
    fresh()
    reset_counts(eb, dq, fa)
    window = METRICS.snapshot()
    t0 = time.perf_counter()
    # fit returns the Estimator's history list, which later fits extend
    hist = [dict(h) for h in net.fit([ids, seg], y, batch_size=cfg["batch"],
                                     epochs=cfg["epochs"], verbose=False)]
    torch.cuda.synchronize()
    host_wall = time.perf_counter() - t0
    host_steps = net.estimator.global_step
    after_host = flash_counts(fa)
    dev = [torch.from_numpy(a).cuda() for a in (ids, seg, y)]
    t0 = time.perf_counter()
    resident = dict(net.fit(dev[:2], dev[2], batch_size=cfg["batch"],
                            epochs=cfg["epochs"] + 1, verbose=False)[-1])
    torch.cuda.synchronize()
    res_wall = time.perf_counter() - t0
    path = net.estimator.last_data_path
    total_steps = net.estimator.global_step
    launches = flash_counts(fa)
    others = (eb.LAUNCHES.value, eb.BWD_LAUNCHES.value, dq.LAUNCHES.value)
    counters = METRICS.delta(window)["counters"]
    sel = {f"{k}/{p}": counters.get(
        f'ops_kernel_selected_total{{kernel="{k}",path="{p}"}}', 0)
        for k in ("flash_attention", "flash_attention_bwd")
        for p in ("cuda", "reference")}

    # no-grad forwards of the trained model: the forward-only kernel
    n0 = flash_counts(fa)
    ev = net.evaluate([ids, seg], y, batch_size=64)
    logits = net.predict([ids[:64], seg[:64]], batch_size=32)
    eval_launches = {k: v - n0[k] for k, v in flash_counts(fa).items()}
    profile = profile_bert_step(torch, net, [ids[:cfg["batch"]],
                                             seg[:cfg["batch"]]],
                                y[:cfg["batch"]])

    # the same three epochs, and one step, through the plain versions
    before = flash_counts(fa)
    with forced(PATH_REFERENCE):
        fresh()
        ref_hist = [dict(h) for h in net.fit(
            [ids, seg], y, batch_size=cfg["batch"], epochs=cfg["epochs"],
            verbose=False)]
        plain_grads, plain_loss = one_step_grads()
    plain_launched = flash_counts(fa) != before
    kernel_grads, kernel_loss = one_step_grads()
    g_all = max(float(g.abs().max()) for g in plain_grads.values())
    worst = max((float((kernel_grads[n] - g).abs().max())
                 / (float(g.abs().max()) + 1e-2 * g_all), n)
                for n, g in plain_grads.items())
    loss = [h["loss"] for h in hist]
    ref_loss = [h["loss"] for h in ref_hist]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss, ref_loss))
    per_step = {k: v / total_steps for k, v in launches.items()}
    # epochs 2 and 3: the first holds the warm-up (cuBLAS, allocator)
    steady = float(np.mean([h["throughput"] for h in hist[1:]]))
    out = {
        "model": {**BERT_BASE, "attn_drop": 0.0, "hidden_drop": 0.1,
                  "num_classes": 2, "weights": "float32",
                  "params": sum(p.numel() for p in net.parameters())},
        "data": {**cfg, "label": "segment split in the first half"},
        "setup_s": setup_s,
        "epoch_loss": loss, "plain_epoch_loss": ref_loss,
        "loss_max_rel_diff_vs_plain": loss_rel,
        "samples_per_s_epochs": [h["throughput"] for h in hist],
        "samples_per_s": steady, "ms_per_step": 1e3 * cfg["batch"] / steady,
        "host_wall_s": host_wall,
        "resident_epoch": {"loss": resident["loss"],
                           "samples_per_s": resident["throughput"],
                           "wall_s": res_wall, "path": path},
        "one_step": {"loss": kernel_loss, "plain_loss": plain_loss,
                     "grads_compared": len(plain_grads),
                     "max_abs_grad_all_leaves": g_all,
                     "worst_leaf_ratio": worst[0], "worst_leaf": worst[1],
                     "ratio": "max|dg| / (max|g_leaf| + 1e-2 max|g_all|)"},
        "steps": total_steps, "launches": launches,
        "launches_per_step": per_step, "selected": sel,
        "evaluate": ev, "no_grad_forward_launches": eval_launches,
        "profile": profile,
    }
    log("bert_training", json.dumps(out))
    n_block = BERT_BASE["n_block"]
    want = {"flash_attention_fwd": 0}
    want.update({k: n_block * host_steps for k in (
        "flash_attention_fwd_lse", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")})
    if (after_host != want or path != "device_resident"
            or per_step != {k: v / host_steps for k, v in want.items()}
            or any(others)
            or sel != {"flash_attention/cuda": n_block * total_steps,
                       "flash_attention/reference": 0,
                       "flash_attention_bwd/cuda": n_block * total_steps,
                       "flash_attention_bwd/reference": 0}):
        raise AssertionError(
            f"BERT training launches {after_host} after {host_steps} host "
            f"steps (want {want}), {launches} after {total_steps} steps, "
            f"NCF kernels {others}, selections {sel}, data path {path}")
    if (eval_launches["flash_attention_fwd"] == 0
            or sum(eval_launches.values())
            != eval_launches["flash_attention_fwd"]):
        raise AssertionError(f"no-grad forwards launched {eval_launches}")
    if plain_launched:
        raise AssertionError("a kernel launched on the plain path")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"BERT loss did not fall: {loss}")
    if loss_rel > 1e-3 or worst[0] > 1e-4 or len(plain_grads) != len(
            kernel_grads):
        raise AssertionError(
            f"BERT training through the kernels disagrees with the plain "
            f"path: losses {loss} vs {ref_loss}, worst gradient {worst}")
    if (logits.shape != (64, 2) or not np.all(np.isfinite(logits))
            or not all(np.isfinite(v) for v in ev.values())):
        raise AssertionError(f"bad evaluate/predict: {ev} {logits.shape}")
    return launches, eval_launches, out


# ---------------------------------------------------------------------------
# fault-tolerant bf16 fine-tuning phase


def flash_dtype_spy(fa):
    """Wrap the flash launchers so each launch records q's dtype under its
    kernel's name; returns the record and a function that unwraps them."""
    seen = {k: [] for k in ("flash_attention_fwd", "flash_attention_fwd_lse",
                            "flash_attention_bwd_dq",
                            "flash_attention_bwd_dkv")}
    launch, dq_fn, dkv_fn = fa._launch, fa.launch_bwd_dq, fa.launch_bwd_dkv

    def spy_launch(q, *a, with_lse=False, **kw):
        seen["flash_attention_fwd_lse" if with_lse
             else "flash_attention_fwd"].append(str(q.dtype))
        return launch(q, *a, with_lse=with_lse, **kw)

    def spy(name, fn):
        def run(q, *a):
            seen[name].append(str(q.dtype))
            return fn(q, *a)
        return run

    fa._launch = spy_launch
    fa.launch_bwd_dq = spy("flash_attention_bwd_dq", dq_fn)
    fa.launch_bwd_dkv = spy("flash_attention_bwd_dkv", dkv_fn)

    def undo():
        fa._launch, fa.launch_bwd_dq, fa.launch_bwd_dkv = (launch, dq_fn,
                                                           dkv_fn)
    return seen, undo


def tree_leaves(tree, path=""):
    """``(key path, array)`` for every leaf of a nested weight tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, np.asarray(tree)


def tree_diff(a, b):
    """(largest |a - b| over two weight trees, bit-equal?)"""
    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    assert all(x[0] == y[0] for x, y in pairs)
    return (max(float(np.abs(x[1].astype(np.float64) - y[1]).max())
                for x, y in pairs),
            all(np.array_equal(x[1], y[1]) for x, y in pairs))


def l2(a, b):
    """||a - b|| over two weight trees, in f64."""
    return float(np.sqrt(sum(
        np.sum((x[1].astype(np.float64) - y[1]) ** 2)
        for x, y in zip(tree_leaves(a), tree_leaves(b)))))


def restored_matches_live(tree, live):
    """The names of the restored values that differ from the live state at
    the flush, bit for bit (an empty list when all agree)."""
    import pickle

    got = dict(tree_leaves(tree["params"]))
    bad = [f"params/{k}" for k, v in tree_leaves(live["params"])
           if k not in got or not np.array_equal(got[k], v)]
    bad += [f"opt_state/{n}" for n, (a, b) in enumerate(
        zip(tree["opt_state"], live["opt_state"]))
        if not np.array_equal(a, b.numpy())]
    if len(tree["opt_state"]) != len(live["opt_state"]):
        bad.append("opt_state length")
    meta = tree["meta"]
    if not np.array_equal(meta["torch_rng"], live["torch_rng"].numpy()):
        bad.append("meta/torch_rng")
    for key in ("global_step", "finished_epochs"):
        if int(meta[key]) != live[key]:
            bad.append(f"meta/{key}")
    host = pickle.loads(np.asarray(meta["host_rng"]).tobytes())
    want = live["host_rng"]
    if not (host[0] == want[0] and np.array_equal(host[1], want[1])
            and tuple(host[2:]) == tuple(want[2:])):
        bad.append("meta/host_rng")
    return bad


def ft_bert(torch, eb, dq, fa, root, f32):
    """BERT-Base fine-tuned in bf16 with checkpoints, a real SIGTERM and a
    resume (docstring item 7); returns the record and the launches of its
    window."""
    import os
    import shutil

    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.observe.metrics import METRICS
    from analytics_zoo_tpu_torch.ops.dispatch import PATH_REFERENCE, forced
    from analytics_zoo_tpu_torch.robust import (FaultInjector,
                                                TrainingPreempted)
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier
    from analytics_zoo_tpu_torch.train.checkpoint import CheckpointManager
    from analytics_zoo_tpu_torch.train.optimizers import AdamWeightDecay

    cfg, batch = BERT_TRAIN, BERT_TRAIN["batch"]
    epochs = cfg["epochs"]
    init_zoo_context(async_checkpoint=True)
    bert_cfg = dict(BERT_BASE, attn_drop=0.0, hidden_drop=0.1)
    reset_name_scope()
    net = BERTClassifier(num_classes=2, bert_config=bert_cfg,
                         generator=torch.Generator().manual_seed(SEED))
    init = export_params(net)
    ids, seg, y = bert_train_data(cfg["rows"], cfg["length"], SEED + 4)
    xs = [ids, seg]
    steps = cfg["rows"] // batch
    loss = "sparse_categorical_crossentropy_with_logits"

    def fresh(ckpt=None):
        """The initial weights and a new Estimator in bf16 compute: a fresh
        optimizer state and dropout generator, seeded as every run's."""
        load_jax_params(net, init)
        net.compile(AdamWeightDecay(cfg["lr"], warmup_portion=0.1,
                                    total=steps * epochs), loss,
                    device="cuda", compute_dtype="bfloat16")
        if ckpt is not None:
            net.estimator.set_checkpoint(os.path.join(root, ckpt), keep=1)
        return net.estimator

    # run U, the main path's window: counts start at 0 here
    est = fresh("u")
    reset_counts(eb, dq, fa)
    window = METRICS.snapshot()
    seen, undo = flash_dtype_spy(fa)
    try:
        t0 = time.perf_counter()
        u_hist = [dict(h) for h in net.fit(xs, y, batch_size=batch,
                                           epochs=epochs, verbose=False)]
        torch.cuda.synchronize()
        u_wall = time.perf_counter() - t0
    finally:
        undo()
    launches = flash_counts(fa)
    others = (eb.LAUNCHES.value, eb.BWD_LAUNCHES.value, dq.LAUNCHES.value)
    # the spy sees the launchers' Python calls: the step program's eager
    # warm-up step and its capture; the replays launch without Python
    u_programs = programs_of(est._programs)
    python_steps = len(est._programs) + len(u_programs)
    counters = METRICS.delta(window)["counters"]
    sel = {f"{k}/{p}": counters.get(
        f'ops_kernel_selected_total{{kernel="{k}",path="{p}"}}', 0)
        for k in ("flash_attention", "flash_attention_bwd")
        for p in ("cuda", "reference")}
    u_steps = est.global_step
    u_loss = [h["loss"] for h in u_hist]
    u_weights = export_params(net)
    snapshot_bytes = os.path.getsize(os.path.join(
        root, "u", f"ckpt_{u_steps:010d}.npz"))
    shutil.rmtree(os.path.join(root, "u"))

    # checkpoint costs, on a run without a checkpoint trigger
    cost = fresh()
    net.fit(xs, y, batch_size=batch, epochs=1, verbose=False)
    mgr = CheckpointManager(os.path.join(root, "cost"), keep=1)
    t0 = time.perf_counter()
    mgr.save(cost.global_step, cost._snapshot())
    sync_s = time.perf_counter() - t0

    def epoch_ms_per_step():
        t0 = time.perf_counter()
        net.fit(xs, y, batch_size=batch, epochs=cost.finished_epochs + 1,
                verbose=False)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / steps

    # bf16 against phase 6's f32: an epoch with no write in flight, and
    # one step under the profiler for the device's share
    quiet = epoch_ms_per_step()
    profile = profile_bert_step(torch, net, [ids[:batch], seg[:batch]],
                                y[:batch])
    t0 = time.perf_counter()
    mgr.save_async(cost.global_step, cost._snapshot())
    async_return_s = time.perf_counter() - t0
    in_flight = epoch_ms_per_step()
    t1 = time.perf_counter()
    mgr.wait()
    wait_after_s = time.perf_counter() - t1
    async_total_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.restore()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(os.path.join(root, "cost"))

    # run P: a real SIGTERM at epoch 2's fourth step, sent from the
    # estimator.preempt fault site, then a fresh Estimator resumes
    est = fresh("p")
    preempt_at = steps + 3
    preempted = None
    with FaultInjector().plan("estimator.preempt", at=preempt_at,
                              action="sigterm"):
        try:
            net.fit(xs, y, batch_size=batch, epochs=epochs, verbose=False)
        except TrainingPreempted as e:
            preempted = e.step
    first = [h["loss"] for h in est.history]
    live = {"params": export_params(net),
            "opt_state": [t.cpu() for t in est.opt_state],
            "torch_rng": est._dropout_gen.get_state(),
            "host_rng": est._host_rng.get_state(),
            "global_step": est.global_step,
            "finished_epochs": est.finished_epochs}
    _, tree = CheckpointManager(os.path.join(root, "p")).restore()
    flush_bytes = os.path.getsize(os.path.join(
        root, "p", f"ckpt_{preempt_at:010d}.npz"))
    restore_bad = restored_matches_live(tree, live)
    del tree, live
    est = fresh("p")
    t0 = time.perf_counter()
    net.fit(xs, y, batch_size=batch, epochs=epochs, verbose=False,
            resume=True)
    torch.cuda.synchronize()
    resume_wall = time.perf_counter() - t0
    p_loss = first + [h["loss"] for h in est.history]
    p_weights = export_params(net)
    p_w_diff, p_bit_equal = tree_diff(p_weights, u_weights)
    p_loss_rel = max(abs(a - b) / abs(b) for a, b in zip(p_loss, u_loss))
    p_w_rel = l2(p_weights, u_weights) / l2(u_weights, init)
    resumed = (est.finished_epochs, est.global_step)
    shutil.rmtree(os.path.join(root, "p"))

    # save_weights -> load_weights of the fine-tuned net into another one
    fwd0 = fa.LAUNCHES.value
    want = net.predict([ids[:64], seg[:64]], batch_size=32)
    path = os.path.join(root, "weights.npz")
    net.save_weights(path)
    weights_bytes = os.path.getsize(path)
    reset_name_scope()
    other = BERTClassifier(num_classes=2, bert_config=bert_cfg,
                           generator=torch.Generator().manual_seed(SEED + 1))
    other.load_weights(path)
    other.compile("sgd", loss, device="cuda", compute_dtype="bfloat16")
    got = other.predict([ids[:64], seg[:64]], batch_size=32)
    weights_equal = bool(np.array_equal(got, want))
    predict_launches = fa.LAUNCHES.value - fwd0
    del other

    # run R: U's epochs through the plain versions
    before = flash_counts(fa)
    with forced(PATH_REFERENCE):
        fresh()
        r_loss = [h["loss"] for h in net.fit(xs, y, batch_size=batch,
                                             epochs=epochs, verbose=False)]
    plain_launched = flash_counts(fa) != before
    r_loss_rel = max(abs(a - b) / abs(b) for a, b in zip(u_loss, r_loss))

    n_block = BERT_BASE["n_block"]
    want_counts = {"flash_attention_fwd": 0}
    want_counts.update({k: n_block * u_steps for k in (
        "flash_attention_fwd_lse", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")})
    dtypes = {k: sorted(set(v)) for k, v in seen.items()}
    out = {
        "model": {**bert_cfg, "num_classes": 2, "compute_dtype": "bfloat16",
                  "params": sum(p.numel() for p in net.parameters())},
        "data": cfg, "steps": u_steps,
        "epoch_loss_U": u_loss, "epoch_loss_P": p_loss,
        "epoch_loss_plain": r_loss,
        "loss_max_rel_diff_P_vs_U": p_loss_rel,
        "weights_max_abs_diff_P_vs_U": p_w_diff,
        "weights_rel_l2_P_vs_U": p_w_rel,
        "tolerance": {"P_loss_rtol": P_LOSS_RTOL,
                      "P_weights_rel_l2": P_WEIGHTS_REL,
                      "plain_loss_rtol": BF16_PLAIN_LOSS_RTOL},
        "P_bit_equal_to_U": p_bit_equal and p_loss == u_loss,
        "loss_max_rel_diff_U_vs_plain": r_loss_rel,
        "preempted_at_step": preempted,
        "restored_differs_from_live": restore_bad,
        "flush_bytes": flush_bytes,
        "resumed_to": resumed, "resume_wall_s": resume_wall,
        "launches": launches, "launch_dtypes": dtypes, "selected": sel,
        "U_programs": u_programs,
        "bf16": {"ms_per_step": quiet, "samples_per_s": 1e3 * batch / quiet,
                 "profiled_step": profile,
                 "U_samples_per_s_epochs": [h["throughput"]
                                            for h in u_hist],
                 "U_wall_s": u_wall},
        "f32_phase6": {"samples_per_s": f32["samples_per_s"],
                       "ms_per_step": f32["ms_per_step"],
                       "profiled_step": f32["profile"]},
        "bf16_speedup": f32["ms_per_step"] / quiet,
        "checkpoint": {"snapshot_bytes": snapshot_bytes,
                       "sync_save_s": sync_s,
                       "async_save_return_s": async_return_s,
                       "async_save_total_s": async_total_s,
                       "ms_per_step_quiet": quiet,
                       "ms_per_step_async_in_flight": in_flight,
                       "wait_after_the_epoch_s": wait_after_s,
                       "restore_s": restore_s},
        "save_load_weights": {"bytes": weights_bytes,
                              "predict_bit_equal": weights_equal,
                              "flash_fwd_launches": predict_launches},
    }
    log("fault_tolerant_bert", json.dumps(out))
    if (launches != want_counts or any(others)
            or sel != {"flash_attention/cuda": n_block * u_steps,
                       "flash_attention/reference": 0,
                       "flash_attention_bwd/cuda": n_block * u_steps,
                       "flash_attention_bwd/reference": 0}
            or any(v and v != ["torch.bfloat16"] for v in dtypes.values())
            or len(seen["flash_attention_fwd_lse"]) != n_block * python_steps):
        raise AssertionError(
            f"bf16 fine-tuning launched {launches} (want {want_counts}) on "
            f"{dtypes}, NCF kernels {others}, selections {sel}")
    if not u_loss[-1] < u_loss[0]:
        raise AssertionError(f"bf16 BERT loss did not fall: {u_loss}")
    if [v["replays"] for v in u_programs.values()] != [u_steps - 1]:
        raise AssertionError(f"run U did not replay one step graph: "
                             f"{u_programs}")
    if preempted != preempt_at or restore_bad:
        raise AssertionError(f"preemption at {preempted} (want "
                             f"{preempt_at}); restored values that differ "
                             f"from the live state: {restore_bad}")
    if (resumed != (epochs, u_steps) or p_loss_rel > P_LOSS_RTOL
            or p_w_rel > P_WEIGHTS_REL):
        raise AssertionError(
            f"the resumed run left the uninterrupted one: epochs/steps "
            f"{resumed}, losses {p_loss} vs {u_loss}, weights {p_w_diff}")
    if plain_launched or r_loss_rel > BF16_PLAIN_LOSS_RTOL:
        raise AssertionError(f"bf16 fine-tuning disagrees with the plain "
                             f"path: {u_loss} vs {r_loss}")
    if not weights_equal or predict_launches != 2 * 2 * n_block:
        raise AssertionError(f"load_weights did not reproduce predict, or "
                             f"the forwards launched {predict_launches} "
                             f"flash kernels")
    return out, dict(launches, flash_attention_fwd=predict_launches)


def ft_ncf(torch, eb, root):
    """NeuralCF at the ML-1M width: a NaN rollback, gradient accumulation
    and save_model / load_model (docstring item 7); returns the record and
    the bag kernels' launches of its window."""
    import os

    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.core.profiling import TIMERS
    from analytics_zoo_tpu_torch.data import generate_movielens_like
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.models.common import ZooModel
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.robust import FaultInjector
    from analytics_zoo_tpu_torch.train.optimizers import SGD, Adam

    max_bad = 3
    init_zoo_context(nan_policy="rollback", max_bad_steps=max_bad,
                     async_checkpoint=True)
    users, items, ratings = generate_movielens_like(seed=SEED)
    u = users[:, None].astype(np.int32)
    i = items[:, None].astype(np.int32)
    y = (ratings - 1).astype(np.int32)
    steps = len(y) // TRAIN_BATCH

    def model(opt, **kw):
        reset_name_scope()
        ncf = NeuralCF(USERS, ITEMS, device="cuda")
        load_jax_params(ncf.model, init)
        ncf.compile(opt, "sparse_categorical_crossentropy", **kw)
        return ncf

    reset_name_scope()
    init = export_params(NeuralCF(USERS, ITEMS, device="cuda").model)
    eb.LAUNCHES.reset()
    eb.BWD_LAUNCHES.reset()

    # max_bad NaN batches in a row in epoch 2, after epoch 1's checkpoint
    ncf = model(Adam(lr=1e-3))
    ncf.estimator.set_checkpoint(os.path.join(root, "ncf"), keep=1)
    n0 = TIMERS.count("robust/nan_rollbacks")
    bad = [steps + 5 + k for k in range(max_bad)]
    with FaultInjector().plan("estimator.step", at=bad, action="nan"):
        hist = [dict(h) for h in ncf.fit([u, i], y, batch_size=TRAIN_BATCH,
                                         epochs=3, verbose=False)]
    rollbacks = TIMERS.count("robust/nan_rollbacks") - n0
    lr_scale = ncf.estimator._lr_scale
    rollback_programs = programs_of(ncf.estimator._programs)
    losses = [h["loss"] for h in hist]
    trained = 4 * steps                 # epoch 2 ran twice

    # grad_accum_steps=2 at half the batch against the full batch, one
    # epoch on the same shuffle, SGD (Adam would turn last-bit gradient
    # differences into lr-sized steps on gradients near 0)
    half = model(SGD(lr=ACCUM_LR), grad_accum_steps=2)
    half.fit([u, i], y, batch_size=TRAIN_BATCH // 2, epochs=1, verbose=False)
    full = model(SGD(lr=ACCUM_LR))
    full.fit([u, i], y, batch_size=TRAIN_BATCH, epochs=1, verbose=False)
    accum_diff, _ = tree_diff(export_params(half.model),
                              export_params(full.model))
    moved, _ = tree_diff(export_params(full.model), init)
    updates = int(half.estimator.opt_state[1])
    trained += len(y) // (TRAIN_BATCH // 2) + steps

    # save_model -> load_model -> InferenceModel, bit-equal
    path = os.path.join(root, "ncf_model")
    ncf.save_model(path)
    back = ZooModel.load_model(path, device="cuda")
    probe = [u[:4096], i[:4096]]
    a = InferenceModel.from_keras_net(ncf.model, device="cuda").predict(probe)
    b = InferenceModel.from_keras_net(back.model, device="cuda").predict(
        probe)
    launches = {"embedding_bag_fwd": eb.LAUNCHES.value,
                "embedding_bag_bwd": eb.BWD_LAUNCHES.value}
    out = {"rollback": {"nan_steps_at": bad, "max_bad_steps": max_bad,
                        "rollbacks": rollbacks, "lr_scale": lr_scale,
                        "epoch_loss": losses,
                        "finished_epochs": ncf.estimator.finished_epochs,
                        "programs": rollback_programs},
           "grad_accum": {"batch": TRAIN_BATCH // 2, "accum_steps": 2,
                          "lr": ACCUM_LR, "updates": updates,
                          "full_batch_steps": steps,
                          "weights_max_abs_diff": accum_diff,
                          "weights_max_abs_moved": moved,
                          "atol": ACCUM_ATOL},
           "save_load_model_bit_equal": bool(np.array_equal(a, b)),
           "training_steps": trained, "launches": launches}
    log("fault_tolerant_ncf", json.dumps(out))
    # one step program, its first step eager, the rest (the NaN steps and
    # the rolled-back epoch's rerun included) replays
    if (rollbacks != 1 or lr_scale != 0.5 or len(losses) != 3
            or not all(np.isfinite(losses)) or not losses[-1] < losses[0]
            or [v["replays"] for v in rollback_programs.values()]
            != [4 * steps - 1]):
        raise AssertionError(f"NCF rollback: {out['rollback']}")
    if (updates != steps or accum_diff > ACCUM_ATOL
            or moved < 10 * ACCUM_ATOL):
        raise AssertionError(f"NCF gradient accumulation: "
                             f"{out['grad_accum']}")
    if not out["save_load_model_bit_equal"]:
        raise AssertionError("the loaded NCF model answers differently")
    if launches["embedding_bag_bwd"] != 4 * trained:
        raise AssertionError(f"NCF legs launched {launches} over {trained} "
                             f"training steps (want 4 bag backwards each)")
    return out, launches


def fault_tolerant_phase(torch, eb, dq, fa, f32, card):
    """Docstring item 7, in a temporary directory removed at the end;
    fails, naming the bytes, where the disk is short."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="zoo_ckpt_")
    try:
        params = 109_483_778
        need = 2 * 3 * 4 * params + (1 << 30)
        free = shutil.disk_usage(root).free
        log("fault_tolerant disk", json.dumps({
            "dir": root, "free_bytes": free, "needed_bytes": need}))
        if free < need:
            raise AssertionError(
                f"the fault-tolerant phase needs {need} bytes free under "
                f"{root} (two snapshots of params, m and v in f32 and 1 GiB "
                f"to spare), and {free} are")
        bert, bert_launches = ft_bert(torch, eb, dq, fa, root, f32)
        ncf, ncf_launches = ft_ncf(torch, eb, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("fault_tolerant card", card, json.dumps({
        "bf16_ms_per_step": bert["bf16"]["ms_per_step"],
        "f32_ms_per_step": bert["f32_phase6"]["ms_per_step"],
        **bert["checkpoint"]}))
    return bert_launches, ncf_launches


# ---------------------------------------------------------------------------
# graphed dispatch phase


def programs_of(programs):
    """What each captured program of an Estimator or InferenceModel did:
    capture seconds, replays, kernel launches per replay."""
    return {str(key if isinstance(key, str) else key[:2]): {
        "steps": None if isinstance(key, str) else key[1],
        "capture_s": p.graph.capture_s, "replays": p.graph.replays,
        "launches_per_replay": p.graph.record.per_replay()}
        for key, p in programs.items() if p.graph.captured}


def graph_launches(prof):
    """Graph launches and kernel launches the host made under ``prof``."""
    keys = {"graph": ("cudaGraphLaunch",),
            "kernel": ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernelEx", "cuLaunchKernel")}
    return {k: sum(e.count for e in prof.key_averages() if e.key in v)
            for k, v in keys.items()}


def ncf_leg(torch, init, data, k, graphed, epochs=2):
    """NeuralCF at the ML-1M width from ``init`` (phase 4's data and
    optimizer), ``epochs`` epochs at ``steps_per_execution = k``, graphed
    or with graphs off; returns the net and its history."""
    import contextlib

    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.train.optimizers import Adam

    init_zoo_context(steps_per_execution=k)
    reset_name_scope()
    ncf = NeuralCF(USERS, ITEMS, class_num=5, user_embed=20, item_embed=20,
                   hidden_layers=(40, 20, 10), mf_embed=20, device="cuda")
    load_jax_params(ncf.model, init)
    ncf.compile(optimizer=Adam(lr=1e-3),
                loss="sparse_categorical_crossentropy")
    with contextlib.nullcontext() if graphed else graphs.disabled():
        hist = ncf.fit(data[0], data[1], batch_size=TRAIN_BATCH,
                       epochs=epochs, verbose=False)
    torch.cuda.synchronize()
    init_zoo_context()
    return ncf, [dict(h) for h in hist]


def profile_ncf_epoch(torch, ncf, data, graphed):
    """One more epoch under ``torch.profiler``: device and wall ms per
    step, the busy share, and the host's graph and kernel launches."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.core import graphs

    est = ncf.estimator
    steps0 = est.global_step
    torch.cuda.synchronize()
    with contextlib.nullcontext() if graphed else graphs.disabled():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ncf.fit(data[0], data[1], batch_size=TRAIN_BATCH,
                    epochs=est.finished_epochs + 1, verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    steps = est.global_step - steps0
    busy = sum(device_us(e) for e in kernel_events(torch, prof)) / 1e3
    return {"wall_ms_per_step": 1e3 * wall / steps,
            "device_ms_per_step": busy / steps,
            "device_busy_share": busy / (1e3 * wall),
            "host_launches_per_step": {
                k: v / steps for k, v in graph_launches(prof).items()}}


def graphed_ncf_training(torch, eb):
    """NCF training eager against graphed: host and resident paths, K = 1
    and 8, two epochs each from the same weights."""
    from analytics_zoo_tpu_torch.convert import export_params
    from analytics_zoo_tpu_torch.data import generate_movielens_like
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    users, items, ratings = generate_movielens_like(seed=SEED)
    u = users[:, None].astype(np.int32)
    i = items[:, None].astype(np.int32)
    y = (ratings - 1).astype(np.int32)
    steps = len(y) // TRAIN_BATCH
    reset_name_scope()
    init = export_params(NeuralCF(USERS, ITEMS, device="cuda").model)
    host = ([u, i], y)
    dev = ([torch.from_numpy(u).cuda(), torch.from_numpy(i).cuda()],
           torch.from_numpy(y).cuda())
    legs, worst = {}, 0.0
    for path, data in (("host", host), ("resident", dev)):
        for k in (1, 8):
            leg = {}
            for mode in ("eager", "graphed"):
                b0 = eb.BWD_LAUNCHES.value
                ncf, hist = ncf_leg(torch, init, data, k, mode == "graphed")
                est = ncf.estimator
                leg[mode] = {
                    **rates(hist, steps),
                    "bag_bwd_launches": eb.BWD_LAUNCHES.value - b0,
                    "steps": est.global_step,
                    "programs": programs_of(est._programs),
                    "weights": export_params(ncf.model)}
                if path == "host" and k == 1 or mode == "graphed":
                    leg[mode]["profile"] = profile_ncf_epoch(
                        torch, ncf, data, mode == "graphed")
            a, b = leg["graphed"], leg["eager"]
            leg["loss_max_rel_diff"] = max(
                abs(x - z) / abs(z)
                for x, z in zip(a["epoch_loss"], b["epoch_loss"]))
            wa, wb = a.pop("weights"), b.pop("weights")
            leg["weights_max_rel_diff"] = max(
                float(np.abs(wa[m][n] - wb[m][n]).max()
                      / np.abs(wb[m][n]).max()) for m in wb for n in wb[m])
            leg["speedup"] = b["ms_per_step"] / a["ms_per_step"]
            worst = max(worst, leg["loss_max_rel_diff"])
            legs[f"{path}_k{k}"] = leg
            log("graphed_ncf", f"{path} K={k}", json.dumps(leg))
            n_steps = 2 * steps
            for mode in ("eager", "graphed"):
                if leg[mode]["bag_bwd_launches"] != 4 * n_steps:
                    raise AssertionError(
                        f"NCF {path} K={k} {mode}: {leg[mode]} bag "
                        f"backwards over {n_steps} steps")
            progs = a["programs"]
            if (not progs or any(v["launches_per_replay"] != {
                    "embedding_bag": 4 * v["steps"],
                    "embedding_bag_bwd": 4 * v["steps"]}
                    for v in progs.values()) or b["programs"]):
                raise AssertionError(f"NCF {path} K={k}: graphed programs "
                                     f"{progs}, eager {b['programs']}")
    if worst > 1e-4:
        raise AssertionError(f"graphed NCF training left the eager one: "
                             f"losses {worst}")
    return legs


def bert_leg(torch, net, init, xs, y, compute_dtype, graphed, steps):
    """BERT-Base at phase 6/7's configuration, two epochs from ``init``
    graphed or with graphs off: ms per step of epoch 2, the losses, the
    weights after them, the card's memory (the peak over the two epochs
    and what stays reserved after them, in GiB), the step programs and
    one profiled step."""
    import contextlib

    from analytics_zoo_tpu_torch.convert import export_params, load_jax_params
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.train.optimizers import AdamWeightDecay

    def held_gib():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved() / 2 ** 30

    cfg = BERT_TRAIN
    load_jax_params(net, init)
    net.compile(AdamWeightDecay(cfg["lr"], warmup_portion=0.1,
                                total=steps * 3),
                "sparse_categorical_crossentropy_with_logits",
                device="cuda", compute_dtype=compute_dtype)
    before = held_gib()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.nullcontext() if graphed else graphs.disabled():
        hist = [dict(h) for h in net.fit(xs, y, batch_size=cfg["batch"],
                                         epochs=2, verbose=False)]
        memory = {"reserved_before_fit": before,
                  "peak_allocated": torch.cuda.max_memory_allocated()
                  / 2 ** 30,
                  "peak_reserved": torch.cuda.max_memory_reserved() / 2 ** 30,
                  "reserved_after_fit": held_gib()}
        weights = export_params(net)
        b = cfg["batch"]
        profile = profile_bert_step(torch, net, [x[:b] for x in xs], y[:b])
    est = net.estimator
    out = {"ms_per_step": 1e3 * b / hist[1]["throughput"],
           "samples_per_s": hist[1]["throughput"],
           "epoch_loss": [h["loss"] for h in hist], "weights": weights,
           "memory_gib": memory,
           "programs": programs_of(est._programs), "profiled_step": profile}
    if graphed and compute_dtype == "bfloat16":
        # one device-resident epoch: a program of its own, graphed too
        dev = [torch.from_numpy(a).cuda() for a in (*xs, y)]
        t0 = time.perf_counter()
        net.fit(dev[:-1], dev[-1], batch_size=b,
                epochs=est.finished_epochs + 1, verbose=False)
        torch.cuda.synchronize()
        out["resident_epoch"] = {
            "ms_per_step": 1e3 * (time.perf_counter() - t0) / steps,
            "reserved_after_gib": held_gib(),
            "path": est.last_data_path,
            "programs": programs_of({k: p for k, p in est._programs.items()
                                     if k[0] == "resident"})}
    return out


def graphed_bert_training(torch, fa):
    """BERT-Base fine-tuning eager against graphed, in bf16 and f32."""
    import gc

    from analytics_zoo_tpu_torch.convert import export_params
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    init_zoo_context()
    cfg = BERT_TRAIN
    reset_name_scope()
    net = BERTClassifier(num_classes=2, bert_config=dict(
        BERT_BASE, attn_drop=0.0, hidden_drop=0.1),
        generator=torch.Generator().manual_seed(SEED))
    init = export_params(net)
    ids, seg, y = bert_train_data(cfg["rows"], cfg["length"], SEED + 4)
    steps = cfg["rows"] // cfg["batch"]
    out = {}
    for cd in ("bfloat16", "float32"):
        leg = {}
        for mode in ("eager", "graphed"):
            n0 = fa.BWD_DKV_LAUNCHES.value
            leg[mode] = bert_leg(torch, net, init, [ids, seg], y, cd,
                                 mode == "graphed", steps)
            leg[mode]["bwd_dkv_launches"] = fa.BWD_DKV_LAUNCHES.value - n0
            gc.collect()
            torch.cuda.empty_cache()
        a, b = leg["graphed"], leg["eager"]
        leg["loss_max_rel_diff"] = max(
            abs(x - z) / abs(z)
            for x, z in zip(a["epoch_loss"], b["epoch_loss"]))
        leg["weights_max_abs_diff"], leg["weights_bit_equal"] = tree_diff(
            a.pop("weights"), b.pop("weights"))
        leg["speedup"] = b["ms_per_step"] / a["ms_per_step"]
        out[cd] = leg
        log("graphed_bert", cd, json.dumps(leg))
        n_block = BERT_BASE["n_block"]
        per_replay = {"flash_attention_lse": n_block,
                      "flash_attention_bwd_dq": n_block,
                      "flash_attention_bwd_dkv": n_block}
        progs = a["programs"]
        res = a.get("resident_epoch", {}).get("programs", {})
        resident_steps = steps if cd == "bfloat16" else 0
        if (len(progs) != 1 or any(v["launches_per_replay"] != per_replay
                                   for v in progs.values())
                or b["programs"]
                or a["bwd_dkv_launches"]
                != n_block * (2 * steps + 1 + resident_steps)
                or b["bwd_dkv_launches"] != n_block * (2 * steps + 1)
                or a["epoch_loss"] != b["epoch_loss"]
                or not leg["weights_bit_equal"]
                or (cd == "bfloat16" and (
                    a["resident_epoch"]["path"] != "device_resident"
                    or [(v["replays"], v["launches_per_replay"])
                        for v in res.values()]
                    != [(steps - 1, per_replay)]))):
            raise AssertionError(f"graphed BERT {cd}: {leg}")
    return out


def serve_rows(batcher, reqs, n_threads):
    """Requests through the batcher from ``n_threads`` threads; answers
    and latencies (ms)."""
    return serve_requests(batcher, reqs, n_threads)


def graphed_serving(torch, fa, root):
    """BERT-Base and int8 NCF served from bucket graphs through
    ``DynamicBatcher``: the cold process fills a CompileCache, a second
    process warms from it and serves with zero live captures; BERT at
    8-row batches eager against graphed."""
    import contextlib
    import os

    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.deploy import CompileCache, DynamicBatcher

    out = {}
    cache_dir = os.path.join(root, "compile_cache")
    models = serving_models(torch)
    reqs = serving_requests()
    cold, cold_answers = {}, {}
    for name, im in models.items():
        im.attach_compile_cache(CompileCache(cache_dir), name=name)
        t0 = time.perf_counter()
        for xs in reqs[name]["cover"]:
            for _ in range(2):          # eager, then captured
                cover = im.predict(xs)
            cold_answers.setdefault(f"{name}_cover", []).append(cover)
        torch.cuda.synchronize()
        cold[name] = {"cover_s": time.perf_counter() - t0,
                      "compile_count": im.compile_count,
                      "programs": programs_of(im._programs)}
        batcher = DynamicBatcher(im, max_batch=8,
                                 max_latency_ms=FILL_DEADLINE_MS)
        cold_answers[f"{name}_served"], _ = serve_rows(
            batcher, reqs[name]["single"], 8)
        batcher.close()
    # BERT at the batcher's 8-row batches: eager, graphed, graphed, eager
    im = models["bert"]
    lat = {}
    answers = {}
    for mode in ("eager", "graphed", "graphed2", "eager2"):
        ctx = (graphs.disabled() if mode.startswith("eager")
               else contextlib.nullcontext())
        with ctx:
            batcher = DynamicBatcher(im, max_batch=8, max_latency_ms=2.0)
            t0 = time.perf_counter()
            ans, ms = serve_rows(batcher, reqs["bert"]["single"], 8)
            wall = time.perf_counter() - t0
            batcher.close()
            prof = profile_forward(torch, im, reqs["bert"]["batch8"])
        answers[mode] = ans
        lat[mode] = {"p50_ms": float(np.percentile(ms, 50)),
                     "p99_ms": float(np.percentile(ms, 99)),
                     "requests": len(ms), "wall_s": wall,
                     "requests_per_s": len(ms) / wall,
                     "forward_8_rows": {k: prof[k] for k in (
                         "wall_ms", "device_ms", "device_busy_share")}}
    diff = float(np.abs(answers["graphed"] - answers["eager"]).max())
    out["bert_8_row_batches"] = {**lat, "max_abs_diff_graphed_vs_eager":
                                 diff}
    out["cold"] = cold
    log("graphed_serving", json.dumps(out))
    # a real restart: another process warms from the cache and serves
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--serve-warm", cache_dir], capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"the warm serving process failed: "
                             f"{res.stderr[-3000:]}")
    warm = json.loads(res.stdout.strip().splitlines()[-1])
    # the restarted process's answers against this one's, element by
    # element: the cover batches bucket for bucket, the batcher's
    # answers request for request (within 1e-6 of the largest answer)
    with np.load(cache_dir + ".answers.npz") as f:
        got = dict(f)
    for name in models:
        for part in ("cover", "served"):
            want = cold_answers[f"{name}_{part}"]
            want = np.concatenate(want) if part == "cover" else want
            warm[name][f"{part}_max_abs_diff"] = float(np.abs(
                got[f"{name}_{part}"] - want).max())
            warm[name][f"{part}_largest"] = float(np.abs(want).max())
    out["warm_process"] = warm
    log("graphed_serving_warm", json.dumps(warm))
    for name in models:
        w = warm[name]
        if (w["compile_count"] != 0
                or w["warmed"] != cold[name]["compile_count"]
                or w["served"] != len(reqs[name]["single"])
                or not w["finite"]
                or any(w[f"{part}_max_abs_diff"]
                       > 1e-6 * w[f"{part}_largest"]
                       for part in ("cover", "served"))):
            raise AssertionError(f"warm {name}: {w}, cold {cold[name]}")
    if diff > 1e-5:
        raise AssertionError(f"BERT served from graphs left the eager "
                             f"answers by {diff}")
    return out


# The batcher's deadline where the restart check compares two processes'
# served answers request for request: long enough that every batch fills
# to 8 rows, so each request runs through the same bucket graph in both
# processes (a lone request flushed at a 2 ms deadline runs the bucket-1
# graph, whose GEMM shapes sum in another order: up to 1.4e-6 apart on
# BERT-Base's logits, on an H100)
FILL_DEADLINE_MS = 5000.0


def serving_models(torch):
    """The served models of the graphed phase, from seeds: BERT-Base in
    f32 (buckets 1, 8, 32) and NCF at the ML-1M width in int8 (buckets 1,
    8, 64, 256)."""
    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    reset_name_scope()
    net = BERTClassifier(num_classes=2, bert_config=BERT_BASE,
                         generator=torch.Generator().manual_seed(SEED))
    bert = InferenceModel.from_keras_net(net, device="cuda",
                                         batch_buckets=(1, 8, 32))
    reset_name_scope()
    ncf = NeuralCF(USERS, ITEMS, class_num=5, user_embed=20, item_embed=20,
                   hidden_layers=(40, 20, 10), mf_embed=20, device="cuda")
    load_jax_params(ncf.model, seeded_params(ncf.model, SEED))
    return {"bert": bert, "ncf_int8": ncf.inference_model(
        weight_dtype="int8")}


def serving_requests():
    """Per model: one padded batch per bucket signature (``cover``),
    single-row requests for the batcher, and an 8-row BERT batch."""
    bert = bert_requests(64, 128, SEED + 5)
    rs = np.random.RandomState(SEED + 6)
    u = rs.randint(1, USERS + 1, (256, 1)).astype(np.int32)
    i = rs.randint(1, ITEMS + 1, (256, 1)).astype(np.int32)
    return {"bert": {"cover": [batch_of(bert[:b]) for b in (1, 8, 32)],
                     "single": bert, "batch8": batch_of(bert[:8])},
            "ncf_int8": {"cover": [[u[:b], i[:b]] for b in (1, 8, 64, 256)],
                         "single": [[u[r:r + 1], i[r:r + 1]]
                                    for r in range(64)]}}


def serve_warm(cache_dir):
    """The restarted serving process: the same seeded models warm from
    the cache, then serve single requests through ``DynamicBatcher``;
    writes its answers to ``<cache_dir>.answers.npz`` and prints one JSON
    line."""
    import torch

    from analytics_zoo_tpu_torch.deploy import CompileCache, DynamicBatcher

    models = serving_models(torch)
    reqs = serving_requests()
    out, answers = {}, {}
    for name, im in models.items():
        cache = CompileCache(cache_dir)
        im.attach_compile_cache(cache, name=name)
        t0 = time.perf_counter()
        warmed = im.warm()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        batcher = DynamicBatcher(im, max_batch=8,
                                 max_latency_ms=FILL_DEADLINE_MS)
        ans, ms = serve_requests(batcher, reqs[name]["single"], 8)
        batcher.close()
        cover = np.concatenate([im.predict(xs) for xs in
                                reqs[name]["cover"]])
        answers[f"{name}_cover"], answers[f"{name}_served"] = cover, ans
        out[name] = {"warmed": warmed, "warm_s": warm_s,
                     "compile_count": im.compile_count,
                     "warm_count": im.warm_count, "served": len(ms),
                     "p50_ms": float(np.percentile(ms, 50)),
                     "p99_ms": float(np.percentile(ms, 99)),
                     "finite": bool(np.all(np.isfinite(ans))
                                    and np.all(np.isfinite(cover))),
                     "cache": cache.stats()["events"],
                     "capture_s": [p["capture_s"] for p in programs_of(
                         im._programs).values()]}
    np.savez(cache_dir + ".answers.npz", **answers)
    print(json.dumps(out))
    return 0


def graphed_phase(torch, eb, fa, card):
    """Phase 8 (docstring item 8): NCF and BERT-Base training and
    serving, eager against graphed, with the card beside the numbers."""
    import gc
    import shutil
    import tempfile

    out = {"card": card, "ncf_training": graphed_ncf_training(torch, eb)}
    gc.collect()
    torch.cuda.empty_cache()
    out["bert_training"] = graphed_bert_training(torch, fa)
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="zoo_graphs_")
    try:
        out["serving"] = graphed_serving(torch, fa, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary = {
        "card": card,
        "ncf_ms_per_step": {k: {m: v[m]["ms_per_step"]
                                for m in ("eager", "graphed")}
                            for k, v in out["ncf_training"].items()},
        "bert_ms_per_step": {k: {m: v[m]["ms_per_step"]
                                 for m in ("eager", "graphed")}
                             for k, v in out["bert_training"].items()},
        "bert_serving_8_rows": {k: {m: out["serving"][
            "bert_8_row_batches"][k][m] for m in ("p50_ms", "p99_ms")}
            for k in ("eager", "graphed")}}
    log("graphed_summary", json.dumps(summary))
    return out


# ---------------------------------------------------------------------------
# ClusterServing phase

# The served records: NCF (user, item) pairs drawn from the MovieLens-1M
# stand-in, BERT-Base ids at L = 128; the worker's top-N
CLUSTER_NCF, CLUSTER_BERT, CLUSTER_L, CLUSTER_TOP_N = 4096, 64, 128, 2
# the two records the worker must refuse, and the codes each may carry:
# no tensor field is malformed; a 1 ms TTL has run out by the time the
# poller claims it (expired) or cannot be met (overloaded)
CLUSTER_BAD = {"bad_fields": ("malformed",),
               "bad_ttl": ("expired", "overloaded")}
# NCF answers against the plain versions: phase 3's atol on probabilities;
# BERT: phase 5's bound on a logit; the text phase's int8 TextClassifier:
# on a logit (kernel 3 against its plain version, 1e-4 of logits of up to
# about 10)
CLUSTER_TOL = {"ncf": 1e-5, "bert": 1e-3, "text": 1e-3}
CLUSTER_STAGES = ("queue_wait", "decode", "batch_wait", "device", "respond",
                  "e2e")


def split_pair(x):
    """The served NCF's preprocess, on the card inside each bucket
    graph: one (B, 2) id pair → the net's (user, item) inputs."""
    return x[:, :1], x[:, 1:]


def cluster_records():
    """The records every queue run serves: 4096 NCF (user, item) pairs,
    drawn from ``generate_movielens_like(seed=0)``, and 64 BERT id rows."""
    from analytics_zoo_tpu_torch.data import generate_movielens_like

    u, i, _ = generate_movielens_like(seed=SEED)
    pick = np.random.RandomState(SEED + 9).permutation(len(u))[:CLUSTER_NCF]
    pairs = np.stack([u[pick], i[pick]], axis=1).astype(np.int32)
    rs = np.random.RandomState(SEED + 10)
    ids = rs.randint(0, BERT_BASE["vocab"],
                     (CLUSTER_BERT, CLUSTER_L)).astype(np.int32)
    return {"ncf": pairs, "bert": ids}


def cluster_models(torch):
    """int8 NCF at the ML-1M width (buckets 1, 8, 64, 256) and BERT-Base
    f32 (buckets 1, 8, 32), from seeds, on the card."""
    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    reset_name_scope()
    ncf = NeuralCF(USERS, ITEMS, class_num=5, user_embed=20, item_embed=20,
                   hidden_layers=(40, 20, 10), mf_embed=20, device="cuda")
    load_jax_params(ncf.model, seeded_params(ncf.model, SEED))
    reset_name_scope()
    net = BERTClassifier(num_classes=2, bert_config=BERT_BASE,
                         generator=torch.Generator().manual_seed(SEED))
    return {"ncf": ncf.inference_model(weight_dtype="int8",
                                       preprocess=split_pair,
                                       batch_buckets=(1, 8, 64, 256)),
            "bert": InferenceModel.from_keras_net(
                net, device="cuda", batch_buckets=(1, 8, 32))}


def cluster_cover(models, recs, cache_dir):
    """A first process's work, here in the same one: every bucket of each
    model through a top-2 replica and through ``predict`` (the sync
    fallback's path), twice each (eager, then captured), so the compile
    cache holds every signature the worker can run."""
    from analytics_zoo_tpu_torch.deploy import CompileCache

    cache = CompileCache(cache_dir)
    for name, im in models.items():
        im.attach_compile_cache(cache, name=name)
        (rep,) = im.replica_forwards(1, top_n=CLUSTER_TOP_N)
        for b in im.batch_buckets:
            xs = [recs[name][:b]]
            for _ in range(2):
                rep.harvest(rep.dispatch(xs))
                im.predict(xs[0])
    return cache.stats()


def cluster_reference(torch, models, recs):
    """Every record's scores through the plain versions on the card."""
    from analytics_zoo_tpu_torch.ops import dispatch

    with dispatch.forced("reference"):
        return {name: np.concatenate([
            models[name].predict(recs[name][s:s + 256])
            for s in range(0, len(recs[name]), 256)])
            for name in models}


def cluster_uris():
    recs = cluster_records()
    return [(name, f"{name}{r}", recs[name][r])
            for r in range(max(CLUSTER_NCF, CLUSTER_BERT))
            for name in ("ncf", "bert") if r < len(recs[name])]


def serve_client(backend, address, out_path):
    """The client process (``chip_smoke.py --serve-client BACKEND ADDRESS
    OUT``): attaches to the worker's queue (a ShmQueue segment by name,
    or a FileQueue root), pushes every record from one thread, then the
    malformed and the 1 ms TTL records, while it reads the answers as
    they come; writes them to ``OUT`` (npz) and prints one JSON line.  It
    never touches CUDA."""
    import torch

    from analytics_zoo_tpu_torch.deploy import (FileQueue, InputQueue,
                                                OutputQueue, ShmQueue)

    q = (ShmQueue.attach(address, push_timeout_s=120.0) if backend == "shm"
         else FileQueue(address))
    iq, oq = InputQueue(q), OutputQueue(q)
    todo = cluster_uris()
    errors = []

    def push():
        try:
            for name, uri, x in todo:
                iq.enqueue(uri=uri, model=name,
                           **{"x" if name == "ncf" else "ids": x})
            q.push({"uri": "bad_fields", "ts": time.time(), "fmt": "tensor",
                    "model": "ncf", "note": "no tensor field"})
            iq.enqueue(uri="bad_ttl", model="ncf", ttl_ms=1.0,
                       x=np.ones(2, np.int32))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    want = len(todo) + len(CLUSTER_BAD)
    answers = {}
    t0 = time.perf_counter()
    pusher = threading.Thread(target=push)
    pusher.start()
    deadline = time.monotonic() + 300
    while len(answers) < want and time.monotonic() < deadline:
        answers.update(oq.dequeue(timeout=0.5))
    wall = time.perf_counter() - t0
    pusher.join(timeout=60)
    out = {}
    for name, n in (("ncf", CLUSTER_NCF), ("bert", CLUSTER_BERT)):
        idx = np.full((n, CLUSTER_TOP_N), -1, np.int64)
        val = np.full((n, CLUSTER_TOP_N), np.nan, np.float64)
        for r in range(n):
            a = answers.get(f"{name}{r}")
            if isinstance(a, list) and len(a) == CLUSTER_TOP_N:
                idx[r] = [p[0] for p in a]
                val[r] = [p[1] for p in a]
        out[f"{name}_idx"], out[f"{name}_val"] = idx, val
    np.savez(out_path, **out)
    if backend == "shm":
        q.stop()
    print(json.dumps({
        "backend": backend, "records": len(todo), "answered": len(answers),
        "wall_s": wall, "records_per_s": len(todo) / wall,
        "errors": {k: answers.get(k) for k in CLUSTER_BAD},
        "push_errors": errors,
        "cuda_initialized": torch.cuda.is_initialized()}))
    return 0 if len(answers) == want and not errors else 1


def cluster_check(name, idx, val, ref):
    """Served top-2 against the plain path's scores: each returned value
    within the model's tolerance of the plain score at its index and of
    the plain top-2 value at its rank; indices that differ from the plain
    top-2 are counted, and allowed only where the plain scores tie within
    the tolerance."""
    tol = CLUSTER_TOL[name]
    order = np.argsort(-ref, axis=1)[:, :CLUSTER_TOP_N]
    top = np.take_along_axis(ref, order, 1)
    ok = idx.min() >= 0
    at = np.take_along_axis(ref, np.clip(idx, 0, ref.shape[1] - 1), 1)
    err = float(max(np.abs(val - at).max(), np.abs(val - top).max()))
    moved = int((idx != order).any(axis=1).sum())
    return {"rows": len(idx), "max_abs_err": err, "tol": tol,
            "index_mismatch_rows": moved,
            "ok": bool(ok and np.isfinite(val).all() and err <= tol)}


def stage_rollup(delta):
    """Per model and stage: count, p50 and p99 in ms, from a metrics
    window."""
    out = {}
    for series, h in delta["histograms"].items():
        if not series.startswith("serving_stage_seconds{"):
            continue
        labels = dict(kv.split("=") for kv in series[len(
            "serving_stage_seconds{"):-1].split(","))
        m, st = labels["model"].strip('"'), labels["stage"].strip('"')
        out.setdefault(m, {})[st] = {
            "count": h["count"], "p50_ms": 1e3 * h["p50"],
            "p99_ms": 1e3 * h["p99"]}
    return out


def device_busy(delta, wall_s):
    """The card's busy share from a metrics window: the seconds the card
    ran the bucket graphs of the flights harvested in it (CUDA events
    that each graph records at its start and end, so no host time lies
    between them: ``serving_device_busy_seconds_total``) over the
    window's wall time.  ``torch.profiler`` sees no device time for the
    graphs the executor's thread launches, so CUDA events time them."""
    by_model = {}
    for series, v in delta["counters"].items():
        if series.startswith("serving_device_busy_seconds_total{"):
            by_model[series.split('model="')[1].split('"')[0]] = v
    busy = sum(by_model.values())
    return {"wall_s": wall_s, "device_s": busy,
            "device_busy_share": busy / wall_s, "device_s_by_model": by_model}


SERVING_COUNTERS = ("replica_quarantined", "replica_rebuilt",
                    "replica_restored", "batch_retries",
                    "sync_fallback_batches", "device_batches",
                    "harvest_abandoned", "stage_restarted", "decode_overlap",
                    "device_idle_events", "batch_fuse_copies",
                    "codec_tensor_copies", "shm_backpressure_waits")


def cluster_run(torch, eb, dq, fa, models, recs, refs, backend, root,
                cache_dir, crash):
    """One worker on one queue: start (warm from the cache), the client
    process pushes and reads, the answers are held against the plain
    versions; returns the run's numbers."""
    import gc
    import os

    from analytics_zoo_tpu_torch.core.profiling import TIMERS
    from analytics_zoo_tpu_torch.deploy import (ClusterServing, FileQueue,
                                                ServingConfig, ShmQueue)
    from analytics_zoo_tpu_torch.observe.metrics import METRICS
    from analytics_zoo_tpu_torch.robust import FaultInjector

    cfg = ServingConfig(postprocess_top_n=CLUSTER_TOP_N, batch_size=256,
                        max_batch_delay_ms=2.0, decode_workers=4,
                        compile_cache_dir=cache_dir, supervise=True,
                        breaker_threshold=1, breaker_cooldown_s=0.25,
                        supervisor_interval_s=0.01)
    if backend == "shm":
        queue = ShmQueue(name="smoke", slots=1024, slot_bytes=1 << 12,
                         result_slots=1024, result_slot_bytes=1 << 10)
        address = queue.segment
    else:
        address = os.path.join(root, "spool")
        queue = FileQueue(address)
    out_path = os.path.join(root, f"answers_{backend}.npz")
    fi = FaultInjector()
    if crash:
        # one dispatch of the run fails: its replica's breaker opens
        fi.plan("serving.replica_crash", at=4,
                exc=RuntimeError("injected replica crash"))
    cs = ClusterServing(dict(models), queue, cfg)
    try:
        t0 = time.perf_counter()
        cs.start()
        torch.cuda.synchronize()
        start_s = time.perf_counter() - t0
        counts0 = TIMERS.counts()
        window = METRICS.snapshot()
        reset_counts(eb, dq, fa)
        with fi:
            client = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--serve-client", backend, address, out_path],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            busy = None
            if not crash:
                # one second of the run, once answers flow (the client
                # process needs seconds to import torch)
                deadline = time.monotonic() + 60
                while (cs.records_served < 200
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
                second = METRICS.snapshot()
                t1 = time.perf_counter()
                time.sleep(1.0)
                busy = device_busy(METRICS.delta(second),
                                   time.perf_counter() - t1)
            try:
                stdout, stderr = client.communicate(timeout=400)
            finally:
                if client.poll() is None:
                    client.kill()
                    client.communicate()
        if crash:
            # the slot comes back by the supervisor's rebuild or by the
            # breaker's half-open probe, whichever comes first after the
            # cooldown; wait for one of them if the traffic ended sooner
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not any(
                    TIMERS.count(f"serving/{k}") - counts0.get(
                        f"serving/{k}", 0)
                    for k in ("replica_rebuilt", "replica_restored")):
                time.sleep(0.05)
        torch.cuda.synchronize()
        launches = {"embedding_bag_fwd": eb.LAUNCHES.value,
                    "dequant_matmul": dq.LAUNCHES.value,
                    "flash_attention_fwd": fa.LAUNCHES.value}
        delta = METRICS.delta(window)
        health = cs.health()
        fired = dict(fi.fired)
    finally:
        cs.stop(timeout=30)
        # the last records' views of the segment go with the worker and
        # with the injected exception's traceback
        del cs, fi
        gc.collect()
        if backend == "shm":
            queue.stop()
    if client.returncode != 0:
        raise AssertionError(f"the {backend} client failed "
                             f"(rc {client.returncode}): {stdout[-2000:]} "
                             f"{stderr[-3000:]}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    with np.load(out_path) as f:
        got = dict(f)
    checks = {name: cluster_check(name, got[f"{name}_idx"],
                                  got[f"{name}_val"], refs[name])
              for name in recs}
    counters = {k: TIMERS.count(f"serving/{k}") - counts0.get(
        f"serving/{k}", 0) for k in SERVING_COUNTERS}
    out = {"backend": backend, "start_s": start_s, "client": summary,
           "checks": checks, "launches": launches,
           "compile_count": {m: im.compile_count for m, im in models.items()},
           "warm_count": {m: im.warm_count for m, im in models.items()},
           "stages_by_model": stage_rollup(delta),
           "health_stages": {k: health["stages"].get(k) for k in
                             CLUSTER_STAGES},
           "records_served": health["records_served"],
           "counters": counters,
           "supervisor": {"checks": health.get("supervisor"),
                          "replica_states": health.get("replica_states")},
           "fault_fired": fired, "device_busy_one_second": busy,
           "device_busy_run": device_busy(delta, summary["wall_s"])}
    return out


def cluster_serving_phase(torch, eb, dq, fa, card):
    """Phase 9 (docstring item 9): int8 NCF and BERT-Base served together
    by one ClusterServing worker, warmed from a compile cache, to a client
    in another process over a ShmQueue and then a FileQueue."""
    import gc
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="zoo_cluster_")
    try:
        recs = cluster_records()
        cache_dir = f"{root}/compile_cache"
        cold = cluster_models(torch)
        t0 = time.perf_counter()
        cache = cluster_cover(cold, recs, cache_dir)
        cover_s = time.perf_counter() - t0
        refs = cluster_reference(torch, cold, recs)
        del cold
        gc.collect()
        torch.cuda.empty_cache()
        models = cluster_models(torch)
        runs = [cluster_run(torch, eb, dq, fa, models, recs, refs, backend,
                            root, cache_dir, crash=backend == "shm")
                for backend in ("shm", "file")]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"card": card, "cover_s": cover_s, "cache": cache,
           "runs": runs}
    log("cluster_serving", json.dumps(out))
    summary = {"card": card}
    for run in runs:
        b = run["backend"]
        summary[b] = {
            "records_per_s": run["client"]["records_per_s"],
            "e2e_ms": {m: {k: s["e2e"][k] for k in ("p50_ms", "p99_ms")}
                       for m, s in run["stages_by_model"].items()},
            "stages_ms": {k: (None if v is None else
                              {"p50": v["p50_ms"], "p99": v["p99_ms"]})
                          for k, v in run["health_stages"].items()},
            "compile_count": run["compile_count"],
            "launches": run["launches"],
            "counters": {k: v for k, v in run["counters"].items() if v},
            "errors": run["client"]["errors"],
            "max_abs_err": {m: c["max_abs_err"]
                            for m, c in run["checks"].items()},
            "device_busy_share_run": run["device_busy_run"][
                "device_busy_share"],
            "device_busy_share_one_second": (
                run["device_busy_one_second"] or {}).get(
                    "device_busy_share")}
    log("cluster_serving_summary", json.dumps(summary))
    for run in runs:
        b, c = run["backend"], run["counters"]
        bad = [f"{m}: {v}" for m, v in run["checks"].items() if not v["ok"]]
        for uri, codes in CLUSTER_BAD.items():
            e = run["client"]["errors"].get(uri)
            if not isinstance(e, dict) or e.get("code") not in codes:
                bad.append(f"{uri} answered {e!r}")
        if run["client"]["answered"] != (run["client"]["records"]
                                         + len(CLUSTER_BAD)):
            bad.append("records lost")
        if run["client"]["cuda_initialized"]:
            bad.append("the client process touched CUDA")
        if any(run["compile_count"].values()):
            bad.append(f"live captures after warm: {run['compile_count']}")
        if not all(run["launches"].values()):
            bad.append(f"a kernel of the path never ran: {run['launches']}")
        if b == "shm" and not (
                run["fault_fired"].get("serving.replica_crash") == 1
                and c["replica_quarantined"] >= 1
                and c["batch_retries"] + c["sync_fallback_batches"] >= 1
                and c["replica_rebuilt"] + c["replica_restored"] >= 1):
            bad.append(f"the crash was not recovered: {c} "
                       f"{run['fault_fired']}")
        if b == "shm" and c["codec_tensor_copies"]:
            # the shared-memory path hands slot views to the bucket's
            # staging copy (the file queue copies by design: its file is
            # deleted once read)
            bad.append(f"codec copies: {c['codec_tensor_copies']}")
        if bad:
            raise AssertionError(f"cluster serving over {b}: {bad}")
    return ({k: sum(run["launches"][k] for run in runs)
             for k in runs[0]["launches"]},
            runs[0]["client"]["records_per_s"])


# ---------------------------------------------------------------------------
# image phase (ResNet-50)


# ResNet-50 as bench.py's bench_resnet50 trains it: ImageNet's width, bf16
# compute, Adam 1e-3, batch 256, 224x224 uint8 images scaled by 1/255
RESNET_TRAIN = dict(rows=1024, batch=256, epochs=2, lr=1e-3)
# bench.py's bench_resnet_accuracy: the scene task, held-out accuracy
RESNET_ACC = dict(n=4096, size=32, epochs=3, batch=256, lr=3e-4,
                  bn_momentum=0.3, k=4, floor=0.9)
IMAGE_BUCKETS = (1, 8, 32, 64)
# Graphed against eager, 8 bf16 Adam steps from one init, cuDNN's
# deterministic algorithms on both sides: the two runs take the same
# kernels in the same order on the same inputs, so they should be equal
# bit for bit; what is held is the L2 distance of the parameters (and of
# the moving statistics) within 1e-3 of how far the graphed run moved
# them, which a single bf16 step taken differently (a relative 2^-8 on
# some element's gradient, which Adam may turn into a learning rate's
# move) would still pass, and a stale or skipped captured step would not.
GRAPHED_REL = 1e-3
# Served answers against the plain f32 eval forward: 1e-4 of the largest
# |logit| for f32 weights (53 layers of f32 sums, and cuDNN's algorithm
# for another batch size sums in another order) and for int8 / int4
# weights against the dequantized tree (the same f32 weights; kernel 3's
# f32 x takes three bf16 products per product, within 1e-4 of its plain
# version); the uint8 wire in bf16 against the f32 forward on the same
# normalized images: logits within 0.1 of the largest (every layer rounds
# to bf16, a relative 2^-8, through 53 layers: 0.47-0.55% measured on
# an H100) and the same top-1 on every image whose plain top-1 leads its
# second by more than twice that tolerance (the smoke's net, 12 steps on
# random labels, has logits within about 0.44 and most top-2 margins
# far below one bf16 step of them, where the top-1 is a coin toss; the
# agreement over all images is printed beside).
SERVE_F32_REL = 1e-4
SERVE_BF16_REL = 2.0 ** -5


# a ResNet step's kernels by kind, from their names (the first match)
KERNEL_KINDS = (
    ("batch_norm", ("batch_norm",)),
    ("convolution", ("cudnn", "cutlass", "xmma", "conv", "sm90_", "sm80_",
                     "implicit", "wgrad", "dgrad", "gemm")),
    ("pooling", ("pool",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "foreach", "copy", "fill")),
)


def scene_images(n, size, seed):
    """bench.py's scene task drawn with numpy: noise, then a warm disc
    (label 1) or a cool bar (label 0) of random place, size and colour;
    float32 in [0, 1]."""
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 2, n).astype(np.int32)
    rows, cols = np.mgrid[:size, :size]
    x = np.empty((n, size, size, 3), np.float32)
    for i, kind in enumerate(y):
        img = (rs.rand(size, size, 3) * 60).astype(np.uint8)
        cx, cy = rs.randint(6, size - 6, 2)
        if kind:
            color = (rs.randint(0, 80), rs.randint(60, 140),
                     rs.randint(170, 255))
            r = rs.randint(4, size // 4)
            img[(cols - cx) ** 2 + (rows - cy) ** 2 <= r * r] = color
        else:
            color = (rs.randint(170, 255), rs.randint(60, 140),
                     rs.randint(0, 80))
            img[cy:min(size - 1, cy + 5) + 1,
                cx:min(size - 1, cx + 12) + 1] = color
        x[i] = img.astype(np.float32) / 255.0
    return x, y


def resnet_leg(torch, init, x, y, graphed, deterministic=False):
    """ResNet-50 at ImageNet's width from ``init`` (params, state) trained
    ``RESNET_TRAIN`` epochs on device-resident ``x``, ``y``, graphed or
    eager; the first epoch's dispatches are timed one by one (the first
    is eager, the second captures), the second epoch's wall time is the
    step time; one more epoch runs under ``torch.profiler``."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.convert import (export_params, export_state,
                                                 load_jax_params)
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.models.image import resnet50
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.train.optimizers import Adam

    cfg = RESNET_TRAIN
    torch.backends.cudnn.deterministic = deterministic
    reset_name_scope()
    net = resnet50(1000, (224, 224, 3))
    load_jax_params(net, *init)
    net.compile(Adam(lr=cfg["lr"]),
                "sparse_categorical_crossentropy_with_logits",
                device="cuda", compute_dtype="bfloat16")
    est = net.estimator
    steps = cfg["rows"] // cfg["batch"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctx = contextlib.nullcontext() if graphed else graphs.disabled()
    dispatch_s = []
    plain_dispatch = est._dispatch

    def timed(*a, **kw):
        t0 = time.perf_counter()
        plain_dispatch(*a, **kw)
        torch.cuda.synchronize()
        dispatch_s.append(time.perf_counter() - t0)

    with ctx:
        est._dispatch = timed
        net.fit(x, y, batch_size=cfg["batch"], epochs=1, verbose=False)
        est._dispatch = plain_dispatch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = net.fit(x, y, batch_size=cfg["batch"], epochs=cfg["epochs"],
                       verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        params, state = export_params(net), export_state(net)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            net.fit(x, y, batch_size=cfg["batch"],
                    epochs=cfg["epochs"] + 1, verbose=False)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t1
    torch.backends.cudnn.deterministic = False
    events = kernel_events(torch, prof)
    busy = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:10]
    by_kind = {}
    for e in events:
        kind = next((k for k, words in KERNEL_KINDS if any(
            w in e.key.lower() for w in words)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + device_us(e) / 1e3 / steps
    ms = 1e3 * wall / steps
    out = {"graphed": graphed, "cudnn_deterministic": deterministic,
           "ms_per_step_wall": ms,
           "imgs_per_s": cfg["batch"] / (ms / 1e3),
           "ms_per_step_device": busy / steps,
           "device_busy_share": busy / (1e3 * prof_wall),
           "first_epoch_dispatch_s": dispatch_s,
           "eager_first_step_s": dispatch_s[0],
           "peak_allocated_gib": peak,
           "epoch_loss": [h["loss"] for h in est.history],
           "programs": programs_of(est._programs),
           "launches": graph_launches(prof),
           "device_ms_per_step_by_kind": by_kind,
           "top_device_ms_per_step": {e.key[:60]: device_us(e) / 1e3 / steps
                                      for e in top}}
    del hist
    return net, out, params, state


def free_card(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def resnet_training(torch):
    """Full-width ResNet-50 trained graphed and timed; then a graphed and
    an eager run from the same init with cuDNN's deterministic
    algorithms, held together."""
    from analytics_zoo_tpu_torch.convert import export_params, export_state
    from analytics_zoo_tpu_torch.models.image import resnet50
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    cfg = RESNET_TRAIN
    reset_name_scope()
    net = resnet50(1000, (224, 224, 3))
    n_params = sum(p.numel() for p in net.parameters())
    n_state = sum(t.numel() for s in net.state().values()
                  for t in s.values())
    init = (export_params(net), export_state(net))
    del net
    rs = np.random.RandomState(SEED)
    x = torch.from_numpy(rs.randint(0, 256, (cfg["rows"], 224, 224, 3))
                         .astype(np.uint8)).cuda().float() / 255.0
    y = torch.from_numpy(rs.randint(0, 1000, cfg["rows"]).astype(
        np.int64)).cuda()
    net, timed, params, state = resnet_leg(torch, init, x, y, graphed=True)
    trained = (params, state)
    del net
    free_card(torch)
    _, graphed, gp, gs = resnet_leg(torch, init, x, y, graphed=True,
                                    deterministic=True)
    free_card(torch)
    _, eager, ep, es = resnet_leg(torch, init, x, y, graphed=False,
                                  deterministic=True)
    free_card(torch)
    (p_diff, p_equal), (s_diff, s_equal) = tree_diff(gp, ep), tree_diff(gs,
                                                                       es)
    compare = {
        "params_l2_rel": l2(gp, ep) / max(l2(gp, init[0]), 1e-30),
        "state_l2_rel": l2(gs, es) / max(l2(gs, init[1]), 1e-30),
        "params_max_abs_diff": p_diff, "state_max_abs_diff": s_diff,
        "bit_equal": p_equal and s_equal, "tolerance_l2_rel": GRAPHED_REL}
    out = {"parameters": n_params, "state_values": n_state,
           "rows": cfg["rows"], "batch": cfg["batch"],
           "timed": timed,
           "graphed_deterministic": graphed,
           "eager_deterministic": eager, "graphed_vs_eager": compare}
    log("resnet50_training", json.dumps(out))
    losses = timed["epoch_loss"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ResNet-50 training loss not finite: {losses}")
    if (compare["params_l2_rel"] > GRAPHED_REL
            or compare["state_l2_rel"] > GRAPHED_REL):
        raise AssertionError(f"graphed ResNet-50 left the eager run: "
                             f"{compare}")
    if not timed["programs"]:
        raise AssertionError("the graphed ResNet-50 run captured no step "
                             "program")
    del x, y
    free_card(torch)
    return out, trained


def resnet_accuracy(torch):
    """bench.py's accuracy leg: a cold ResNet-50 (2 classes, 32x32,
    ``bn_momentum=0.3``) trained on 90% of the scene task in bf16 with
    ``steps_per_execution=4`` and evaluated on the rest through the
    moving statistics."""
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.models.image import resnet50
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.train.optimizers import Adam

    cfg = RESNET_ACC
    x, y = scene_images(cfg["n"], cfg["size"], SEED)
    split = int(0.9 * cfg["n"])
    init_zoo_context(compute_dtype="bfloat16", steps_per_execution=cfg["k"])
    try:
        reset_name_scope()
        net = resnet50(2, (cfg["size"], cfg["size"], 3),
                       bn_momentum=cfg["bn_momentum"])
        net.compile(Adam(lr=cfg["lr"]),
                    "sparse_categorical_crossentropy_with_logits",
                    metrics=["accuracy"], device="cuda")
        t0 = time.perf_counter()
        hist = net.fit(x[:split], y[:split], batch_size=cfg["batch"],
                       epochs=cfg["epochs"], verbose=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res = net.evaluate(x[split:], y[split:], batch_size=512)
        programs = programs_of(net.estimator._programs)
    finally:
        init_zoo_context()
    out = {"val_accuracy": res["accuracy"], "val_loss": res["loss"],
           "floor": cfg["floor"], "epochs": cfg["epochs"],
           "train_rows": split, "val_rows": cfg["n"] - split,
           "epoch_loss": [h["loss"] for h in hist],
           "train_imgs_per_s_with_capture": split * cfg["epochs"] / dt,
           "programs": programs}
    log("resnet50_accuracy", json.dumps(out))
    if not res["accuracy"] >= cfg["floor"]:
        raise AssertionError(f"ResNet-50 validation accuracy "
                             f"{res['accuracy']} < {cfg['floor']}")
    del net
    free_card(torch)
    return out


def stem_routes(torch):
    """ResNet-50's stem both ways on one leaf: ``SpaceToDepthStemConv``
    (the JAX package's space-to-depth computation, the builder's stem)
    and the plain ``Convolution2D(64, 7, 7, subsample=2,
    border_mode="same")``: the training step's forward and backward at
    batch 256 in bf16 (ms per call from a host loop, timed by CUDA
    events: a backward does not capture beside the leaves' earlier
    autograd nodes), and the serving forward at batch 64 in f32 (device
    ms, captured); outputs held together (f32 within 1e-4 of the
    largest, bf16 within 2^-7)."""
    from analytics_zoo_tpu_torch.nn.layers import (Convolution2D,
                                                   SpaceToDepthStemConv)

    out = {}
    for dtype, b, train in ((torch.bfloat16, 256, True),
                            (torch.float32, 64, False)):
        g = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.rand(b, 224, 224, 3, device="cuda", generator=g).to(dtype)
        x.requires_grad_(train)
        shape = (b, 224, 224, 3)
        layers = {"space_to_depth": SpaceToDepthStemConv(64, bias=False),
                  "plain": Convolution2D(64, 7, 7, subsample=2,
                                         border_mode="same", bias=False)}
        outs, times = {}, {}
        kernel = None
        for route, layer in layers.items():
            layer.build(torch.Generator().manual_seed(SEED), shape)
            if kernel is None:
                kernel = layer.leaf("kernel").detach()
            layer.set_leaf("kernel", kernel)
            layer = layer.cuda().to(dtype)
            outs[route] = layer(x).float().detach()
            if train:
                w = layer.leaf("kernel")

                def fn(layer=layer, w=w):
                    torch.autograd.grad(layer(x).float().sum(), [w, x])
            else:
                def fn(layer=layer):
                    with torch.no_grad():
                        layer(x)
            times[route] = (call_ms if train else device_ms)(torch, fn, 10)
        diff = float((outs["plain"] - outs["space_to_depth"]).abs().max())
        top = float(outs["plain"].abs().max())
        tol = 2.0 ** -7 * top if dtype == torch.bfloat16 else 1e-4 * top
        key = f"{'train_fwd_bwd' if train else 'serve_fwd'}_" \
              f"{str(dtype).replace('torch.', '')}_b{b}"
        out[key] = {"ms": times, "max_abs_diff": diff,
                    "faster": min(times, key=times.get)}
        if diff > tol:
            raise AssertionError(f"stem routes disagree: {key} {diff}")
        del x, layers, outs
    log("resnet50_stem_routes", json.dumps(out))
    free_card(torch)
    return out


def image_requests(n, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (n, 224, 224, 3)).astype(np.uint8)


def served_reference(torch, net, xs, weights=None):
    """The plain f32 eval forward on the card (every kernel routed to its
    plain version) of ``net`` with ``weights`` (a params tree) if given,
    on float images, in chunks of 64."""
    import copy

    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.ops import dispatch

    ref = copy.deepcopy(net).cuda().eval()
    if weights is not None:
        load_jax_params(ref, weights)
    outs = []
    with torch.no_grad(), dispatch.forced("reference"):
        for s in range(0, len(xs), 64):
            outs.append(ref(torch.from_numpy(xs[s:s + 64]).cuda()).cpu()
                        .numpy())
    del ref
    return np.concatenate(outs)


def resnet_serving(torch, dq, net, root):
    """The trained full-width net served through ``DynamicBatcher``
    (buckets 1, 8, 32, 64) in f32, int8 and int4 weights and over the
    uint8 wire (``imagenet_preprocess``, bf16).  For each form a first
    model covers every bucket into a ``CompileCache``; a second one warms
    from it and serves 48 single images from 8 threads and 8 requests
    of 8 images from 2, kernel-3 launches zeroed just before and read
    just after."""
    import os

    from analytics_zoo_tpu_torch.deploy import (CompileCache, DynamicBatcher,
                                                InferenceModel,
                                                imagenet_preprocess)
    from analytics_zoo_tpu_torch.deploy.inference import (dequantize_pytree,
                                                          quantize_pytree)

    u8 = image_requests(112, SEED + 7)
    f32 = u8.astype(np.float32) / 127.5 - 1.0
    plain = served_reference(torch, net, f32)
    forms = (("float32", {}), ("int8", {"weight_dtype": "int8"}),
             ("int4", {"weight_dtype": "int4"}),
             ("uint8_bf16", {"preprocess": imagenet_preprocess()}))
    out = {}
    total_dq = 0
    for form, kw in forms:
        wire = u8 if form == "uint8_bf16" else f32
        if form in ("int8", "int4"):
            deq = dequantize_pytree(quantize_pytree(
                net.params(), bits=4 if form == "int4" else 8))
            want = served_reference(torch, net, f32, deq)
        else:
            want = plain
        cache = CompileCache(os.path.join(root, f"resnet_{form}"))

        def model():
            return InferenceModel.from_keras_net(
                net, device="cuda", batch_buckets=IMAGE_BUCKETS,
                name=f"resnet50_{form}", **kw)

        cover = model().attach_compile_cache(cache)
        t0 = time.perf_counter()
        for b in IMAGE_BUCKETS:
            for _ in range(2):          # eager, then captured
                cover.predict(wire[:b])
        torch.cuda.synchronize()
        cover_s = time.perf_counter() - t0
        captured = cover.compile_count
        del cover
        free_card(torch)
        im = model().attach_compile_cache(cache)
        warmed = im.warm()
        dq.LAUNCHES.reset()
        batcher = DynamicBatcher(im, max_batch=64, max_latency_ms=2.0)
        t0 = time.perf_counter()
        single, lat1 = serve_rows(batcher, [wire[i:i + 1]
                                            for i in range(48)], 8)
        eight, lat8 = serve_rows(batcher, [wire[48 + 8 * i:56 + 8 * i]
                                           for i in range(8)], 2)
        wall = time.perf_counter() - t0
        batcher.close()
        launches = dq.LAUNCHES.value
        total_dq += launches
        got = np.concatenate([single, eight])
        ref = want[:112]
        err = float(np.abs(got - ref).max())
        top = float(np.abs(ref).max())
        agree = float(np.mean(got.argmax(-1) == ref.argmax(-1)))
        top2 = np.sort(ref, axis=-1)[:, -2:]
        decided = top2[:, 1] - top2[:, 0] > 2 * SERVE_BF16_REL * top
        agree_decided = bool(np.all(got.argmax(-1)[decided]
                                    == ref.argmax(-1)[decided]))
        rec = {"p50_ms": {"1": float(np.percentile(lat1, 50)),
                          "8": float(np.percentile(lat8, 50))},
               "p99_ms": {"1": float(np.percentile(lat1, 99)),
                          "8": float(np.percentile(lat8, 99))},
               "images": 112, "wall_s": wall, "imgs_per_s": 112 / wall,
               "compile_count": im.compile_count, "warmed": warmed,
               "captured_cold": captured, "cover_s": cover_s,
               "dequant_matmul_launches": launches,
               "max_abs_err": err, "largest": top, "top1_agreement": agree,
               "top1_decided_images": int(decided.sum()),
               "top1_agree_where_decided": agree_decided,
               "weight_bytes": im.weight_nbytes(),
               "programs": programs_of(im._programs)}
        out[form] = rec
        log("resnet50_serving", form, json.dumps(rec))
        bad = (im.compile_count != 0 or warmed != len(IMAGE_BUCKETS)
               or not np.all(np.isfinite(got)) or got.shape != (112, 1000))
        if form == "uint8_bf16":
            bad = bad or err > SERVE_BF16_REL * top or not agree_decided
        else:
            bad = bad or err > SERVE_F32_REL * top
        if form in ("int8", "int4"):
            bad = bad or launches == 0
        elif launches:
            bad = True
        if bad:
            raise AssertionError(f"ResNet-50 serving ({form}) failed: {rec}")
        del im
        free_card(torch)
    return out, total_dq


def resnet_head_cases(torch, dq):
    """Kernel 3 at the ResNet-50 head's shape (K = 2048, N = 1000): the
    serving buckets' rows and the training batch, int8 and int4, f32 and
    bf16 x."""
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for bits in (8, 4):
            for m in (1, 8, 64, 256):
                cases.append(dq_case(torch, dq, "resnet_head", m, 2048, 1000,
                                     bits, dtype=dtype))
    for c in cases:
        log("kernel_case", json.dumps(c))
    return cases


def image_phase(torch, dq, card):
    """Phase 10: ResNet-50 (BASELINE config #2) trained, held to
    accuracy, served, and its stem timed against the plain convolution."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.models.image import resnet50
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    t0 = time.perf_counter()
    training, (params, state) = resnet_training(torch)
    accuracy = resnet_accuracy(torch)
    stem = stem_routes(torch)
    reset_name_scope()
    net = resnet50(1000, (224, 224, 3))
    load_jax_params(net, params, state)
    net = net.cuda().eval()
    root = tempfile.mkdtemp(prefix="zoo_resnet_")
    try:
        serving, dq_launches = resnet_serving(torch, dq, net, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del net
    free_card(torch)
    summary = {"card": card, "seconds": time.perf_counter() - t0,
               "train_imgs_per_s": training["timed"]["imgs_per_s"],
               "train_ms_per_step_wall": training["timed"][
                   "ms_per_step_wall"],
               "train_ms_per_step_device": training["timed"][
                   "ms_per_step_device"],
               "val_accuracy": accuracy["val_accuracy"],
               "serving_imgs_per_s": {k: v["imgs_per_s"]
                                      for k, v in serving.items()},
               "stem_ms": {k: v["ms"] for k, v in stem.items()}}
    log("resnet50_summary", json.dumps(summary))
    return {"training": training, "accuracy": accuracy, "stem": stem,
            "serving": serving, "dequant_matmul": dq_launches}


# ---------------------------------------------------------------------------
# recommender phase (WideAndDeep, BASELINE config #4; SessionRecommender)

# WideAndDeep as bench.py's bench_wide_and_deep sets it (census-shaped
# features after the reference WideAndDeepExample.scala): bf16 compute,
# Adam 1e-3, batch 8192, K = 32 steps per graph, 32 x 8192 device-resident
# rows; ``epochs`` graphed epochs in all, the last ``timed`` of them timed
WND_CONFIG = dict(class_num=2, wide_base_dims=(1000, 1000),
                  embed_in_dims=(5000, 1000), embed_out_dims=(64, 64),
                  continuous_cols=11, hidden_layers=(100, 75, 50, 25))
WND_TRAIN = dict(rows=32 * 8192, batch=8192, k=32, lr=1e-3, epochs=24,
                 timed=8, eval_rows=32768, metric="accuracy", floor=0.9)
# SessionRecommender at the JAX package's defaults, both towers, over the
# 37,483 items of the filtered YooChoose clicks (Hidasi et al., ICLR
# 2016, Table 1); bf16, batch 1024 (this smoke's choice), K = 16
SESSION_CONFIG = dict(item_count=37483, item_embed=100,
                      rnn_hidden_layers=(40, 20), session_length=10,
                      include_history=True, mlp_hidden_layers=(40, 20),
                      history_length=5)
SESSION_TRAIN = dict(rows=64 * 1024, batch=1024, k=16, lr=3e-3, epochs=40,
                     timed=4, eval_rows=8192, metric="top5_accuracy",
                     floor=0.2)
REC_BUCKETS = (1, 8, 64, 256)
# a recommender step's kernels by kind, from their names (the first match)
REC_KERNEL_KINDS = (
    ("embedding_bag", ("bag_fwd", "bag_bwd")),
    ("softmax", ("softmax",)),
    ("gemm", ("gemm", "cutlass", "cublas", "splitk", "xmma", "sm90_",
              "sm80_")),
    ("gather_scatter", ("index", "gather", "scatter")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "foreach", "copy", "fill", "cat")),
)
# Graphed against eager: a kernel whose order of adds is not fixed makes
# two runs of the same steps differ in the last bits of some gradients
# (the bag backward was one until its deterministic redesign); in bf16
# such a sum may round one bf16 step apart, which Adam passes on as a
# change of up to 2^-8 of that element's update.  The parameters' L2
# distance is held within REC_GRAPHED_REL of how far the graphed run moved
# them from the init (a stale or skipped captured step moves them by its
# whole update).
REC_GRAPHED_REL = 1e-3
# Served answers against the plain f32 forward on the card: within
# REC_SERVE_REL of each row's largest probability (kernel 3's f32 x takes
# three bf16 products per product, within 1e-4 of its plain version;
# int8 / int4 against the dequantized tree)
REC_SERVE_REL = 1e-4


def wnd_data(rows, seed):
    """bench.py's census-shaped rows (wide ids in [0, 1000) and [1000,
    2000), embed ids in [0, 5000) and [0, 1000), 11 standard normal
    columns), labelled by a rule the model can learn: a fixed random
    sign per wide id, both summed with the first continuous column."""
    rs = np.random.RandomState(seed)
    wide = rs.randint(0, 1000, (rows, 2)).astype(np.int32)
    wide[:, 1] += 1000
    emb = np.stack([rs.randint(0, 5000, rows), rs.randint(0, 1000, rows)],
                   axis=-1).astype(np.int32)
    cont = rs.randn(rows, 11).astype(np.float32)
    sign = np.random.RandomState(SEED + 99).choice([-1.0, 1.0], 2000)
    y = (sign[wide[:, 0]] + sign[wide[:, 1]] + cont[:, 0] > 0).astype(
        np.int32)
    return [wide, emb, cont], y


def session_data(rows, seed):
    """The Markov sessions of examples/recommendation/
    session_recommender_example.py (item i's preferred successor is (7i +
    3) % n + 1, taken with probability 0.8), vectorised, with a random
    5-item history per row; the target is the item after the session."""
    n = SESSION_CONFIG["item_count"]
    length = SESSION_CONFIG["session_length"]
    rs = np.random.RandomState(seed)
    nxt = (np.arange(n + 1) * 7 + 3) % n + 1
    sessions = np.zeros((rows, length), np.int32)
    cur = rs.randint(1, n + 1, rows)
    for t in range(length):
        sessions[:, t] = cur
        cur = np.where(rs.rand(rows) < 0.8, nxt[cur],
                       rs.randint(1, n + 1, rows))
    hist = rs.randint(1, n + 1, (rows, SESSION_CONFIG["history_length"]))
    return [sessions, hist.astype(np.int32)], cur.astype(np.int32)


def rec_model(kind, init=None):
    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.models import SessionRecommender, WideAndDeep
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    reset_name_scope()
    m = (WideAndDeep(**WND_CONFIG, device="cuda") if kind == "wnd"
         else SessionRecommender(**SESSION_CONFIG, device="cuda"))
    if init is not None:
        load_jax_params(m.model, init)
    return m


def rec_leg(torch, eb, kind, init, xs, y, epochs, graphed, timed=0):
    """``kind`` ("wnd" or "session") from ``init`` trained ``epochs``
    epochs on device-resident ``xs``, ``y`` at its configuration (bf16,
    K steps per dispatch), graphed or eager (``fit_leg``)."""
    cfg = WND_TRAIN if kind == "wnd" else SESSION_TRAIN
    return fit_leg(torch, eb, rec_model(kind, init), cfg,
                   "sparse_categorical_crossentropy", [cfg["metric"]], xs, y,
                   epochs, graphed, timed=timed)


def fit_leg(torch, eb, m, cfg, loss, metrics, xs, y, epochs, graphed,
            timed=0, compute_dtype="bfloat16", profile_epoch=True):
    """The model ``m`` trained ``epochs`` epochs on ``xs``, ``y`` at
    ``cfg``'s batch, learning rate (Adam) and K steps per dispatch,
    graphed or eager.  With ``timed``, the last ``timed`` epochs are
    timed, the bag kernels' counts zeroed just before them and read just
    after, and (``profile_epoch``) one more epoch runs under
    ``torch.profiler``.  Returns the model, the leg's numbers and its
    trained weights."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.convert import export_params
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.train.optimizers import Adam

    init_zoo_context(steps_per_execution=cfg["k"])
    m.compile(Adam(lr=cfg["lr"]), loss, metrics=metrics,
              compute_dtype=compute_dtype)
    steps = int(xs[0].shape[0]) // cfg["batch"]
    out = {"graphed": graphed}
    ctx = contextlib.nullcontext() if graphed else graphs.disabled()
    try:
        with ctx:
            t0 = time.perf_counter()
            m.fit(xs, y, batch_size=cfg["batch"], epochs=epochs - timed,
                  verbose=False)
            torch.cuda.synchronize()
            out["untimed_s"] = time.perf_counter() - t0
            if timed:
                eb.LAUNCHES.reset()
                eb.BWD_LAUNCHES.reset()
                t0 = time.perf_counter()
                m.fit(xs, y, batch_size=cfg["batch"], epochs=epochs,
                      verbose=False)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                out["launches"] = {
                    "embedding_bag_fwd": eb.LAUNCHES.value,
                    "embedding_bag_bwd": eb.BWD_LAUNCHES.value}
                out["launches_per_step"] = {
                    k: v / (timed * steps)
                    for k, v in out["launches"].items()}
                ms = 1e3 * wall / (timed * steps)
                out.update({"ms_per_step_wall": ms,
                            "samples_per_s": cfg["batch"] / (ms / 1e3)})
            if timed and profile_epoch:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    m.fit(xs, y, batch_size=cfg["batch"],
                          epochs=epochs + 1, verbose=False)
                    torch.cuda.synchronize()
                    prof_wall = time.perf_counter() - t1
                out.update(step_profile(torch, prof, steps))
                out["device_busy_share"] = (
                    out["ms_per_step_device"] * steps / (1e3 * prof_wall))
                out["graph_and_kernel_launches"] = graph_launches(prof)
    finally:
        init_zoo_context()
    out["epoch_loss"] = [h["loss"] for h in m.estimator.history]
    out["programs"] = programs_of(m.estimator._programs)
    return m, out, export_params(m.model)


def step_profile(torch, prof, steps):
    """Device ms per step, by kind (``REC_KERNEL_KINDS``) and for the top
    kernels, and kernels per step, from a profile of ``steps`` steps."""
    events = kernel_events(torch, prof)
    busy = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:8]
    by_kind = {}
    for e in events:
        kind_of = next((k for k, words in REC_KERNEL_KINDS
                        if any(w in e.key.lower() for w in words)), "other")
        by_kind[kind_of] = (by_kind.get(kind_of, 0.0)
                            + device_us(e) / 1e3 / steps)
    return {"ms_per_step_device": busy / steps,
            "device_ms_per_step_by_kind": by_kind,
            "kernels_per_step": sum(e.count for e in events) / steps,
            "top_device_ms_per_step": {e.key[:60]: device_us(e) / 1e3 / steps
                                       for e in top}}


def rec_training(torch, eb, kind, seed):
    """A timed graphed run of ``kind`` that must lower its loss and
    reach its accuracy floor, then a graphed and an eager run from the
    same init of two epochs, held together."""
    from analytics_zoo_tpu_torch.convert import export_params

    cfg = WND_TRAIN if kind == "wnd" else SESSION_TRAIN
    make = wnd_data if kind == "wnd" else session_data
    xs, y = make(cfg["rows"], seed)
    dev = [torch.from_numpy(a).cuda() for a in xs]
    yd = torch.from_numpy(y).cuda()
    init = export_params(rec_model(kind).model)
    m, timed, trained = rec_leg(torch, eb, kind, init, dev, yd,
                                cfg["epochs"], True, timed=cfg["timed"])
    n = cfg["eval_rows"]
    res = m.evaluate([a[:n] for a in xs], y[:n], batch_size=cfg["batch"])
    acc = res[cfg["metric"]]
    # the same rule on rows it never saw: reported, not held to a floor
    # (WideAndDeep's deep embeddings memorise the trained rows long before
    # Adam at 1e-3 moves the zero-initialised wide table far)
    held = m.evaluate(*(wnd_data if kind == "wnd" else session_data)(
        n, seed + 1), batch_size=cfg["batch"])
    _, graphed, gp = rec_leg(torch, eb, kind, init, dev, yd, 2, True)
    _, eager, ep = rec_leg(torch, eb, kind, init, dev, yd, 2, False)
    compare = {"params_l2_rel": l2(gp, ep) / max(l2(gp, init), 1e-30),
               "params_max_abs_diff": tree_diff(gp, ep)[0],
               "bit_equal": tree_diff(gp, ep)[1],
               "tolerance_l2_rel": REC_GRAPHED_REL,
               "graphed_epoch_loss": graphed["epoch_loss"],
               "eager_epoch_loss": eager["epoch_loss"]}
    losses = timed["epoch_loss"]
    out = {"config": WND_CONFIG if kind == "wnd" else SESSION_CONFIG,
           "train": {k: v for k, v in cfg.items()},
           "parameters": sum(p.numel() for p in m.model.parameters()),
           "timed": timed, "accuracy": acc,
           "accuracy_of": f"{cfg['metric']} on {n} trained rows",
           "accuracy_floor": cfg["floor"], "eval_loss": res["loss"],
           "held_out": held,
           "graphed_vs_eager": compare}
    log(f"{'wide_and_deep' if kind == 'wnd' else 'session'}_training",
        json.dumps(out))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{kind}: the loss did not fall: {losses}")
    if not acc >= cfg["floor"]:
        raise AssertionError(f"{kind}: accuracy {acc} < {cfg['floor']}")
    if compare["params_l2_rel"] > REC_GRAPHED_REL:
        raise AssertionError(f"{kind}: graphed left the eager run: "
                             f"{compare}")
    if not timed["programs"]:
        raise AssertionError(f"{kind}: the graphed run captured no step "
                             "program")
    if not all(timed["launches"].values()):
        raise AssertionError(f"{kind}: a bag kernel never launched in "
                             f"training: {timed['launches']}")
    del m, dev, yd
    free_card(torch)
    return out, trained


def rec_reference(torch, net, xs, weights=None):
    """The plain f32 eval forward on the card (every kernel routed to its
    plain version) of ``net`` with ``weights`` if given."""
    import copy

    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.ops import dispatch

    ref = copy.deepcopy(net).cuda().eval()
    if weights is not None:
        load_jax_params(ref, weights)
    with torch.no_grad(), dispatch.forced("reference"):
        out = ref(*[torch.from_numpy(a).cuda() for a in xs]).cpu().numpy()
    del ref
    return out


def rec_serving(torch, eb, dq, kind, trained, root):
    """The trained model served in f32, int8 and int4 from the bucket
    graphs of a model warmed from a ``CompileCache`` that a first model
    filled: WideAndDeep's requests (three inputs, one row each) through
    ``DynamicBatcher`` from 8 threads, the SessionRecommender's through
    ``recommend_for_session`` (256 sessions) and ``DynamicBatcher``;
    the kernels' counts zeroed just before and read just after."""
    import os

    from analytics_zoo_tpu_torch.deploy import CompileCache, DynamicBatcher
    from analytics_zoo_tpu_torch.deploy.inference import (dequantize_pytree,
                                                          quantize_pytree)

    m = rec_model(kind, trained)
    n = 256
    xs, _ = (wnd_data if kind == "wnd" else session_data)(n, SEED + 5)
    plain = rec_reference(torch, m.model, xs)
    out = {}
    total = {"embedding_bag_fwd": 0, "dequant_matmul": 0}
    for wd in ("float32", "int8", "int4"):
        want = plain
        if wd != "float32":
            want = rec_reference(torch, m.model, xs, dequantize_pytree(
                quantize_pytree(m.model.params(),
                                bits=4 if wd == "int4" else 8)))
        cache = CompileCache(os.path.join(root, f"{kind}_{wd}"))
        cover = m.inference_model(weight_dtype=wd, batch_buckets=REC_BUCKETS,
                                  name=f"{kind}_{wd}")
        cover.attach_compile_cache(cache)
        t0 = time.perf_counter()
        for b in REC_BUCKETS:
            for _ in range(2):          # eager, then captured
                cover.predict([a[:b] for a in xs])
        torch.cuda.synchronize()
        cover_s = time.perf_counter() - t0
        im = m.inference_model(weight_dtype=wd, batch_buckets=REC_BUCKETS,
                               name=f"{kind}_{wd}")
        im.attach_compile_cache(cache)
        warmed = im.warm()
        eb.LAUNCHES.reset()
        dq.LAUNCHES.reset()
        batcher = DynamicBatcher(im, max_batch=64, max_latency_ms=2.0)
        t0 = time.perf_counter()
        try:
            got, lat = serve_requests(
                batcher, [[a[r:r + 1] for a in xs] for r in range(n)], 8)
        finally:
            batcher.close()
        wall = time.perf_counter() - t0
        rec = None
        if kind == "session":
            t1 = time.perf_counter()
            rec = m.recommend_for_session(xs, max_items=10)
            rec_s = time.perf_counter() - t1
        launches = {"embedding_bag_fwd": eb.LAUNCHES.value,
                    "dequant_matmul": dq.LAUNCHES.value}
        for k in total:
            total[k] += launches[k]
        row_top = want.max(-1, keepdims=True)
        err = float((np.abs(got - want) / row_top).max())
        r = {"p50_ms": float(np.percentile(lat, 50)),
             "p99_ms": float(np.percentile(lat, 99)),
             "rows": n, "wall_s": wall, "rows_per_s": n / wall,
             "compile_count": im.compile_count, "warmed": warmed,
             "captured_cold": cover.compile_count, "cover_s": cover_s,
             "launches": launches, "max_err_rel_row_top": err,
             "tolerance": REC_SERVE_REL,
             "top1_agreement": float(np.mean(got.argmax(-1)
                                             == want.argmax(-1))),
             "weight_bytes": im.weight_nbytes(),
             "programs": programs_of(im._programs)}
        bad = (im.compile_count != 0 or warmed != len(REC_BUCKETS)
               or got.shape != want.shape or not np.all(np.isfinite(got))
               or err > REC_SERVE_REL or not launches["embedding_bag_fwd"]
               or bool(launches["dequant_matmul"]) != (wd != "float32"))
        if rec is not None:
            # the helper's top-10 are the plain forward's highest
            tenth = np.sort(want, axis=-1)[:, -10]
            r["recommend_for_session_s"] = rec_s
            r["recommend_top10_ok"] = all(
                len(row) == 10 and all(
                    want[i, item] >= tenth[i] - REC_SERVE_REL * row_top[i, 0]
                    for item, _ in row) for i, row in enumerate(rec))
            bad = bad or not r["recommend_top10_ok"]
        out[wd] = r
        log(f"{'wide_and_deep' if kind == 'wnd' else 'session'}_serving",
            wd, json.dumps(r))
        if bad:
            raise AssertionError(f"{kind} serving ({wd}) failed: {r}")
        del cover, im
        free_card(torch)
    return out, total


def recommender_kernel_cases(torch, eb, dq):
    """Kernels 1-3 at the recommenders' shapes: the wide tower's (2000, 2)
    table (f32, and bf16 as the bf16 step casts it) with 8192 bags of 2,
    the deep columns, the session and history gathers; the backward at
    the training shapes; the dequantize-matmul at the session head (K =
    40, N = 37,484) per serving bucket, WideAndDeep's Dense layers and N
    = 2."""
    bag, bwd, dqc = [], [], []
    for dtype in (torch.float32, torch.bfloat16):
        bag.append(bag_case(torch, eb, "wide_tower", 2000, 2, 8192, 2,
                            "sum", None, dtype=dtype))
    for vocab in (5001, 1001):
        bag.append(bag_case(torch, eb, "wnd_deep_column", vocab, 64, 8192, 1,
                            "sum", None))
    bag.append(bag_case(torch, eb, "session_gather", 37484, 100, 10240, 1,
                        "sum", None))
    bag.append(bag_case(torch, eb, "history_gather", 37484, 100, 5120, 1,
                        "sum", None))
    bwd.append(bag_bwd_case(torch, eb, "wide_tower", 2000, 2, 8192, 2,
                            "sum", None))
    bwd.append(bag_bwd_case(torch, eb, "wnd_deep_column", 5001, 64, 8192, 1,
                            "sum", None))
    bwd.append(bag_bwd_case(torch, eb, "session_gather", 37484, 100, 10240,
                            1, "sum", None))
    for bits in (8, 4):
        for m in REC_BUCKETS:
            dqc.append(dq_case(torch, dq, "session_head", m, 40, 37484, bits,
                               iters=50))
    for k, n, bits in ((139, 100, 8), (100, 75, 4), (75, 50, 8),
                       (50, 25, 4), (25, 2, 8), (26, 2, 4), (500, 40, 4)):
        dqc.append(dq_case(torch, dq, "recommender_dense", 256, k, n, bits))
    for c in bag + bwd + dqc:
        log("kernel_case", json.dumps(c))
    return bag, bwd, dqc


def recommender_phase(torch, eb, dq, card):
    """Phase 11: WideAndDeep (BASELINE config #4) and SessionRecommender
    trained on the card (bf16, graphed) and served in three weight
    forms."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="zoo_rec_")
    paths = {}
    summary = {"card": card}
    try:
        for kind, name, seed in (("wnd", "wide_and_deep", SEED + 11),
                                 ("session", "session", SEED + 13)):
            training, trained = rec_training(torch, eb, kind, seed)
            serving, served = rec_serving(torch, eb, dq, kind, trained, root)
            paths[f"{name}_training"] = training["timed"]["launches"]
            paths[f"{name}_serving"] = served
            summary[name] = {
                "samples_per_s": training["timed"]["samples_per_s"],
                "ms_per_step_device": training["timed"][
                    "ms_per_step_device"],
                "device_busy_share": training["timed"][
                    "device_busy_share"],
                "accuracy": training["accuracy"],
                "graphed_vs_eager_l2_rel": training["graphed_vs_eager"][
                    "params_l2_rel"],
                "served_p50_ms": {k: v["p50_ms"] for k, v in serving.items()},
                "served_rows_per_s": {k: v["rows_per_s"]
                                      for k, v in serving.items()}}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["seconds"] = time.perf_counter() - t0
    log("recommender_summary", json.dumps(summary))
    return paths


# ---------------------------------------------------------------------------
# text phase (TextClassifier, KNRM, Seq2seq, AnomalyDetector)

# TextClassifier at the JAX package's defaults, which follow the
# reference TextClassifier.scala: 200-wide word vectors over 500 tokens,
# 256 filters, the 5,000 most frequent words (a 5001 x 200 table); the 20
# classes of 20 Newsgroups, on which the reference example trains
TEXT_CONFIG = dict(class_num=20, token_length=200, sequence_length=500,
                   encoder_output_dim=256, max_words_num=5000)
# the smoke's corpus (its own choice; GloVe and 20 Newsgroups are not in
# the repo): documents of 100-500 words, Zipf s = 1.0 over the 4,000
# common ids 1 ... 4000, each word replaced at rate ``theme_share`` by one
# of its class's 50 theme words (ids 4001 ... 5000), front-padded with id
# 0 to 500 as TextSet.shape_sequence pads; the first ``held`` held out
TEXT_CORPUS = dict(docs=16384, held=2048, min_len=100, max_len=500,
                   common=4000, theme_words=50, theme_share=0.05)
# the reference example's batch 128 and the JAX example's Adam 1e-3; bf16,
# K steps per graph; ``epochs`` graphed epochs, the last ``timed`` timed
TEXT_TRAIN = dict(batch=128, k=8, lr=1e-3, epochs=6, timed=2, floor=0.9)
# the LSTM and GRU encoders at the same widths and T = 500 (the smoke's
# choice: 2,048 rows, one step per graph, the second of 2 epochs timed)
TEXT_RNN_TRAIN = dict(rows=2048, batch=128, k=1, lr=1e-3, epochs=2,
                      timed=1)
TEXT_BUCKETS = (1, 8, 64, 128)
TEXT_LOSS = "sparse_categorical_crossentropy_with_logits"
# Graphed against eager from one init, in f32.  The bag backward is
# deterministic, and with cuDNN's deterministic convolutions the two runs
# are held to the same bits after TEXT_GRAPHED_STEPS steps (three 8-step
# dispatches: the eager warm-up, the capture, a replay).  With cuDNN free
# to pick its convolution backward (the default, as the training runs
# use) the runs differ in the last bits from the first step on (two eager
# runs do too): there the parameters' L2 distance is held within
# TEXT_GRAPHED_REL of the graphed run's movement from the init (a stale
# or skipped captured step moves them by a share of its whole update).
# Over two epochs the difference grows through the training's own
# sensitivity (the max pool's argmax, Adam's normalised steps on
# near-zero gradients) to a share of the movement (0.13-0.49 in f32 and
# bf16 on an H100, 700 W): there the parameters' distance is reported,
# and the last epoch's losses are held within TEXT_GRAPHED_LOSS_REL of
# each other (they parted by up to 4.7%; the loss falls 17-fold from the
# first epoch to the second, so a run whose replays went stale would be
# far outside the band)
TEXT_GRAPHED_STEPS = 24
TEXT_GRAPHED_REL = 1e-3
TEXT_GRAPHED_LOSS_REL = 0.2
# Served logits against the plain f32 forward on the card, within
# TEXT_SERVE_REL of each row's largest |logit| (kernel 3's f32 x takes
# three bf16 products per product; int8 / int4 against the dequantized
# tree)
TEXT_SERVE_REL = 1e-4
# KNRM as the reference qaranker example runs it: query 10 and answer 40
# tokens, 21 kernels, sigma 0.1, exact-match sigma 0.001, GloVe's 300-wide
# vectors; the 5,000-word vocabulary is the smoke's choice.  Trained with
# rank_hinge on (pos, neg) pairs, f32, batch 128 (64 pairs); a relevant
# answer holds 16 of its query's words, and held-out lists hold 1
# relevant and 4 other answers per query.  Adam at 1e-2 (the smoke's
# choice): the pooled features are scaled by 0.01, so at 1e-3 the score's
# weights move too little in 512 steps to outweigh their random start
# (NDCG@3 0.44 on an H100, chance level)
KNRM_CONFIG = dict(text1_length=10, text2_length=40, max_words_num=5000,
                   embed_size=300, kernel_num=21, sigma=0.1,
                   exact_sigma=0.001)
KNRM_TRAIN = dict(pairs=8192, batch=128, k=1, lr=1e-2, epochs=4,
                  matches=16, queries=256, candidates=5, ndcg_k=3,
                  floor=0.9, odd_rows=1001)
# Seq2seq, every width the smoke's choice: vocabulary 5001, embed 64, two
# LSTM layers of 128, the dense bridge; the JAX test's copy task (decoder
# input: start sign 1, then the source shifted right; ids in [2, 5001))
SEQ2SEQ_CONFIG = dict(vocab_size=5001, embed_dim=64, rnn_type="lstm",
                      num_layers=2, hidden_size=128, bridge_type="dense")
SEQ2SEQ_TRAIN = dict(rows=8192, length=8, batch=256, k=8, lr=3e-3,
                     epochs=4, decode_rows=64, max_seq_len=12, beam=4,
                     stop_sign=2, length_penalty=0.6)
# beam scores (sums of 12 f32 log-probabilities) against the plain
# versions on the card
SEQ2SEQ_SCORE_TOL = 1e-4
# AnomalyDetector at the JAX and reference defaults; a sine series (the
# JAX test's, period 20 pi steps) and a held-out continuation with spikes
ANOMALY_CONFIG = dict(feature_shape=(24, 1), hidden_layers=(8, 32, 15),
                      dropouts=(0.2, 0.2, 0.2))
ANOMALY_TRAIN = dict(points=4096, batch=64, k=1, lr=1e-2, epochs=5,
                     held=600, spikes=(150, 320, 470), spike=5.0)


def text_corpus(n, seed):
    """``n`` documents of the smoke's corpus (``TEXT_CORPUS``) as (ids (n,
    500) int32, labels (n,) int32)."""
    cfg, length = TEXT_CORPUS, TEXT_CONFIG["sequence_length"]
    rs = np.random.RandomState(seed)
    y = rs.randint(0, TEXT_CONFIG["class_num"], n).astype(np.int32)
    lens = rs.randint(cfg["min_len"], cfg["max_len"] + 1, n)
    p = 1.0 / np.arange(1, cfg["common"] + 1)
    words = rs.choice(cfg["common"], size=(n, length), p=p / p.sum()) + 1
    theme = (cfg["common"] + 1 + y[:, None] * cfg["theme_words"]
             + rs.randint(0, cfg["theme_words"], (n, length)))
    words = np.where(rs.rand(n, length) < cfg["theme_share"], theme, words)
    keep = np.arange(length)[None, :] >= length - lens[:, None]
    return np.where(keep, words, 0).astype(np.int32), y


def text_model(encoder, init=None):
    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.models import TextClassifier
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    reset_name_scope()
    m = TextClassifier(encoder=encoder, device="cuda", **TEXT_CONFIG)
    if init is not None:
        load_jax_params(m.model, init)
    return m


def text_training(torch, eb, x, y, card):
    """The CNN TextClassifier at full width: a timed graphed bf16 run
    that must lower its loss and reach the held-out accuracy floor, then a
    graphed and an eager run of two epochs from one init, held together.
    Returns the line's numbers and the trained weights."""
    from analytics_zoo_tpu_torch.convert import export_params

    held = TEXT_CORPUS["held"]
    dev = [torch.from_numpy(x[held:]).cuda()]
    yd = torch.from_numpy(y[held:]).cuda()
    init = export_params(text_model("cnn").model)
    cfg = TEXT_TRAIN
    m, timed, trained = fit_leg(torch, eb, text_model("cnn", init), cfg,
                                TEXT_LOSS, ["accuracy"], dev, yd,
                                cfg["epochs"], True, timed=cfg["timed"])
    res = m.evaluate(x[:held], y[:held], batch_size=cfg["batch"])
    short = TEXT_GRAPHED_STEPS * cfg["batch"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:  # the same 24 steps with cuDNN's deterministic convolutions
        same_bits = graphed_vs_eager(torch, eb, init, cfg, [dev[0][:short]],
                                     yd[:short], 1, None)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    compare = {
        "f32_24_steps": graphed_vs_eager(torch, eb, init, cfg,
                                         [dev[0][:short]], yd[:short], 1,
                                         None),
        "f32_24_steps_cudnn_deterministic": same_bits,
        "f32_2_epochs": graphed_vs_eager(torch, eb, init, cfg, dev, yd, 2,
                                         None),
        "bf16_2_epochs": graphed_vs_eager(torch, eb, init, cfg, dev, yd, 2,
                                          "bfloat16"),
        "tolerance_l2_rel_24_steps": TEXT_GRAPHED_REL,
        "tolerance_last_epoch_loss_rel": TEXT_GRAPHED_LOSS_REL}
    losses = timed["epoch_loss"]
    out = {"card": card, "config": TEXT_CONFIG, "corpus": TEXT_CORPUS,
           "train": cfg,
           "parameters": sum(p.numel() for p in m.model.parameters()),
           "timed": timed, "held_out_accuracy": res["accuracy"],
           "held_out_loss": res["loss"], "accuracy_floor": cfg["floor"],
           "graphed_vs_eager": compare}
    log("text_training", json.dumps(out))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"text: the loss did not fall: {losses}")
    if not res["accuracy"] >= cfg["floor"]:
        raise AssertionError(f"text: held-out accuracy {res['accuracy']} "
                             f"< {cfg['floor']}")
    drift = [abs(p["graphed_epoch_loss"][-1] / p["eager_epoch_loss"][-1]
                 - 1.0) for k, p in compare.items() if k.endswith("epochs")]
    if (compare["f32_24_steps"]["params_l2_rel"] > TEXT_GRAPHED_REL
            or max(drift) > TEXT_GRAPHED_LOSS_REL
            or not same_bits["bit_equal"]):
        raise AssertionError(f"text: graphed left the eager run: {compare}")
    if not timed["programs"] or not all(timed["launches"].values()):
        raise AssertionError(f"text: no captured step program, or a bag "
                             f"kernel never launched: {timed}")
    del m, dev, yd
    free_card(torch)
    return out, trained


def graphed_vs_eager(torch, eb, init, cfg, xs, y, epochs, dtype):
    """The CNN classifier from ``init`` trained ``epochs`` epochs graphed
    and again eagerly at ``compute_dtype`` ``dtype``: the L2 distance of
    the two runs' parameters over the graphed run's movement, and both
    runs' epoch losses."""
    _, graphed, gp = fit_leg(torch, eb, text_model("cnn", init), cfg,
                             TEXT_LOSS, None, xs, y, epochs, True,
                             compute_dtype=dtype)
    _, eager, ep = fit_leg(torch, eb, text_model("cnn", init), cfg,
                           TEXT_LOSS, None, xs, y, epochs, False,
                           compute_dtype=dtype)
    return {"steps": epochs * int(xs[0].shape[0]) // cfg["batch"],
            "params_l2_rel": l2(gp, ep) / max(l2(gp, init), 1e-30),
            "params_max_abs_diff": tree_diff(gp, ep)[0],
            "bit_equal": tree_diff(gp, ep)[1],
            "graphed_epoch_loss": graphed["epoch_loss"],
            "eager_epoch_loss": eager["epoch_loss"]}


def text_rnn_training(torch, eb, encoder, x, y, card):
    """The LSTM or GRU TextClassifier at the same widths over T = 500:
    graphed bf16 epochs on ``TEXT_RNN_TRAIN["rows"]`` rows, the last
    timed; the capture's seconds and the card's memory; then one eager
    step under ``torch.profiler`` for its kernels and device time."""
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.core import graphs

    cfg = TEXT_RNN_TRAIN
    held, n = TEXT_CORPUS["held"], cfg["rows"]
    dev = [torch.from_numpy(x[held:held + n]).cuda()]
    yd = torch.from_numpy(y[held:held + n]).cuda()
    torch.cuda.reset_peak_memory_stats()
    m, timed, trained = fit_leg(torch, eb, text_model(encoder), cfg,
                                TEXT_LOSS, None, dev, yd, cfg["epochs"],
                                True, timed=cfg["timed"],
                                profile_epoch=False)
    memory = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}
    b = cfg["batch"]
    # the card's activity only: a step's 30,000-odd host ops would take
    # the profiler longer to gather than the whole leg
    with graphs.disabled(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        m.fit(dev[0][:b], yd[:b], batch_size=b, epochs=cfg["epochs"] + 1,
              verbose=False)
        torch.cuda.synchronize()
    eager_step = step_profile(torch, prof, 1)
    losses = timed["epoch_loss"]
    out = {"card": card, "encoder": encoder, "train": cfg,
           "parameters": sum(p.numel() for p in m.model.parameters()),
           "timed": timed, "memory": memory,
           "eager_step_profile": eager_step}
    log(f"text_{encoder}_training", json.dumps(out))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"text {encoder}: the loss did not fall: "
                             f"{losses}")
    if not timed["programs"] or not all(timed["launches"].values()):
        raise AssertionError(f"text {encoder}: no captured step program, "
                             f"or a bag kernel never launched: {timed}")
    del m, dev, yd
    free_card(torch)
    return out, trained


def text_serving(torch, eb, dq, encoder, trained, root, card):
    """The trained classifier served in f32, int8 and int4 from bucket
    graphs (``TEXT_BUCKETS``) of a model warmed from a ``CompileCache``
    that a first model filled: 256 one-row requests of held-out
    documents from 8 threads through ``DynamicBatcher``, against the
    plain f32 forward on the card (the dequantized tree for int8 /
    int4); the kernels' counts zeroed just before and read just after.
    Returns the numbers, the launches and, for the CNN, the int8 serving
    model."""
    import os

    from analytics_zoo_tpu_torch.deploy import CompileCache, DynamicBatcher
    from analytics_zoo_tpu_torch.deploy.inference import (dequantize_pytree,
                                                          quantize_pytree)

    m = text_model(encoder, trained)
    n = 256
    xs = [text_corpus(n, SEED + 21)[0]]
    plain = rec_reference(torch, m.model, xs)
    out, keep = {}, None
    total = {"embedding_bag_fwd": 0, "dequant_matmul": 0}
    for wd in ("float32", "int8", "int4"):
        want = plain
        if wd != "float32":
            want = rec_reference(torch, m.model, xs, dequantize_pytree(
                quantize_pytree(m.model.params(),
                                bits=4 if wd == "int4" else 8)))
        cache = CompileCache(os.path.join(root, f"text_{encoder}_{wd}"))
        cover = m.inference_model(weight_dtype=wd, batch_buckets=TEXT_BUCKETS,
                                  name=f"text_{encoder}_{wd}")
        cover.attach_compile_cache(cache)
        t0 = time.perf_counter()
        for b in TEXT_BUCKETS:
            for _ in range(2):          # eager, then captured
                cover.predict([a[:b] for a in xs])
        torch.cuda.synchronize()
        cover_s = time.perf_counter() - t0
        im = m.inference_model(weight_dtype=wd, batch_buckets=TEXT_BUCKETS,
                               name=f"text_{encoder}_{wd}")
        im.attach_compile_cache(cache)
        t0 = time.perf_counter()
        warmed = im.warm()
        warm_s = time.perf_counter() - t0
        eb.LAUNCHES.reset()
        dq.LAUNCHES.reset()
        batcher = DynamicBatcher(im, max_batch=64, max_latency_ms=2.0)
        t0 = time.perf_counter()
        try:
            got, lat = serve_requests(
                batcher, [[a[r:r + 1] for a in xs] for r in range(n)], 8)
        finally:
            batcher.close()
        wall = time.perf_counter() - t0
        launches = {"embedding_bag_fwd": eb.LAUNCHES.value,
                    "dequant_matmul": dq.LAUNCHES.value}
        for k in total:
            total[k] += launches[k]
        row_top = np.abs(want).max(-1, keepdims=True)
        err = float((np.abs(got - want) / row_top).max())
        r = {"card": card, "p50_ms": float(np.percentile(lat, 50)),
             "p99_ms": float(np.percentile(lat, 99)),
             "rows": n, "wall_s": wall, "rows_per_s": n / wall,
             "compile_count": im.compile_count, "warmed": warmed,
             "warm_s": warm_s, "captured_cold": cover.compile_count,
             "cover_s": cover_s, "launches": launches,
             "max_err_rel_row_top": err, "tolerance": TEXT_SERVE_REL,
             "top1_agreement": float(np.mean(got.argmax(-1)
                                             == want.argmax(-1))),
             "weight_bytes": im.weight_nbytes(),
             "programs": programs_of(im._programs)}
        out[wd] = r
        log(f"text_{encoder}_serving", wd, json.dumps(r))
        if (im.compile_count != 0 or warmed != len(TEXT_BUCKETS)
                or got.shape != want.shape or not np.all(np.isfinite(got))
                or err > TEXT_SERVE_REL or not launches["embedding_bag_fwd"]
                or bool(launches["dequant_matmul"]) != (wd != "float32")):
            raise AssertionError(f"text {encoder} serving ({wd}) failed: "
                                 f"{r}")
        if encoder == "cnn" and wd == "int8":
            keep = im
        del cover, im
        free_card(torch)
    return out, total, keep


def text_cluster_serving(torch, eb, dq, im, card):
    """The int8 CNN classifier (warmed, ``compile_count`` 0) behind one
    ``ClusterServing`` worker over a ``ShmQueue``, as
    examples/textclassification/streaming_text_example.py serves it, with
    int32 id records of 500 tokens from a client thread of this process;
    every record's top-2 held against the plain path's logits
    (``cluster_check``)."""
    from analytics_zoo_tpu_torch.deploy import (ClusterServing, InputQueue,
                                                OutputQueue, ServingConfig,
                                                ShmQueue)
    from analytics_zoo_tpu_torch.observe.metrics import METRICS
    from analytics_zoo_tpu_torch.ops import dispatch

    n = 512
    recs = text_corpus(n, SEED + 23)[0]
    with dispatch.forced("reference"):
        ref = np.concatenate([im.predict(recs[s:s + 128])
                              for s in range(0, n, 128)])
    queue = ShmQueue(name="smoke_text", slots=1024, slot_bytes=1 << 12,
                     result_slots=1024, result_slot_bytes=1 << 10)
    cfg = ServingConfig(postprocess_top_n=CLUSTER_TOP_N, batch_size=128,
                        max_batch_delay_ms=2.0, decode_workers=4)
    cs = ClusterServing({"text": im}, queue, cfg)
    iq, oq = InputQueue(queue), OutputQueue(queue)
    answers = {}
    try:
        cs.start()
        window = METRICS.snapshot()
        eb.LAUNCHES.reset()
        dq.LAUNCHES.reset()
        t0 = time.perf_counter()
        pusher = threading.Thread(target=lambda: [
            iq.enqueue(uri=f"text{r}", model="text", x=recs[r])
            for r in range(n)])
        pusher.start()
        deadline = time.monotonic() + 120
        while len(answers) < n and time.monotonic() < deadline:
            answers.update(oq.dequeue(timeout=0.5))
        wall = time.perf_counter() - t0
        pusher.join(timeout=60)
        torch.cuda.synchronize()
        launches = {"embedding_bag_fwd": eb.LAUNCHES.value,
                    "dequant_matmul": dq.LAUNCHES.value}
        delta = METRICS.delta(window)
    finally:
        cs.stop(timeout=30)
        del cs
        queue.stop()
    idx = np.full((n, CLUSTER_TOP_N), -1, np.int64)
    val = np.full((n, CLUSTER_TOP_N), np.nan, np.float64)
    for r in range(n):
        a = answers.get(f"text{r}")
        if isinstance(a, list) and len(a) == CLUSTER_TOP_N:
            idx[r] = [p[0] for p in a]
            val[r] = [p[1] for p in a]
    check = cluster_check("text", idx, val, ref)
    out = {"card": card, "records": n, "answered": len(answers),
           "wall_s": wall, "records_per_s": n / wall, "check": check,
           "launches": launches, "compile_count": im.compile_count,
           "stages": stage_rollup(delta).get("text"),
           "device_busy": device_busy(delta, wall)}
    log("text_cluster_serving", json.dumps(out))
    if len(answers) != n or not check["ok"] or not all(launches.values()):
        raise AssertionError(f"text ClusterServing failed: {out}")
    return launches


def knrm_lists(queries, seed):
    """``queries`` held-out query ids (queries, 10) with ``candidates``
    answers each: the first relevant (``matches`` of its 40 tokens are
    the query's words), the rest random.  Returns (q rows, doc rows,
    query ids, labels)."""
    cfg, kc = KNRM_TRAIN, KNRM_CONFIG
    rs = np.random.RandomState(seed)
    vocab = kc["max_words_num"]
    q = rs.randint(1, vocab + 1, (queries, kc["text1_length"]))
    c = cfg["candidates"]
    docs = rs.randint(1, vocab + 1, (queries, c, kc["text2_length"]))
    for r in range(queries):
        at = rs.choice(kc["text2_length"], cfg["matches"], replace=False)
        docs[r, 0, at] = rs.choice(q[r], cfg["matches"])
    qrows = np.repeat(q, c, axis=0).astype(np.int32)
    labels = np.tile(np.eye(1, c, dtype=np.int64)[0], queries)
    return (qrows, docs.reshape(queries * c, -1).astype(np.int32),
            np.repeat(np.arange(queries), c), labels)


def knrm_pairs(pairs, seed):
    """Training rows: each query with its relevant answer, then a random
    one (rank_hinge's interleaved (pos, neg) rows)."""
    q, d, _, _ = knrm_lists(pairs, seed)
    c = KNRM_TRAIN["candidates"]
    pick = np.stack([np.arange(pairs) * c, np.arange(pairs) * c + 1],
                    1).reshape(-1)
    return [q[pick], d[pick]], np.zeros((2 * pairs, 1), np.float32)


def knrm_phase(torch, eb, card):
    """KNRM trained with rank_hinge (graphed, f32), ranked by ``Ranker``
    on held-out candidate lists, and ``evaluate`` on an odd row count
    against the masked rule (a pair counts when both its rows are in
    one batch) computed from the served scores."""
    from analytics_zoo_tpu_torch.models import KNRM, Ranker
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    cfg = KNRM_TRAIN
    xs, y = knrm_pairs(cfg["pairs"], SEED + 31)
    dev = [torch.from_numpy(a).cuda() for a in xs]
    reset_name_scope()
    m, timed, _ = fit_leg(torch, eb, KNRM(device="cuda", **KNRM_CONFIG),
                          cfg, "rank_hinge", None, dev,
                          torch.from_numpy(y).cuda(), cfg["epochs"], True,
                          timed=1, compute_dtype=None)
    q, d, qid, labels = knrm_lists(cfg["queries"], SEED + 32)
    scores = m.predict([q, d], batch_size=cfg["batch"])[:, 0]
    ndcg = Ranker.evaluate_ndcg(qid, labels, scores, k=cfg["ndcg_k"])
    mean_ap = Ranker.evaluate_map(qid, labels, scores)
    oq, od = [a[:cfg["odd_rows"]] for a in knrm_pairs(cfg["odd_rows"] // 2 + 1,
                                                       SEED + 33)[0]]
    s = m.predict([oq, od], batch_size=cfg["batch"])[:, 0].astype(np.float64)
    full = 2 * (len(s) // 2)
    want = float(np.mean(np.maximum(1.0 - s[0:full:2] + s[1:full:2], 0.0)))
    got = m.evaluate([oq, od], np.zeros((len(s), 1), np.float32),
                     batch_size=cfg["batch"])["loss"]
    losses = timed["epoch_loss"]
    out = {"card": card, "config": KNRM_CONFIG, "train": cfg,
           "timed": timed, "ndcg@3": ndcg, "map": mean_ap,
           "floor": cfg["floor"],
           "odd_evaluate": {"rows": len(s), "loss": got,
                            "masked_rule": want}}
    log("knrm", json.dumps(out))
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"knrm: the loss did not fall: {losses}")
    if not (ndcg >= cfg["floor"] and mean_ap >= cfg["floor"]):
        raise AssertionError(f"knrm: NDCG@3 {ndcg} / MAP {mean_ap} below "
                             f"{cfg['floor']}")
    if not abs(got - want) <= 1e-5 * max(abs(want), 1e-3):
        raise AssertionError(f"knrm: evaluate on {len(s)} rows gave {got}, "
                             f"the masked rule {want}")
    if not all(timed["launches"].values()):
        raise AssertionError(f"knrm: a bag kernel never launched: {timed}")
    del m, dev
    free_card(torch)
    return timed["launches"]


def seq2seq_phase(torch, eb, dq, card):
    """Seq2seq trained teacher-forced on the copy task (graphed, f32),
    then greedy and beam-search decoding from graphs against the same
    decoders on the plain versions on the card (equal tokens, scores
    within ``SEQ2SEQ_SCORE_TOL``), and greedy decoding from int8 weights
    (kernel 3 at every step)."""
    from analytics_zoo_tpu_torch.models import Seq2seq
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.ops import dispatch

    cfg = SEQ2SEQ_TRAIN
    rs = np.random.RandomState(SEED + 41)
    src = rs.randint(2, SEQ2SEQ_CONFIG["vocab_size"],
                     (cfg["rows"], cfg["length"])).astype(np.int32)
    dec = np.concatenate([np.ones((cfg["rows"], 1), np.int32),
                          src[:, :-1]], axis=1)
    reset_name_scope()
    m, timed, _ = fit_leg(torch, eb, Seq2seq(device="cuda", **SEQ2SEQ_CONFIG),
                          cfg, TEXT_LOSS, None,
                          [torch.from_numpy(a).cuda() for a in (src, dec)],
                          torch.from_numpy(src).cuda(), cfg["epochs"], True,
                          timed=1, compute_dtype=None)
    enc = src[:cfg["decode_rows"]]
    greedy_kw = dict(start_sign=1, max_seq_len=cfg["max_seq_len"],
                     stop_sign=cfg["stop_sign"])
    beam_kw = dict(greedy_kw, beam_size=cfg["beam"],
                   length_penalty=cfg["length_penalty"])
    out = {"card": card, "config": SEQ2SEQ_CONFIG, "train": cfg,
           "timed": timed}
    eb.LAUNCHES.reset()
    dq.LAUNCHES.reset()
    t0 = time.perf_counter()
    for _ in range(3):              # eager, captured, replayed
        toks = m.infer(enc, **greedy_kw)
        seq, sc = m.infer_beam(enc, **beam_kw)
    torch.cuda.synchronize()
    out["decode_s_3_calls_each"] = time.perf_counter() - t0
    out["decode_launches_f32"] = {"embedding_bag_fwd": eb.LAUNCHES.value,
                                  "dequant_matmul": dq.LAUNCHES.value}
    with dispatch.forced("reference"):
        p_toks = m.infer(enc, **greedy_kw)
        p_seq, p_sc = m.infer_beam(enc, **beam_kw)
    captured = [k for k, p in m._decoders.items() if p.graph.captured]
    out.update({
        "decoders_captured": len(captured),
        "greedy_equal": bool(np.array_equal(toks, p_toks)),
        "beam_equal": bool(np.array_equal(seq, p_seq)),
        "beam_score_max_abs_diff": float(np.abs(sc - p_sc).max()),
        "score_tolerance": SEQ2SEQ_SCORE_TOL,
        "copied_share_greedy": float(np.mean(
            toks[:, :cfg["length"]] == enc))})
    im8 = m.inference_model(weight_dtype="int8")
    eb.LAUNCHES.reset()
    dq.LAUNCHES.reset()
    for _ in range(3):
        q_toks = m.infer(enc, **greedy_kw)
    torch.cuda.synchronize()
    out["decode_launches_int8"] = {"embedding_bag_fwd": eb.LAUNCHES.value,
                                   "dequant_matmul": dq.LAUNCHES.value}
    with dispatch.forced("reference"):
        q_plain = m.infer(enc, **greedy_kw)
    out["int8_greedy_agreement_with_plain"] = float(np.mean(q_toks
                                                            == q_plain))
    out["int8_greedy_agreement_with_f32"] = float(np.mean(q_toks == toks))
    out["int8_weight_bytes"] = im8.weight_nbytes()
    log("seq2seq", json.dumps(out))
    losses = timed["epoch_loss"]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"seq2seq: the loss did not fall: {losses}")
    if not (out["greedy_equal"] and out["beam_equal"]
            and out["beam_score_max_abs_diff"] <= SEQ2SEQ_SCORE_TOL
            and len(captured) == 2):
        raise AssertionError(f"seq2seq: graphed decoding left the plain "
                             f"versions: {out}")
    if not (all(timed["launches"].values())
            and out["decode_launches_f32"]["embedding_bag_fwd"]
            and out["decode_launches_int8"]["dequant_matmul"]):
        raise AssertionError(f"seq2seq: a kernel never launched: {out}")
    launches = {"training": timed["launches"],
                "decode": {k: out["decode_launches_f32"][k]
                           + out["decode_launches_int8"][k]
                           for k in out["decode_launches_f32"]}}
    del m
    free_card(torch)
    return launches


def anomaly_phase(torch, eb, card):
    """AnomalyDetector trained on a sine series (graphed, f32, mse), then
    ``detect_anomalies`` over the windows of a held-out continuation with
    spikes: the ``len(spikes)`` largest errors are the spikes' windows."""
    from analytics_zoo_tpu_torch.models import AnomalyDetector
    from analytics_zoo_tpu_torch.models.anomalydetection import unroll
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    cfg = ANOMALY_TRAIN
    length = ANOMALY_CONFIG["feature_shape"][0]
    series = np.sin(np.arange(cfg["points"], dtype=np.float32) * 0.1)
    x, y = unroll(series, length)
    n = (len(x) // cfg["batch"]) * cfg["batch"]
    reset_name_scope()
    m, timed, _ = fit_leg(torch, eb, AnomalyDetector(device="cuda",
                                                     **ANOMALY_CONFIG),
                          cfg, "mse", None, [torch.from_numpy(x[:n]).cuda()],
                          torch.from_numpy(y[:n]).cuda(), cfg["epochs"],
                          True, timed=1, compute_dtype=None,
                          profile_epoch=False)
    held = np.sin((np.arange(cfg["held"], dtype=np.float32)
                   + cfg["points"]) * 0.1)
    held[list(cfg["spikes"])] = cfg["spike"]
    hx, hy = unroll(held, length)
    pred = m.predict(hx, batch_size=cfg["batch"])[:, 0]
    flagged = sorted(int(i) for i in m.detect_anomalies(
        hy, pred, anomaly_size=len(cfg["spikes"])))
    want = [p - length for p in cfg["spikes"]]
    err = np.abs(hy - pred)
    out = {"card": card, "config": ANOMALY_CONFIG, "train": cfg,
           "timed": timed, "flagged": flagged, "spike_windows": want,
           "spike_errors": [float(err[i]) for i in want],
           "largest_other_error": float(np.delete(err, want).max())}
    log("anomaly", json.dumps(out))
    losses = timed["epoch_loss"]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"anomaly: the loss did not fall: {losses}")
    if flagged != want:
        raise AssertionError(f"anomaly: flagged {flagged}, the spikes' "
                             f"windows are {want}")
    del m
    free_card(torch)


def text_kernel_cases(torch, eb, dq):
    """Kernels 1-3 at the text slice's shapes: the TextClassifier's
    gather of 128 x 500 front-padded ids from its (5001, 200) table (f32,
    and bf16 as the bf16 step casts it); its backward, the same 64,000
    contributions, front-padded (every pad position adds into row 0) and
    Zipf s = 1.0 without padding; the dequantize-matmul at ``tc_fc`` (K =
    256, N = 128), ``tc_out`` (128, 20) and the Seq2seq generator (128,
    5001) at M = 1, 8, 64, 128, int8 and int4."""
    ids = torch.from_numpy(text_corpus(128, SEED + 51)[0]).reshape(
        -1, 1).cuda()
    vocab, dim = TEXT_CONFIG["max_words_num"] + 1, TEXT_CONFIG[
        "token_length"]
    bag, bwd, dqc = [], [], []
    for dtype in (torch.float32, torch.bfloat16):
        bag.append(bag_case(torch, eb, "text_embed", vocab, dim, len(ids), 1,
                            "sum", None, dtype=dtype, ids=ids))
    bwd.append(bag_bwd_case(torch, eb, "text_embed_front_padded", vocab,
                            dim, len(ids), 1, "sum", None, ids=ids))
    bwd.append(bag_bwd_case(torch, eb, "text_embed_zipf", vocab, dim,
                            len(ids), 1, "sum", None, zipf=True))
    for label, k, n in (("tc_fc", 256, 128), ("tc_out", 128, 20),
                        ("seq2seq_generator", 128, 5001)):
        for bits in (8, 4):
            for m in TEXT_BUCKETS:
                dqc.append(dq_case(torch, dq, label, m, k, n, bits,
                                   iters=100))
    for c in bag + bwd + dqc:
        log("kernel_case", json.dumps(c))
    return bag, bwd, dqc


def text_phase(torch, eb, dq, card):
    """Phase 12: TextClassifier at full width trained (CNN; LSTM and GRU
    at T = 500) and served in three weight forms, the int8 CNN behind
    ClusterServing; KNRM; Seq2seq with greedy and beam decoding;
    AnomalyDetector.  Returns each path's kernel launches."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="zoo_text_")
    paths, summary, seconds = {}, {"card": card}, {}

    def timed_leg(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        return out

    try:
        x, y = text_corpus(TEXT_CORPUS["docs"], SEED + 17)
        training, trained = timed_leg("cnn_training", text_training, torch,
                                      eb, x, y, card)
        paths["text_training"] = training["timed"]["launches"]
        weights = {"cnn": trained}
        for enc in ("lstm", "gru"):
            rnn, weights[enc] = timed_leg(f"{enc}_training",
                                          text_rnn_training, torch, eb, enc,
                                          x, y, card)
            paths[f"text_{enc}_training"] = rnn["timed"]["launches"]
            summary[f"{enc}_ms_per_step_wall"] = rnn["timed"][
                "ms_per_step_wall"]
            summary[f"{enc}_kernels_per_step"] = rnn["eager_step_profile"][
                "kernels_per_step"]
        del x, y
        int8_cnn = None
        for enc in ("cnn", "lstm", "gru"):
            serving, served, im = timed_leg(f"{enc}_serving", text_serving,
                                            torch, eb, dq, enc, weights[enc],
                                            root, card)
            paths[f"text_{enc}_serving"] = served
            int8_cnn = im or int8_cnn
            summary[f"{enc}_served_p50_ms"] = {k: v["p50_ms"]
                                              for k, v in serving.items()}
        paths["text_cluster_serving"] = timed_leg(
            "cluster_serving", text_cluster_serving, torch, eb, dq, int8_cnn,
            card)
        del int8_cnn
        free_card(torch)
        paths["knrm_training"] = timed_leg("knrm", knrm_phase, torch, eb,
                                           card)
        s2s = timed_leg("seq2seq", seq2seq_phase, torch, eb, dq, card)
        paths["seq2seq_training"] = s2s["training"]
        paths["seq2seq_decode"] = s2s["decode"]
        timed_leg("anomaly", anomaly_phase, torch, eb, card)
        summary.update({
            "text_samples_per_s": training["timed"]["samples_per_s"],
            "text_ms_per_step_device": training["timed"][
                "ms_per_step_device"],
            "text_device_busy_share": training["timed"][
                "device_busy_share"],
            "text_held_out_accuracy": training["held_out_accuracy"],
            "text_graphed_vs_eager_l2_rel": {
                k: v["params_l2_rel"] for k, v in training[
                    "graphed_vs_eager"].items() if isinstance(v, dict)}})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["seconds_by_leg"] = seconds
    summary["seconds"] = time.perf_counter() - t0
    log("text_summary", json.dumps(summary))
    return paths


# ---------------------------------------------------------------------------
# loadgen phase (open-loop load through ClusterServing)


# Phase 13's legs: the JAX legs' p99 SLOs (loadgen/harness.py:113, :151),
# NCF : BERT = 64 : 1 by record (phase 9's 4,096 : 64), NCF (user, item)
# pairs Zipf s = 1.0 over the ids both tables hold (0 ... ITEMS), rates
# as fractions of phase 9's ShmQueue records/s (R)
LOADGEN_LEGS = {
    "steady": dict(shape="steady", qps_r=0.5, duration_s=8.0, seed=41,
                   slo_ms=250.0),
    "burst": dict(shape="burst", base_r=0.25, burst_r=1.5, at_s=3.0,
                  dur_s=2.0, duration_s=12.0, seed=43, slo_ms=400.0)}
LOADGEN_ZIPF_S = 1.0
LOADGEN_WEIGHTS = {"ncf": 64.0, "bert": 1.0}
# the offered load is split over this many client processes, each a
# Poisson stream at 1/N of the rate from a seed of its own (their sum is
# the leg's Poisson stream), started at one instant: one Python client
# cannot send 1.5 R on schedule
LOADGEN_CLIENTS = 4
# the client's open-loop push: a full ring refuses within this, counted
# as an open-loop drop, and the schedule moves on
LOADGEN_PUSH_TIMEOUT_S = 0.2
# part (b): default_report(quick=True)'s kill and mix-shift legs, the two
# its checks read, held to what the JAX soak holds
# (tests/test_loadgen_soak.py:87-116); the kill leg's drain ends 5 s
# after the last send (60 s by default), where a lost record would hold
# it to the end: the successor is up within seconds of the kill, and
# the storm runs 7.5 s past it
KILL_LEG = dict(duration_s=11.0, kill_at_s=3.5, device="cuda",
                drain_timeout_s=5.0)
MIX_SHIFT_LEG = dict(duration_s=8.0, shift_at_s=3.0)
KILL_RECOVERY_S, KILL_LOST = 10.0, 32


def loadgen_mix():
    from analytics_zoo_tpu_torch.loadgen.payloads import (PayloadClass,
                                                          PayloadMix,
                                                          ZipfianIdPayload)

    return PayloadMix([
        ZipfianIdPayload("ncf", (2,), vocab=ITEMS + 1, s=LOADGEN_ZIPF_S,
                         weight=LOADGEN_WEIGHTS["ncf"], field="x"),
        PayloadClass("bert", (CLUSTER_L,), dtype="int32",
                     weight=LOADGEN_WEIGHTS["bert"], field="ids",
                     high=BERT_BASE["vocab"])])


def loadgen_schedule(spec):
    from analytics_zoo_tpu_torch.loadgen.arrivals import (FlashCrowd,
                                                          Steady,
                                                          arrival_times)

    shape = (Steady(spec["qps"]) if spec["shape"] == "steady" else
             FlashCrowd(spec["base_qps"], spec["burst_qps"], spec["at_s"],
                        spec["dur_s"]))
    return arrival_times(shape, spec["duration_s"], spec["seed"])


def loadgen_payloads(spec):
    """Every arrival's (model, payload) by uri, drawn as the client's
    sender draws them: one generator from the client's seed, one mix draw
    per slot in schedule order (``OpenLoopClient._send_loop``)."""
    mix, sched = loadgen_mix(), loadgen_schedule(spec)
    rng = np.random.Generator(np.random.PCG64(int(spec["seed"])))
    out = {}
    for i, off in enumerate(sched):
        cls, payload = mix.draw(rng, t=float(off))
        out[f"{spec['prefix']}-{i:06d}"] = (cls.model, payload)
    return out


class KeptAnswers:
    """The client's OutputQueue, keeping every answer it reads."""

    def __init__(self, outq):
        self.outq, self.queue, self.answers = outq, outq.queue, {}

    def query(self, uri, timeout=10.0):
        val = self.outq.query(uri, timeout=timeout)
        self.answers[uri] = val
        return val


def loadgen_client(segment, out_path, spec_json):
    """A client process (``chip_smoke.py --loadgen-client SEGMENT OUT
    SPEC``): an ``OpenLoopClient`` on its schedule and the mix over the
    worker's ShmQueue, attached by name.  It writes ``OUT.ready``, waits
    for the go file to name the instant (``time.monotonic``, one clock
    for every process of the host) its schedule starts at, runs, and
    writes every record's timeline and answer to ``OUT`` (JSON); prints
    one JSON line.  It never touches CUDA."""
    import torch

    from analytics_zoo_tpu_torch.deploy import (InputQueue, OutputQueue,
                                                ShmQueue)
    from analytics_zoo_tpu_torch.loadgen import OpenLoopClient

    spec = json.loads(spec_json)
    q = ShmQueue.attach(segment, push_timeout_s=LOADGEN_PUSH_TIMEOUT_S)
    kept = KeptAnswers(OutputQueue(q))
    client = OpenLoopClient(InputQueue(q), kept, loadgen_schedule(spec),
                            loadgen_mix(), leg=spec["leg"], seed=spec["seed"],
                            uri_prefix=spec["prefix"], query_timeout_s=5.0)
    open(out_path + ".ready", "w").close()
    deadline = time.monotonic() + 300
    while not os.path.exists(spec["go_file"]):
        if time.monotonic() > deadline:
            raise TimeoutError("no go file")
        time.sleep(0.002)
    with open(spec["go_file"]) as f:
        start_at = float(f.read())
    time.sleep(max(0.0, start_at - time.monotonic()))
    late_ms = (time.monotonic() - start_at) * 1e3
    t0 = time.perf_counter()
    records = client.run(drain_timeout_s=60.0)
    wall = time.perf_counter() - t0
    q.stop()
    with open(out_path, "w") as f:
        json.dump({"records": [r.as_dict() for r in records],
                   "answers": kept.answers}, f)
    print(json.dumps({"prefix": spec["prefix"], "records": len(records),
                      "answered": len(kept.answers), "wall_s": wall,
                      "start_late_ms": late_ms,
                      "open_loop_drops": client.open_loop_drops,
                      "cuda_initialized": torch.cuda.is_initialized()}))
    return 0


def loadgen_check(torch, models, specs, answers, outcomes):
    """Every answered record's top-2 against the plain scores of its
    payload (``cluster_check``: phase 9's tolerances)."""
    from analytics_zoo_tpu_torch.ops import dispatch

    payloads = {}
    for spec in specs:
        payloads.update(loadgen_payloads(spec))
    checks = {}
    for name in models:
        uris = [u for u, (m, _) in payloads.items()
                if m == name and outcomes.get(u) == "ok"]
        if not uris:
            checks[name] = {"rows": 0, "ok": False}
            continue
        xs = np.stack([payloads[u][1] for u in uris])
        with dispatch.forced("reference"):
            ref = np.concatenate([models[name].predict(xs[s:s + 256])
                                  for s in range(0, len(xs), 256)])
        idx = np.asarray([[p[0] for p in answers[u]] for u in uris])
        val = np.asarray([[p[1] for p in answers[u]] for u in uris],
                         np.float64)
        checks[name] = cluster_check(name, idx, val, ref)
    return checks


def loadgen_clients(queue, root, leg, specs):
    """Start one client process per spec, wait until each is ready, name
    one start instant for all; returns their (returncode, stdout,
    stderr), their output files and the seconds they took to be ready."""
    outs = [os.path.join(root, f"loadgen_{s['prefix']}.json") for s in specs]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--loadgen-client",
         queue.segment, out, json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for out, spec in zip(outs, specs)]
    t0 = time.perf_counter()
    try:
        deadline = time.monotonic() + 120
        while not all(os.path.exists(o + ".ready") for o in outs):
            if (time.monotonic() > deadline
                    or any(p.poll() is not None for p in procs)):
                raise AssertionError(f"loadgen {leg}: a client did not "
                                     f"start")
            time.sleep(0.01)
        start_s = time.perf_counter() - t0
        go = specs[0]["go_file"]
        with open(go + ".tmp", "w") as f:
            f.write(repr(time.monotonic() + 0.5))
        os.replace(go + ".tmp", go)
        res = [p.communicate(timeout=specs[0]["duration_s"] + 180)
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return ([(p.returncode, o, e) for p, (o, e) in zip(procs, res)], outs,
            start_s)


def loadgen_leg(torch, eb, dq, fa, models, cache_dir, root, leg, spec):
    """One leg: a fresh ShmQueue and ClusterServing (warm from the cache)
    with the leg's SLO, the client processes on the schedule, the fold."""
    import gc

    from analytics_zoo_tpu_torch.deploy import ClusterServing, ServingConfig
    from analytics_zoo_tpu_torch.loadgen import slo
    from analytics_zoo_tpu_torch.loadgen.client import RequestRecord
    from analytics_zoo_tpu_torch.loadgen.harness import make_queue
    from analytics_zoo_tpu_torch.observe.metrics import METRICS

    n = LOADGEN_CLIENTS
    rates = ("qps",) if spec["shape"] == "steady" else ("base_qps",
                                                        "burst_qps")
    specs = [dict(spec, prefix=f"{leg}{i}", seed=spec["seed"] + 1000 * i,
                  go_file=os.path.join(root, f"go_{leg}"),
                  **{k: spec[k] / n for k in rates}) for i in range(n)]
    queue, wire = make_queue("shm", name=f"smoke_{leg}", slots=4096,
                             slot_bytes=1 << 12, result_slots=4096,
                             result_slot_bytes=1 << 10)
    slo_ms = {m: spec["slo_ms"] for m in models}
    cfg = ServingConfig(postprocess_top_n=CLUSTER_TOP_N, batch_size=256,
                        max_batch_delay_ms=2.0, decode_workers=4,
                        compile_cache_dir=cache_dir, supervise=True,
                        supervisor_interval_s=0.05, slo_p99_ms=slo_ms)
    t_leg = time.perf_counter()
    cs = ClusterServing(dict(models), queue, cfg)
    try:
        if wire != "shm":
            raise AssertionError(f"loadgen {leg}: the wire is {wire}, "
                                 f"not shm")
        cs.start()
        torch.cuda.synchronize()
        window = METRICS.snapshot()
        reset_counts(eb, dq, fa)
        t_clients = time.perf_counter()
        ran, outs, clients_start_s = loadgen_clients(queue, root, leg, specs)
        t_ran = time.perf_counter()
        torch.cuda.synchronize()
        launches = {"embedding_bag_fwd": eb.LAUNCHES.value,
                    "dequant_matmul": dq.LAUNCHES.value,
                    "flash_attention_fwd": fa.LAUNCHES.value}
        delta = METRICS.delta(window)
        health = cs.health()
    finally:
        cs.stop(timeout=30)
        del cs
        gc.collect()
        queue.stop()
    for rc, stdout, stderr in ran:
        if rc != 0:
            raise AssertionError(f"loadgen {leg}: a client failed (rc "
                                 f"{rc}): {stdout[-2000:]} {stderr[-3000:]}")
    clients = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in ran]
    records, answers = [], {}
    for path in outs:
        with open(path) as f:
            got = json.load(f)
        records += [RequestRecord(**d) for d in got["records"]]
        answers.update(got["answers"])
    records.sort(key=lambda r: r.t_sched)
    outcomes = {r.uri: r.outcome for r in records}
    t_check = time.perf_counter()
    checks = loadgen_check(torch, models, specs, answers, outcomes)
    wall_s = {"serving_start": t_clients - t_leg,
              "clients_start": clients_start_s,
              "schedule_and_drain": t_ran - t_clients - clients_start_s,
              "stop_and_collect": t_check - t_ran,
              "check": time.perf_counter() - t_check}
    busy = device_busy(delta, max(c["wall_s"] for c in clients))
    lags = [r.lag_s * 1e3 for r in records if r.lag_s is not None]
    by_model = {}
    for name in models:
        recs = [r for r in records if r.model == name]
        oks = [r.latency_s * 1e3 for r in recs
               if r.outcome == "ok" and r.latency_s is not None]
        windows = slo.fold_windows(recs, 1.0, spec["duration_s"])
        row = {"offered": len(recs),
               "outcomes": slo.outcome_counts(recs),
               "p50_ms": slo.percentile(oks, 50),
               "p99_ms": slo.percentile(oks, 99),
               "sustained_qps_at_slo": slo.sustained_qps_at_slo(
                   windows, {name: spec["slo_ms"]}),
               "shed_fraction": slo.shed_fraction_by_model(recs).get(
                   name, 0.0),
               "device_busy_share": busy["device_s_by_model"].get(
                   name, 0.0) / busy["wall_s"],
               "compile_count": models[name].compile_count,
               "max_abs_err": checks[name].get("max_abs_err"),
               "checked_rows": checks[name]["rows"]}
        if spec["shape"] == "burst":
            row["recovery_after_burst_s"] = slo.recovery_time_to_slo(
                windows, spec["at_s"] + spec["dur_s"], {name: spec["slo_ms"]})
        by_model[name] = row
    windows = slo.fold_windows(records, 1.0, spec["duration_s"])
    out = {"leg": leg, "spec": spec, "clients": clients, "wire": wire,
           "scheduled": sum(len(loadgen_schedule(s)) for s in specs),
           "offered": len(records), "outcomes": slo.outcome_counts(records),
           "sustained_qps_at_slo": slo.sustained_qps_at_slo(windows, slo_ms),
           "send_lag_p50_ms": slo.percentile(lags, 50),
           "send_lag_p99_ms": slo.percentile(lags, 99),
           "open_loop_drops": sum(c["open_loop_drops"] for c in clients),
           "cuda_initialized_in_client": any(c["cuda_initialized"]
                                             for c in clients),
           "device_busy": busy, "launches": launches, "models": by_model,
           "wall_s": wall_s,
           "checks": checks, "stages_by_model": stage_rollup(delta),
           "health_stages": {k: health["stages"].get(k)
                             for k in CLUSTER_STAGES},
           "windows": windows}
    if spec["shape"] == "burst":
        out["recovery_after_burst_s"] = slo.recovery_time_to_slo(
            windows, spec["at_s"] + spec["dur_s"], slo_ms)
    return out


def loadgen_legs(torch, eb, dq, fa, records_per_s):
    """Part (a): int8 NCF and BERT-Base at full width behind one
    ClusterServing per leg, warmed from a compile cache as phase 9's,
    driven open-loop over a ShmQueue by a client in another process."""
    import gc
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="zoo_loadgen_")
    try:
        t0 = time.perf_counter()
        cache_dir = f"{root}/compile_cache"
        cold = cluster_models(torch)
        cluster_cover(cold, cluster_records(), cache_dir)
        del cold
        gc.collect()
        torch.cuda.empty_cache()
        models = cluster_models(torch)
        log("loadgen_prepare_s", time.perf_counter() - t0)
        legs = []
        for leg, base in LOADGEN_LEGS.items():
            spec = {"leg": leg, "shape": base["shape"],
                    "duration_s": base["duration_s"], "seed": base["seed"],
                    "slo_ms": base["slo_ms"]}
            if base["shape"] == "steady":
                spec["qps"] = base["qps_r"] * records_per_s
            else:
                spec.update(base_qps=base["base_r"] * records_per_s,
                            burst_qps=base["burst_r"] * records_per_s,
                            at_s=base["at_s"], dur_s=base["dur_s"])
            legs.append(loadgen_leg(torch, eb, dq, fa, models, cache_dir,
                                    root, leg, spec))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return legs


def loadgen_phase(torch, eb, dq, fa, card, records_per_s):
    """Phase 13 (docstring item 13): open-loop legs at full width through
    ClusterServing (part a), then the harness's kill leg with its
    servers on the card and its mix-shift leg (part b)."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.loadgen.harness import (run_kill_leg,
                                                         run_mix_shift_leg)

    t0 = time.perf_counter()
    legs = loadgen_legs(torch, eb, dq, fa, records_per_s)
    legs_s = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="zoo_loadgen_report_")
    report_wall = {}
    try:
        t0 = time.perf_counter()
        kill = run_kill_leg(os.path.join(work, "kill"), **KILL_LEG)
        report_wall["kill"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mix = run_mix_shift_leg(**MIX_SHIFT_LEG)
        report_wall["mix_shift"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report_s = sum(report_wall.values())
    log("loadgen", json.dumps({"card": card, "records_per_s_r":
                               records_per_s, "legs_s": legs_s,
                               "legs": legs}))
    log("loadgen_report", json.dumps({"card": card, "wall_s": report_wall,
                                      "kill": kill, "mix_shift": mix}))
    summary = {"card": card, "r_records_per_s": records_per_s,
               "legs_s": legs_s, "report_s": report_s}
    for leg in legs:
        summary[leg["leg"]] = {
            k: leg[k] for k in ("scheduled", "offered", "outcomes",
                                "sustained_qps_at_slo", "send_lag_p99_ms",
                                "open_loop_drops", "launches", "models",
                                "wall_s")
            if k in leg}
        summary[leg["leg"]]["device_busy_share"] = leg["device_busy"][
            "device_busy_share"]
        if "recovery_after_burst_s" in leg:
            summary[leg["leg"]]["recovery_after_burst_s"] = leg[
                "recovery_after_burst_s"]
    summary["report"] = {
        "wall_s": report_wall,
        "kill": {k: kill.get(k) for k in (
            "offered", "answered_ok", "lost", "recovery_after_kill_s",
            "cold_compile_count", "warm_compile_count", "warm_count",
            "warm_cache_hits", "server1_exit_rc", "server2_exit_rc",
            "server1_start_ready_s", "server1_startup_s",
            "restart_ready_s", "server2_startup_s", "fresh_start_ready_s",
            "fresh_startup_s", "fresh_compile_count", "latency_p99_ms")},
        "mix_shift": {k: mix.get(k) for k in (
            "autoscale_actions", "autoscale_flaps", "shed_fraction_echo",
            "shed_fraction_laggy", "lost")}}
    log("loadgen_summary", json.dumps(summary))
    bad = []
    for leg in legs:
        name = leg["leg"]
        if leg["wire"] != "shm":
            bad.append(f"{name}: wire {leg['wire']}")
        if leg["cuda_initialized_in_client"]:
            bad.append(f"{name}: the client process touched CUDA")
        if not all(leg["launches"].values()):
            bad.append(f"{name}: a kernel of the path never ran: "
                       f"{leg['launches']}")
        for m, row in leg["models"].items():
            if row["compile_count"]:
                bad.append(f"{name}: {m} captured {row['compile_count']} "
                           f"live after warm")
        for m, c in leg["checks"].items():
            if not c["ok"]:
                bad.append(f"{name}: {m} answers {c}")
    if kill["warm_compile_count"] != 0:
        bad.append(f"kill: the successor captured live: {kill}")
    if kill["fresh_compile_count"] != 0:
        bad.append(f"kill: the fresh server captured live: {kill}")
    if kill["server1_exit_rc"] != -9:
        bad.append(f"kill: the killed worker's exit {kill}")
    if (kill["recovery_after_kill_s"] is None
            or kill["recovery_after_kill_s"] >= KILL_RECOVERY_S):
        bad.append(f"kill: recovery {kill['recovery_after_kill_s']}")
    if kill["lost"] > KILL_LOST:
        bad.append(f"kill: {kill['lost']} lost")
    if kill["server2_exit_rc"] != 0:
        bad.append(f"kill: successor rc {kill['server2_exit_rc']}")
    if mix["autoscale_flaps"] != 0:
        bad.append(f"mix_shift: {mix['autoscale_flaps']} autoscale flaps")
    if bad:
        raise AssertionError(f"loadgen: {bad}")
    return {k: sum(leg["launches"][k] for leg in legs)
            for k in legs[0]["launches"]}


# ---------------------------------------------------------------------------


# The flash kernels' templates <T, DMAX, warps, m-tiles, tile rows / 8,
# flag>: the name of the ring tile's rows and of the flag, per kernel
FLASH_INSTANCES = {"flash_fwd": ("keys", "lse"),
                   "flash_bwd_dq": ("keys", "hold"),
                   "flash_bwd_dkv": ("queries", "hold")}


def sass_functions(build, path):
    """(name line, SASS) of every function in the built library
    (``cuobjdump -sass``)."""
    from pathlib import Path

    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return [(part.split("\n", 1)[0], part)
            for part in sass.split("Function : ")[1:]]


def op_counts(part):
    """Tensor-core (HMMA: ``mma.sync``, HGMMA: ``wgmma``), ``cp.async``
    (LDGSTS) and ``ldmatrix`` (LDSM) instructions in one function."""
    import re

    return {op: len(re.findall(rf"\b{op}\b", part))
            for op in ("HMMA", "HGMMA", "LDGSTS", "LDSM")}


def check_instances(what, counts, missing, tensor_op):
    """Raises if an instance is missing, or one lacks its tensor-core
    instruction (``tensor_op(name)``) or LDGSTS."""
    if missing or any(not c[tensor_op(n)] or not c["LDGSTS"]
                      for n, c in counts.items()):
        raise AssertionError(f"{what} instances missing ({missing}) or "
                             f"without tensor-core or cp.async "
                             f"instructions: {counts}")
    return counts


def flash_sass(build, path, kernels):
    """Instruction counts (``op_counts``) of each instance of the flash
    ``kernels`` in the built library.  Raises if a kernel has no
    instance, or an instance lacks HMMA or LDGSTS."""
    import re

    counts = {}
    for name, part in sass_functions(build, path):
        m = re.search(r"(flash_fwd|flash_bwd_dq|flash_bwd_dkv)I"
                      r"(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E"
                      r"Lb([01])E", name)
        if m and m.group(1) in kernels:
            rows, flag = FLASH_INSTANCES[m.group(1)]
            dtype = "f32" if m.group(2) == "f" else "bf16"
            counts[f"{m.group(1)}<{dtype},DMAX={m.group(3)},"
                   f"warps={m.group(4)},mtiles={m.group(5)},"
                   f"{rows}={8 * int(m.group(6))},{flag}={m.group(7)}>"] = \
                op_counts(part)
    missing = [k for k in kernels
               if not any(n.startswith(k + "<") for n in counts)]
    return check_instances("flash", counts, missing, lambda n: "HMMA")


def dq_sass(build, path):
    """Instruction counts (``op_counts``) of each instance of the
    dequantize-matmul's kernels in the built library.  Raises unless every
    x type and weight width has an instance of both kernels (``dq_mma``,
    ``dq_wgmma``) and every instance has cp.async and its tensor-core
    instructions (HMMA in ``dq_mma``, HGMMA in ``dq_wgmma``)."""
    import re

    names = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}
    counts = {}
    for name, part in sass_functions(build, path):
        m = re.search(r"(dq_mma|dq_wgmma)I(f|13__nv_bfloat16|6__half)"
                      r"Li(\d+)E((?:Li\d+E)+)", name)
        if m:
            shape = ",".join(re.findall(r"\d+", m.group(4)))
            counts[f"{m.group(1)}<{names[m.group(2)]},int{m.group(3)},"
                   f"{shape}>"] = op_counts(part)
    missing = [f"{k}<{t},int{b}" for k in ("dq_mma", "dq_wgmma")
               for t in names.values() for b in (8, 4)
               if not any(n.startswith(f"{k}<{t},int{b},") for n in counts)]
    return check_instances(
        "dequant_matmul", counts, missing,
        lambda n: "HGMMA" if n.startswith("dq_wgmma") else "HMMA")


def bag_sass(build, path):
    """Global loads of each instance of the bag forward (``bag_fwd<T,
    P>``: f32 with 16-, 8- and 4-byte pieces, bf16 and f16 with 16, 8, 4
    and 2, f64 with 16 and 8), by width in bytes.  Raises unless all 13
    instances are there and each shows a load of its piece's width
    (``LDG.E.128`` for 16 bytes)."""
    import re

    names = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16",
             "d": "f64"}
    counts = {}
    for name, part in sass_functions(build, path):
        m = re.search(r"bag_fwdI(f|d|13__nv_bfloat16|6__half)Li(\d+)E", name)
        if not m:
            continue
        loads = {16: 0, 8: 0, 4: 0, 2: 0, 1: 0}
        for suffix in re.findall(r"\bLDG\.E((?:\.\w+)*)\s", part):
            parts = suffix.split(".")
            width = (16 if "128" in parts else 8 if "64" in parts
                     else 2 if {"U16", "S16"} & set(parts)
                     else 1 if {"U8", "S8"} & set(parts) else 4)
            loads[width] += 1
        counts[f"bag_fwd<{names[m.group(1)]},{m.group(2)}>"] = {
            "piece": int(m.group(2)), "ldg_by_bytes": loads}
    want = {f"bag_fwd<{t},{p}>" for t, ps in (
        ("f32", (16, 8, 4)), ("bf16", (16, 8, 4, 2)), ("f16", (16, 8, 4, 2)),
        ("f64", (16, 8))) for p in ps}
    bad = [n for n, c in counts.items() if not c["ldg_by_bytes"][c["piece"]]]
    if set(counts) != want or bad:
        raise AssertionError(f"bag_fwd instances missing "
                             f"({sorted(want - set(counts))}) or without "
                             f"their piece's load ({bad}): {counts}")
    return counts


def check_no_spills(name, ptxas_log):
    """Raises if ``ptxas`` reports spill stores or loads for any function
    of library ``name``."""
    import re

    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", ptxas_log)
    if not spills or any(int(n) for n in spills):
        raise AssertionError(f"{name}: ptxas reports spills (or no spill "
                             f"line): {spills}")


def headline(cases, name, route, src, tpu, launches, pick):
    head = next(c for c in cases if pick(c))
    return {"name": name, "route": route, "source": src, "replaces": tpu,
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "max_rel_err": max(c["max_rel_err"] for c in cases),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": {k: head[k] for k in head if k in (
                "vocab", "dim", "bags", "nnz", "m", "k", "n", "bits", "b",
                "h", "lq", "lk", "d", "causal", "dtype")},
            "cases": cases}


# ---------------------------------------------------------------------------
# training-surface phase (the STREAM tier, graphed evaluate / predict, AUC,
# TensorBoard)

# ML-1M's 1,000,209 ratings over 6,040 users: 166 a user, about 1.0 M
# positives and as many sampled negatives; batch 2048 as phase 4, the
# stream trimmed to four shards' worth of whole batches
SURFACE_RATINGS_PER_USER = 166
SURFACE_SHARDS = 4
SURFACE_EPOCHS = 3
# held-out rows: ragged at batch 2048 (a last batch of 1,697 rows)
SURFACE_HELD_OUT = 100_001
SURFACE_BERT = dict(rows=4 * 32 + 7, length=128, batch=32)
# graphed against eager on the plain path: the same f32 kernels but the
# bag's, summed in other orders
SURFACE_EVAL_TOL = 1e-6


def surface_ncf(torch, init, budget):
    """NeuralCF at the ML-1M width (phase 4's, with the implicit task's
    two classes) from ``init``, under a context with ``budget``."""
    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.train.optimizers import Adam

    init_zoo_context(data_device_budget_bytes=budget)
    reset_name_scope()
    ncf = NeuralCF(USERS, ITEMS, class_num=2, user_embed=20, item_embed=20,
                   hidden_layers=(40, 20, 10), mf_embed=20, device="cuda")
    load_jax_params(ncf.model, init)
    ncf.compile(optimizer=Adam(lr=1e-3),
                loss="sparse_categorical_crossentropy",
                metrics=["auc", "accuracy"])
    return ncf


def surface_data(torch, root):
    """ML-1M-sized implicit data: two epochs of sampled negatives drawn
    on the card; the first written as 8 ``.npy`` slices (users, items,
    labels), the second's head kept as the held-out set."""
    from analytics_zoo_tpu_torch.data import generate_movielens_like
    from analytics_zoo_tpu_torch.models.recommendation import \
        presample_implicit_epochs

    users, items, _ = generate_movielens_like(
        ratings_per_user=SURFACE_RATINGS_PER_USER, seed=SEED)
    u, i, y = presample_implicit_epochs(
        users, items, ITEMS, epochs=2, user_count=USERS,
        trim_multiple=SURFACE_SHARDS * TRAIN_BATCH, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    u, i, y = (t.cpu().numpy() for t in (u, i, y))
    n = u.shape[1]
    paths = []
    for k, sl in enumerate(np.array_split(np.arange(n), 8)):
        row = []
        for name, a in (("u", u[0, sl, None]), ("i", i[0, sl, None]),
                        ("y", y[0, sl])):
            path = os.path.join(root, f"{name}{k}.npy")
            np.save(path, np.ascontiguousarray(a))
            row.append(path)
        paths.append(row)
    h = SURFACE_HELD_OUT
    return (paths, len(users), n,
            ([u[1, :h, None], i[1, :h, None]], y[1, :h]))


def rank_auc(scores, labels):
    """The exact ROC AUC from ranks (ties averaged), in float64."""
    order = np.argsort(scores, kind="stable")
    s = scores[order]
    ranks = np.empty(len(s), np.float64)
    starts = np.r_[0, np.flatnonzero(np.diff(s)) + 1]
    ends = np.r_[starts[1:], len(s)]
    for a, b in zip(starts, ends):
        ranks[a:b] = (a + b + 1) / 2.0
    r = np.empty_like(ranks)
    r[order] = ranks
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return (r[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def histogram_auc_bound(scores, labels, num_thresholds=200):
    """How far the 200-threshold histogram AUC may lie from the rank AUC:
    a (positive, negative) pair whose two scores fall between the same
    two thresholds gets half credit from the trapezoid against 0, 1/2 or
    1, so the bound is half the share of such pairs."""
    edges = np.linspace(0.0, 1.0, num_thresholds)
    bucket = np.searchsorted(edges, scores, side="right")
    pos = np.bincount(bucket[labels == 1], minlength=num_thresholds + 1)
    neg = np.bincount(bucket[labels == 0], minlength=num_thresholds + 1)
    return 0.5 * float((pos.astype(np.float64) * neg).sum()) / (
        float(pos.sum()) * float(neg.sum()))


def surface_counts(eb, fa):
    return {"embedding_bag_fwd": eb.LAUNCHES.value,
            "embedding_bag_bwd": eb.BWD_LAUNCHES.value,
            "flash_attention_fwd": fa.LAUNCHES.value}


def stream_leg(torch, eb, dq, fa, init, paths, root):
    """Phase 14 (a) and (d): NCF through the STREAM tier from the
    slices, with TensorBoard scalars; then the parity, fault and
    profiler legs.  Returns the trained model and the leg's numbers."""
    from analytics_zoo_tpu_torch.core import profiling, summary
    from analytics_zoo_tpu_torch.data import CacheLevel, FeatureSet
    from analytics_zoo_tpu_torch.observe.metrics import METRICS
    from analytics_zoo_tpu_torch.robust import FaultInjector

    fs = FeatureSet.from_npy_slices(paths).cache(CacheLevel.STREAM)
    budget = fs.nbytes // 2
    fallbacks = 'data_stream_fallbacks_total{reason="upload_error"}'
    tb = os.path.join(root, "tb")
    ncf = surface_ncf(torch, init, budget)
    ncf.set_tensorboard(tb)
    est = ncf.estimator
    # the main path's window: counts start at 0 here
    reset_counts(eb, dq, fa)
    window = METRICS.snapshot()
    t0 = time.perf_counter()
    hist = [dict(h) for h in ncf.fit(fs, batch_size=TRAIN_BATCH,
                                     epochs=SURFACE_EPOCHS, verbose=False)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = surface_counts(eb, fa)
    delta = METRICS.delta(window)
    plan = est._stream_plan
    # program keys: ("stream", steps, slot, ...)
    progs = {k[2]: p.graph for k, p in est._programs.items()
             if k[0] == "stream"}
    gauges = METRICS.snapshot().gauges
    main = {
        "rows": len(fs), "slices": len(paths), "bytes": fs.nbytes,
        "budget_bytes": budget, "path": est.last_data_path,
        "reason": est.last_data_path_reason,
        "plan": {"n_shards": plan.n_shards, "shard_rows": plan.shard_rows,
                 "steps_per_shard": plan.steps_per_shard,
                 "slots": plan.slots, "dropped_rows": plan.dropped_rows,
                 "device_shard_bytes": plan.device_shard_bytes},
        "epoch_loss": [h["loss"] for h in hist],
        "samples_per_s_epochs": [h["throughput"] for h in hist],
        "ms_per_step_epochs": [1e3 * TRAIN_BATCH / h["throughput"]
                               for h in hist],
        "wall_s": wall,
        "captures": delta["counters"].get(
            'graph_captures_total{kind="train"}', 0),
        "replays_by_slot": {str(k): g.replays for k, g in progs.items()},
        "captured_by_slot": {str(k): g.captured for k, g in progs.items()},
        "fallbacks": delta["counters"].get(fallbacks, 0),
        "overlap_frac": gauges.get(("data_stream_overlap_frac", ())),
        "shard_upload_ms": delta["histograms"].get("data_shard_upload_ms"),
        "shard_wait_ms": delta["histograms"].get("data_shard_wait_ms"),
        "launches": launches}
    # (d) TensorBoard: one loss point per epoch, the history's
    tb_loss = summary.read_scalars(os.path.join(tb, "zoo"), "loss")
    published = est.publish_metrics()
    main["tensorboard"] = {"loss_points": tb_loss,
                           "scalars_published": published}

    # parity: shuffle=False through the stream against the resident fit
    # of the same rows, two epochs each
    def plain_fit(level, budget_bytes, src):
        m = surface_ncf(torch, init, budget_bytes)
        h = m.fit(src.cache(level), batch_size=TRAIN_BATCH, epochs=2,
                  shuffle=False, verbose=False)
        return ([r["loss"] for r in h], m.estimator.last_data_path,
                h[-1]["throughput"])

    s_loss, s_path, s_rate = plain_fit(CacheLevel.STREAM, budget, fs)
    arrays = [np.concatenate([np.load(p) for p in col])
              for col in zip(*paths)]
    r_loss, r_path, r_rate = plain_fit(
        CacheLevel.DEVICE, 10 * fs.nbytes,
        FeatureSet.from_ndarrays(arrays[:2], arrays[2]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(s_loss, r_loss))
    # epoch 2's rows/s: the stream's against the resident epoch's, which
    # moves no bytes (the uploads' cost to the card)
    parity = {"stream_loss": s_loss, "resident_loss": r_loss,
              "paths": [s_path, r_path], "bit_for_bit": s_loss == r_loss,
              "max_rel_diff": rel,
              "epoch2_samples_per_s": {"stream": s_rate,
                                       "resident": r_rate}}

    # an uploader crash on the third shard's upload: the epoch still
    # trains every step, from host batches for its last two shards
    fault_ncf = surface_ncf(torch, init, budget)
    mark = METRICS.snapshot()
    fi = FaultInjector().plan("data.shard_upload", at=2,
                              exc=RuntimeError("injected upload crash"))
    with fi:
        fh = fault_ncf.fit(fs, batch_size=TRAIN_BATCH, epochs=1,
                           verbose=False)
    fault = {"fired": fi.fired.get("data.shard_upload", 0),
             "steps": fault_ncf.estimator.global_step,
             "want_steps": plan.n_shards * plan.steps_per_shard,
             "loss": fh[-1]["loss"],
             "fallbacks": METRICS.delta(mark)["counters"].get(fallbacks, 0)}

    # a stream fit inside profiling.trace(): the slots' captures run with
    # the profiler on and the uploader thread copying
    prof_ncf = surface_ncf(torch, init, budget)
    mark = METRICS.snapshot()
    with profiling.trace(os.path.join(root, "trace")):
        ph = prof_ncf.fit(fs, batch_size=TRAIN_BATCH, epochs=1,
                          verbose=False)
    traced = {"path": prof_ncf.estimator.last_data_path,
              "loss": ph[-1]["loss"],
              "captures": METRICS.delta(mark)["counters"].get(
                  'graph_captures_total{kind="train"}', 0),
              "trace_bytes": os.path.getsize(
                  os.path.join(root, "trace", "trace.json"))}
    return ncf, {"main": main, "parity": parity, "fault": fault,
                 "traced": traced}


def surface_eval_leg(torch, eb, dq, fa, ncf, held):
    """Phase 14 (b): graphed NCF evaluate / predict on the held-out rows
    against eager on the plain path, and the AUC against the rank AUC."""
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.observe.metrics import METRICS
    from analytics_zoo_tpu_torch.ops.dispatch import PATH_REFERENCE, forced

    xs, y = held
    b = TRAIN_BATCH
    reset_counts(eb, dq, fa)
    ev = ncf.evaluate(xs, y, batch_size=b)          # warm-up and capture
    pred = ncf.predict(xs, batch_size=b)
    mark = METRICS.snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev2 = ncf.evaluate(xs, y, batch_size=b)
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred2 = ncf.predict(xs, batch_size=b)
    pred_s = time.perf_counter() - t0
    launches = surface_counts(eb, fa)
    replay_captures = METRICS.delta(mark)["counters"].get(
        'graph_captures_total{kind="eval"}', 0) + METRICS.delta(
        mark)["counters"].get('graph_captures_total{kind="predict"}', 0)
    with graphs.disabled(), forced(PATH_REFERENCE):
        t0 = time.perf_counter()
        ev_e = ncf.evaluate(xs, y, batch_size=b)
        eager_eval_s = time.perf_counter() - t0
        pred_e = ncf.predict(xs, batch_size=b)
    scores = pred[:, 0].astype(np.float64)
    exact = rank_auc(scores, y)
    bound = histogram_auc_bound(pred[:, 0], y)
    batches = -(-len(y) // b)
    out = {"rows": len(y), "batch": b, "last_batch_rows": len(y) % b,
           "graphed": ev, "eager_plain": ev_e,
           "max_abs_diff": max(abs(ev[k] - ev_e[k]) for k in ev),
           "pred_max_abs_diff": float(np.abs(pred - pred_e).max()),
           "repeat_equal": ev2 == ev and bool(np.array_equal(pred, pred2)),
           "captures_after_first_pass": replay_captures,
           "auc_rank_exact": exact, "auc_bound": bound,
           "auc_minus_exact": ev["auc"] - exact,
           "eval_ms_per_batch": 1e3 * eval_s / batches,
           "predict_ms_per_batch": 1e3 * pred_s / batches,
           "eager_plain_eval_ms_per_batch": 1e3 * eager_eval_s / batches,
           "launches": launches}
    return out


def surface_bert_leg(torch, eb, dq, fa):
    """Phase 14 (c): BERT-Base evaluate and predict, graphed against
    eager (graphs off, the same kernels), over a ragged last batch."""
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    cfg = SURFACE_BERT
    init_zoo_context()
    reset_name_scope()
    net = BERTClassifier(num_classes=2, bert_config=BERT_BASE,
                         generator=torch.Generator().manual_seed(SEED))
    net.compile("adam", "sparse_categorical_crossentropy_with_logits",
                metrics=["accuracy"], device="cuda")
    ids, seg, y = bert_train_data(cfg["rows"], cfg["length"], SEED + 9)
    xs, b = [ids, seg], cfg["batch"]
    batches = -(-cfg["rows"] // b)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0) / batches

    reset_counts(eb, dq, fa)
    net.evaluate(xs, y, batch_size=b)               # warm-up and capture
    net.predict(xs, batch_size=b)
    ev, ev_ms = timed(lambda: net.evaluate(xs, y, batch_size=b))
    pred, pred_ms = timed(lambda: net.predict(xs, batch_size=b))
    launches = surface_counts(eb, fa)
    with graphs.disabled():
        ev_e, ev_e_ms = timed(lambda: net.evaluate(xs, y, batch_size=b))
        pred_e, pred_e_ms = timed(lambda: net.predict(xs, batch_size=b))
    return {"rows": cfg["rows"], "length": cfg["length"], "batch": b,
            "last_batch_rows": cfg["rows"] % b, "graphed": ev,
            "eager": ev_e, "pred_shape": list(pred.shape),
            "pred_max_abs_diff": float(np.abs(pred - pred_e).max()),
            "loss_abs_diff": abs(ev["loss"] - ev_e["loss"]),
            "evaluate_ms_per_batch": {"graphed": ev_ms, "eager": ev_e_ms},
            "predict_ms_per_batch": {"graphed": pred_ms, "eager": pred_e_ms},
            "programs_captured": all(
                p.graph.captured
                for p in net.estimator._eval_programs.values()),
            "launches": launches}


def training_surface_phase(torch, eb, dq, fa, card):
    """Phase 14 (docstring item 14): the STREAM tier, graphed evaluate /
    predict with AUC, and TensorBoard.  Returns the launches by path."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.convert import export_params
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="zoo_surface_")
    try:
        t0 = time.perf_counter()
        paths, positives, rows, held = surface_data(torch, root)
        data_s = time.perf_counter() - t0
        reset_name_scope()
        init = export_params(NeuralCF(
            USERS, ITEMS, class_num=2, user_embed=20, item_embed=20,
            hidden_layers=(40, 20, 10), mf_embed=20, device="cpu",
            generator=torch.Generator().manual_seed(SEED)).model)
        ncf, stream = stream_leg(torch, eb, dq, fa, init, paths, root)
        ev = surface_eval_leg(torch, eb, dq, fa, ncf, held)
        del ncf
        bert = surface_bert_leg(torch, eb, dq, fa)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"card": card, "positives": positives, "rows": rows,
           "data_s": data_s, "stream": stream, "ncf_eval": ev,
           "bert_eval": bert, "phase_s": time.perf_counter() - t_phase}
    log("training_surface", json.dumps(out))
    main, par, fault, traced = (stream[k] for k in ("main", "parity",
                                                     "fault", "traced"))
    steps = main["plan"]["n_shards"] * main["plan"]["steps_per_shard"]
    slots = main["plan"]["slots"]
    want_replays = SURFACE_EPOCHS * main["plan"]["n_shards"] // slots - 1
    if (main["path"] != "stream" or main["plan"]["n_shards"] < 4
            or slots != 2 or main["captures"] != slots
            or not all(main["captured_by_slot"].values())
            or sorted(main["replays_by_slot"].values())
            != [want_replays] * slots or main["fallbacks"]):
        raise AssertionError(f"stream leg: {main}")
    if not main["epoch_loss"][-1] < main["epoch_loss"][0]:
        raise AssertionError(f"stream loss did not fall: "
                             f"{main['epoch_loss']}")
    ml = main["launches"]
    if (ml["embedding_bag_fwd"] != 4 * SURFACE_EPOCHS * steps
            or ml["embedding_bag_bwd"] != 4 * SURFACE_EPOCHS * steps
            or ml["flash_attention_fwd"]):
        raise AssertionError(f"stream launches {ml} over "
                             f"{SURFACE_EPOCHS * steps} steps")
    tb = main["tensorboard"]
    if ([v for _, v in tb["loss_points"]]
            != [float(np.float32(v)) for v in main["epoch_loss"]]
            or not tb["scalars_published"] > 0):
        raise AssertionError(f"tensorboard: {tb}")
    if par["paths"] != ["stream", "device_resident"] or \
            par["max_rel_diff"] > 1e-5:
        raise AssertionError(f"stream against resident: {par}")
    if (fault["fired"] != 1 or fault["steps"] != fault["want_steps"]
            or fault["fallbacks"] != 1 or not np.isfinite(fault["loss"])):
        raise AssertionError(f"upload fault leg: {fault}")
    if (traced["path"] != "stream" or traced["captures"] != slots
            or not np.isfinite(traced["loss"])):
        raise AssertionError(f"stream fit inside trace(): {traced}")
    nb = -(-SURFACE_HELD_OUT // TRAIN_BATCH)
    if (ev["max_abs_diff"] > SURFACE_EVAL_TOL
            or ev["pred_max_abs_diff"] > SURFACE_EVAL_TOL
            or not ev["repeat_equal"] or ev["captures_after_first_pass"]
            or abs(ev["auc_minus_exact"]) > ev["auc_bound"] + 1e-5
            or ev["launches"]["embedding_bag_fwd"] != 4 * 4 * nb):
        raise AssertionError(f"graphed NCF evaluation: {ev}")
    nb = -(-SURFACE_BERT["rows"] // SURFACE_BERT["batch"])
    if (bert["pred_max_abs_diff"] > 1e-3 or bert["loss_abs_diff"] > 1e-3
            or bert["pred_shape"] != [SURFACE_BERT["rows"], 2]
            or not bert["programs_captured"]
            or bert["launches"]["flash_attention_fwd"]
            != 4 * BERT_BASE["n_block"] * nb):
        raise AssertionError(f"graphed BERT evaluation: {bert}")
    return {"training_surface_stream": ml,
            "training_surface_ncf_eval": ev["launches"],
            "training_surface_bert_eval": bert["launches"]}



# ---------------------------------------------------------------------------
# detection phase (SSD300 on VOC-shaped scenes; image records served)

# SSD300 on PASCAL VOC (Liu et al. 2016): 20 classes and the background,
# 300x300 inputs, batch 32 as the paper trains, bf16 compute here; VOC's
# common image size, 375x500, with 1-4 objects an image
SSD_CLASSES = 21
SSD_DATA = dict(train=1024, held=256, height=375, width=500, max_boxes=4)
SSD_TRAIN = dict(batch=32, epochs=10, lr=1e-3)
# detection as the JAX package's ObjectDetector sets it for evaluation
SSD_DETECT = dict(batch=32, score_threshold=0.01, nms_threshold=0.45,
                  max_detections=100)
SSD_MEANS = (123.0, 117.0, 104.0)       # ImageChannelNormalize (R, G, B)
# f32 graphed against eager from one init, cuDNN deterministic on both
# sides (GRAPHED_REL as phase 10): 2 epochs of 4 steps
SSD_GRAPHED = dict(rows=128, epochs=2)
# the card's f32 head outputs against the port on the CPU (cuDNN's f32
# sums against oneDNN's through 24 convolutions): 1e-3 of the largest
SSD_CPU_REL = 1e-3
SSD_CPU_IMAGES = 4
# served detector: frames streamed by a client process, one frame a
# program replay (``batch``).  A frame's detections depend on its place
# in a larger batch on the card (cuDNN's bf16 convolutions sum a tile's
# products in an order that follows the tile, and a frame's pixels fall
# on other tiles at another place: at batch 32 a served frame's
# detections can part from offline ``detect``'s), so the served model
# and the offline reference both run each frame alone
SSD_SERVE = dict(frames=96, size=300, batch=1)
# int8 ResNet-50 on raw VOC-sized frames (phase 10's net, BASELINE
# config #2, random weights from the seed)
RECORD_RESNET = dict(frames=128, buckets=(8, 32))
# (convolutions before gather / scatter: cuDNN's weight-gradient kernels
# are named ``..._wgrad_indexed_implicit_gemm_...``)
DETECT_KERNEL_KINDS = KERNEL_KINDS[:2] + (
    ("sort", ("sort", "radix")),
    ("gather_scatter", ("gather", "scatter", "index")),) + KERNEL_KINDS[2:]

# class textures of the VOC-shaped scenes: a BGR colour per class, and a
# stripe period and direction that set classes of near colours apart
_CLASS_COLOURS = np.array(
    [[(37 * c) % 256, (91 * c + 60) % 256, (151 * c + 120) % 256]
     for c in range(1, 21)], np.int16)


def voc_scenes(n, seed, height=375, width=500, max_boxes=4):
    """``n`` uint8 BGR scenes of VOC's shape with 1-``max_boxes`` objects
    each: dark noise (0-63), then each object a box of its class's colour
    with stripes of its class's period and direction.  Returns (images, [boxes (k, 4)
    pixels x1 y1 x2 y2], [labels (k,) 1-20])."""
    rs = np.random.RandomState(seed)
    imgs = np.empty((n, height, width, 3), np.uint8)
    boxes, labels = [], []
    rows, cols = np.ogrid[:height, :width]
    for i in range(n):
        img = (np.frombuffer(rs.bytes(height * width * 3), np.uint8)
               .reshape(height, width, 3) & 63).astype(np.int16)
        k = 1 + rs.randint(max_boxes)
        b = np.zeros((k, 4), np.float32)
        lab = rs.randint(1, 21, k)
        for j in range(k):
            bw = rs.randint(width // 8, width // 2)
            bh = rs.randint(height // 8, height // 2)
            x1 = rs.randint(0, width - bw)
            y1 = rs.randint(0, height - bh)
            c = lab[j] - 1
            period = 4 + 3 * (c % 5)
            axis = rows if (c // 5) % 2 else cols
            part = (rows[y1:y1 + bh] if axis is rows
                    else cols[:, x1:x1 + bw])
            stripe = ((part // period) % 2) * 50
            img[y1:y1 + bh, x1:x1 + bw] = (_CLASS_COLOURS[c]
                                           - stripe[..., None])
            b[j] = (x1, y1, x1 + bw, y1 + bh)
        imgs[i] = np.clip(img, 0, 255).astype(np.uint8)
        boxes.append(b)
        labels.append(lab)
    return imgs, boxes, labels


def write_voc_annotations(root, boxes, labels, height, width):
    """One VOC XML annotation per image under ``root``."""
    import os

    from analytics_zoo_tpu_torch.data import VOC_CLASSES

    os.makedirs(root, exist_ok=True)
    for i, (b, lab) in enumerate(zip(boxes, labels)):
        objs = "".join(
            f"<object><name>{VOC_CLASSES[c - 1]}</name><difficult>0"
            f"</difficult><bndbox><xmin>{int(x1)}</xmin><ymin>{int(y1)}"
            f"</ymin><xmax>{int(x2)}</xmax><ymax>{int(y2)}</ymax></bndbox>"
            f"</object>" for (x1, y1, x2, y2), c in zip(b, lab))
        with open(os.path.join(root, f"{i:06d}.xml"), "w") as f:
            f.write(f"<annotation><filename>{i:06d}.jpg</filename><size>"
                    f"<width>{width}</width><height>{height}</height>"
                    f"<depth>3</depth></size>{objs}</annotation>")


def padded_boxes(feats, max_boxes):
    """Augmented features -> (images (N, 300, 300, 3) f32, boxes (N, G, 4)
    normalised, labels (N, G) int32; label 0 pads)."""
    g = max(max_boxes, max(len(f["bboxes"]) for f in feats))
    x = np.stack([f["sample"] if "sample" in f else f.image for f in feats]
                 ).astype(np.float32)
    b = np.zeros((len(feats), g, 4), np.float32)
    lab = np.zeros((len(feats), g), np.int32)
    for i, f in enumerate(feats):
        k = len(f["bboxes"])
        b[i, :k] = f["bboxes"]
        lab[i, :k] = np.asarray(f["label"]).reshape(-1)
    return x, b, lab


def ssd_data(root):
    """The phase's data: VOC-shaped scenes written as VOC XML and read
    back through ``read_pascal_voc``; the training images through SSD's
    augmentation (``RandomSampler | ImageRandomPreprocessing(RoiHFlip(
    normalized=False)) | RoiResize(300, 300) | RoiNormalize |
    ImageChannelNormalize``), the held-out ones resized and
    normalised."""
    import os

    from analytics_zoo_tpu_torch.data import read_pascal_voc
    from analytics_zoo_tpu_torch.data import image as dimg

    cfg = SSD_DATA
    n = cfg["train"] + cfg["held"]
    t0 = time.perf_counter()
    imgs, boxes, labels = voc_scenes(n, SEED + 31, cfg["height"],
                                     cfg["width"], cfg["max_boxes"])
    make_s = time.perf_counter() - t0
    ann = os.path.join(root, "Annotations")
    write_voc_annotations(ann, boxes, labels, cfg["height"], cfg["width"])
    recs = read_pascal_voc(ann)
    if len(recs) != n or not all(
            np.array_equal(r["bboxes"], b) and np.array_equal(r["labels"], lab)
            and (r["height"], r["width"]) == (cfg["height"], cfg["width"])
            for r, b, lab in zip(recs, boxes, labels)):
        raise AssertionError("read_pascal_voc did not give back the "
                             "written annotations")
    norm = dimg.ImageChannelNormalize(*SSD_MEANS)
    # the boxes are still in pixels where the flip runs (RoiNormalize
    # comes after it), so it flips them about the image's width; half of
    # the images, as SSD augments
    augment = (dimg.RandomSampler()
               | dimg.ImageRandomPreprocessing(
                   dimg.RoiHFlip(normalized=False), 0.5)
               | dimg.RoiResize(300, 300) | dimg.RoiNormalize() | norm)
    plain = dimg.RoiResize(300, 300) | dimg.RoiNormalize() | norm

    def image_set(rows, chain):
        feats = [dimg.ImageFeature(image=imgs[i], bboxes=recs[i]["bboxes"],
                                   label=recs[i]["labels"]) for i in rows]
        return dimg.ImageSet(feats).transform(chain)

    t0 = time.perf_counter()
    train = image_set(range(cfg["train"]), augment).transformed()
    augment_s = time.perf_counter() - t0
    held = image_set(range(cfg["train"], n), plain).transformed()
    out = {"make_s": make_s, "augment_s": augment_s,
           "augment_ms_per_image": 1e3 * augment_s / cfg["train"],
           "boxes_per_image": float(np.mean([len(b) for b in boxes])),
           "boxes_kept_per_image": float(np.mean([len(f["bboxes"])
                                                  for f in train]))}
    return (padded_boxes(train, cfg["max_boxes"]),
            padded_boxes(held, cfg["max_boxes"]), out)


def ssd_detector(torch, init=None, device="cuda"):
    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.models.objectdetection import ObjectDetector
    from analytics_zoo_tpu_torch.nn import reset_name_scope

    reset_name_scope()
    det = ObjectDetector(SSD_CLASSES, device=device)
    if init is not None:
        load_jax_params(det.model, *init)
    return det


def voc_map(dets, boxes, labels):
    """VOC-2007 11-point mAP (``PascalVocEvaluator``) of ``dets`` against
    the padded ground truth (label 0 pads)."""
    from analytics_zoo_tpu_torch.models.objectdetection import (
        PascalVocEvaluator)

    ev = PascalVocEvaluator()
    for (db, ds, dl), gb, gl in zip(dets, boxes, labels):
        ev.add(db, ds, dl, gb[gl > 0], gl[gl > 0])
    return ev.summary()["mAP"]


def ssd_training(torch, det, x, b, lab):
    """SSD300 trained graphed in bf16 on device-resident data: the first
    epoch's dispatches timed one by one (eager, then the capture), the
    rest of the epochs' wall time per step, one more epoch under
    ``torch.profiler`` (device ms by kind)."""
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch.train.optimizers import Adam

    cfg = SSD_TRAIN
    det.compile(Adam(lr=cfg["lr"]), det.loss(), compute_dtype="bfloat16")
    est = det.model.estimator
    steps = x.shape[0] // cfg["batch"]
    dispatch_s = []
    plain_dispatch = est._dispatch

    def timed(*a, **kw):
        t0 = time.perf_counter()
        plain_dispatch(*a, **kw)
        torch.cuda.synchronize()
        dispatch_s.append(time.perf_counter() - t0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    targets = det.assigner(b, lab)
    torch.cuda.synchronize()
    assign_s = time.perf_counter() - t0
    est._dispatch = timed
    det.model.fit(x, targets, batch_size=cfg["batch"], epochs=1,
                  verbose=False)
    est._dispatch = plain_dispatch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # ``epochs`` counts from the estimator's first: epochs 2 .. E
    det.model.fit(x, targets, batch_size=cfg["batch"],
                  epochs=cfg["epochs"], verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        det.model.fit(x, targets, batch_size=cfg["batch"],
                      epochs=cfg["epochs"] + 1, verbose=False)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    events = kernel_events(torch, prof)
    busy = sum(device_us(e) for e in events) / 1e3
    by_kind, heaviest = {}, {}
    for e in events:
        kind = next((k for k, words in DETECT_KERNEL_KINDS if any(
            w in e.key.lower() for w in words)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + device_us(e) / 1e3 / steps
        if device_us(e) > heaviest.get(kind, ("", 0.0))[1]:
            heaviest[kind] = (e.key[:80], device_us(e))
    top = sorted(events, key=device_us, reverse=True)[:8]
    ms = 1e3 * wall / (steps * (cfg["epochs"] - 1))
    losses = [h["loss"] for h in est.history]
    progs = programs_of(est._programs)
    out = {"steps_per_epoch": steps, "epochs": cfg["epochs"] + 1,
           "assign_targets_s": assign_s,
           "ms_per_step_wall": ms, "imgs_per_s": cfg["batch"] / (ms / 1e3),
           "ms_per_step_device": busy / steps,
           "device_busy_share": busy / (1e3 * prof_wall),
           "device_ms_per_step_by_kind": by_kind,
           "heaviest_kernel_by_kind": {k: v[0] for k, v in heaviest.items()},
           "kernels_per_step": sum(e.count for e in events) / steps,
           "top_device_ms_per_step": {e.key[:60]: device_us(e) / 1e3 / steps
                                      for e in top},
           "first_epoch_dispatch_s": dispatch_s[:3],
           "eager_first_step_s": dispatch_s[0],
           "captures": len(progs),
           "replays": sum(p["replays"] for p in progs.values()),
           "graph_launches": graph_launches(prof),
           "peak_allocated_gib": peak,
           "first_loss": losses[0], "last_loss": losses[-1],
           "epoch_loss": losses}
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"SSD300 loss did not fall: {losses}")
    if len(progs) != 1 or out["replays"] < steps * cfg["epochs"] - 2:
        raise AssertionError(f"SSD300 training did not replay one step "
                             f"graph: {progs}")
    return out


def ssd_graphed_vs_eager(torch, init, x, b, lab):
    """The f32 step graphed and eager from one init over the same
    batches, cuDNN deterministic: per-epoch losses, and the parameters'
    and BN statistics' distance against how far they moved."""
    import contextlib

    from analytics_zoo_tpu_torch.convert import export_params, export_state
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.train.optimizers import Adam

    cfg = SSD_GRAPHED
    rows = slice(0, cfg["rows"])
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, ctx in (("graphed", contextlib.nullcontext()),
                          ("eager", graphs.disabled())):
            det = ssd_detector(torch, init)
            det.compile(Adam(lr=SSD_TRAIN["lr"]), det.loss())
            with ctx:
                hist = det.fit_detection(x[rows], b[rows], lab[rows],
                                         batch_size=SSD_TRAIN["batch"],
                                         nb_epoch=cfg["epochs"],
                                         shuffle=False, verbose=False)
            torch.cuda.synchronize()
            runs[name] = ([h["loss"] for h in hist],
                          export_params(det.model), export_state(det.model))
            del det
            free_card(torch)
    finally:
        torch.backends.cudnn.deterministic = False
    (gl, gp, gs), (el, ep, es) = runs["graphed"], runs["eager"]
    p_diff, p_equal = tree_diff(gp, ep)
    s_diff, s_equal = tree_diff(gs, es)
    out = {"steps": cfg["rows"] // SSD_TRAIN["batch"] * cfg["epochs"],
           "graphed_loss": gl, "eager_loss": el,
           "max_loss_rel_diff": max(abs(a - c) / abs(c)
                                    for a, c in zip(gl, el)),
           "params_l2_rel": l2(gp, ep) / max(l2(gp, init[0]), 1e-30),
           "state_l2_rel": l2(gs, es) / max(l2(gs, init[1]), 1e-30),
           "params_max_abs_diff": p_diff, "state_max_abs_diff": s_diff,
           "bit_equal": p_equal and s_equal and gl == el,
           "tolerance_l2_rel": GRAPHED_REL}
    if (out["params_l2_rel"] > GRAPHED_REL
            or out["state_l2_rel"] > GRAPHED_REL
            or not all(np.isfinite(gl))):
        raise AssertionError(f"graphed SSD300 left the eager run: {out}")
    return out


def ssd_detection_checks(torch, det, held_x, held_b, held_lab):
    """``detect`` on the held-out images (graphed) against graphs off on
    the card, and the card's f32 head outputs and post-processing against
    the port on the CPU for a few images."""
    from analytics_zoo_tpu_torch.convert import export_params, export_state
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.models.objectdetection import decode_boxes
    from analytics_zoo_tpu_torch.models.objectdetection.nms import (
        class_nms_batch)

    kw = {k: v for k, v in SSD_DETECT.items() if k != "batch"}
    bs = SSD_DETECT["batch"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = det.detect(held_x, batch_size=bs, **kw)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = det.detect(held_x, batch_size=bs, **kw)
    graphed_s = time.perf_counter() - t0
    with graphs.disabled():
        t0 = time.perf_counter()
        eager = det.detect(held_x, batch_size=bs, **kw)
        eager_s = time.perf_counter() - t0
    same_labels = all(np.array_equal(g[2], e[2]) for g, e in zip(got, eager))
    same_boxes = all(np.array_equal(g[0], e[0]) for g, e in zip(got, eager))
    score_diff = max((float(np.abs(g[1] - e[1]).max()) if len(g[1]) else 0.0)
                     for g, e in zip(got, eager)) if same_labels else None
    progs = list(det._detect_programs.values())
    # the card's f32 head outputs and post-processing against the CPU's
    k = SSD_CPU_IMAGES
    cpu = ssd_detector(torch, (export_params(det.model),
                               export_state(det.model)), device="cpu")
    cpu.model.eval()
    det.model.eval()
    xs = torch.from_numpy(held_x[:k])
    with torch.no_grad():
        t_loc, t_conf = det.model(xs.cuda())
        c_loc, c_conf = cpu.model(xs)
    head_err = max(float((t_loc.cpu() - c_loc).abs().max()
                         / c_loc.abs().max()),
                   float((t_conf.cpu() - c_conf).abs().max()
                         / c_conf.abs().max()))
    post = []
    for loc, conf, pri in ((t_loc, t_conf, det.priors_t),
                           (t_loc.cpu(), t_conf.cpu(), cpu.priors_t)):
        with torch.no_grad():
            post.append([t.cpu().numpy() for t in class_nms_batch(
                decode_boxes(loc, pri), torch.softmax(conf, -1),
                kw["nms_threshold"], kw["score_threshold"], 50,
                kw["max_detections"])])
    post_equal = (np.array_equal(post[0][2], post[1][2])
                  and float(np.abs(post[0][0] - post[1][0]).max()) <= 1e-6
                  and float(np.abs(post[0][1] - post[1][1]).max()) <= 1e-6)
    out = {"images": len(held_x), "batch": bs, **kw,
           "first_call_s": first_s, "graphed_s": graphed_s,
           "eager_s": eager_s,
           "graphed_ms_per_batch": 1e3 * graphed_s / -(-len(held_x) // bs),
           "eager_ms_per_batch": 1e3 * eager_s / -(-len(held_x) // bs),
           "graphed_equals_eager": {"labels": same_labels,
                                    "boxes": same_boxes,
                                    "max_score_diff": score_diff},
           "detect_programs": len(progs),
           "detect_replays": sum(p.graph.replays for p in progs),
           "detections_per_image": float(np.mean([len(g[2]) for g in got])),
           "cpu_head_rel_err": head_err, "cpu_head_tolerance": SSD_CPU_REL,
           "cpu_post_processing_equal": post_equal}
    if (not same_labels or not same_boxes or score_diff is None
            or score_diff > 1e-6 or len(progs) != 1
            or not progs[0].graph.captured):
        raise AssertionError(f"graphed detect left eager detect: {out}")
    if head_err > SSD_CPU_REL or not post_equal:
        raise AssertionError(f"the card's SSD300 left the CPU port: {out}")
    return got, out


def detection_frames(n, size, seed):
    """The served detector's frames: VOC-like scenes at size x size."""
    return voc_scenes(n, seed, size, size)[0]


def ssd_preprocess(img):
    """The served detector's host preprocessing of one raw uint8 frame."""
    from analytics_zoo_tpu_torch.data import image as dimg

    feat = dimg.ImageChannelNormalize(*SSD_MEANS).apply(
        dimg.ImageFeature(image=np.asarray(img)), None)
    return feat.image


def detections_array(dets, rows=SSD_DETECT["max_detections"]):
    """Per-image detections as one (N, rows, 6) f32 array: x1 y1 x2 y2
    score label, zero rows after the last."""
    out = np.zeros((len(dets), rows, 6), np.float32)
    for i, (bx, sc, lb) in enumerate(dets):
        out[i, :len(sc), :4] = bx
        out[i, :len(sc), 4] = sc
        out[i, :len(sc), 5] = lb
    return out


def detect_client(segment, out_path, spec_json):
    """The detector's client process (``chip_smoke.py --detect-client
    SEGMENT OUT SPEC``): attaches to the worker's ShmQueue, pushes raw
    uint8 frames through ``enqueue_image`` from one thread while it reads
    the answers, writes them to ``OUT`` (npz) and prints one JSON line
    with records/s and the latencies it saw.  It never touches CUDA."""
    import torch

    from analytics_zoo_tpu_torch.deploy import (InputQueue, OutputQueue,
                                                ShmQueue)

    spec = json.loads(spec_json)
    frames = detection_frames(spec["frames"], spec["size"], spec["seed"])
    q = ShmQueue.attach(segment, push_timeout_s=120.0)
    iq, oq = InputQueue(q), OutputQueue(q)
    sent, errors = {}, []

    def push():
        try:
            for i, f in enumerate(frames):
                sent[f"frame{i}"] = time.perf_counter()
                iq.enqueue_image(f"frame{i}", image=f)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    answers, seen = {}, {}
    t0 = time.perf_counter()
    pusher = threading.Thread(target=push)
    pusher.start()
    deadline = time.monotonic() + 300
    while len(answers) < len(frames) and time.monotonic() < deadline:
        got = oq.dequeue(timeout=0.5)
        now = time.perf_counter()
        for uri, a in got.items():
            answers[uri] = a
            seen[uri] = now
    wall = time.perf_counter() - t0
    pusher.join(timeout=60)
    arr = np.full((len(frames), SSD_DETECT["max_detections"], 6), np.nan,
                  np.float32)
    for i in range(len(frames)):
        a = answers.get(f"frame{i}")
        if a is not None and not isinstance(a, dict):
            arr[i] = np.asarray(a, np.float32)
    np.savez(out_path, answers=arr)
    q.stop()
    lat = [1e3 * (seen[u] - sent[u]) for u in seen if u in sent]
    print(json.dumps({
        "frames": len(frames), "answered": len(answers), "wall_s": wall,
        "records_per_s": len(frames) / wall,
        "p50_ms": float(np.percentile(lat, 50)) if lat else None,
        "p99_ms": float(np.percentile(lat, 99)) if lat else None,
        "errors": [a for a in answers.values() if isinstance(a, dict)][:3],
        "push_errors": errors,
        "cuda_initialized": torch.cuda.is_initialized()}))
    return 0 if len(answers) == len(frames) and not errors else 1


def ssd_serving(torch, det):
    """The trained detector behind ``InferenceModel(detection_forward)``
    and ``ClusterServing`` over a ShmQueue, as
    examples/objectdetection/streaming_od_example.py serves it; a client
    process streams raw uint8 frames; every answer held against offline
    ``detect`` on the same frames."""
    import os
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.deploy import (ClusterServing,
                                                InferenceModel,
                                                ServingConfig, ShmQueue)
    from analytics_zoo_tpu_torch.observe.metrics import METRICS

    cfg = SSD_SERVE
    kw = {k: v for k, v in SSD_DETECT.items() if k != "batch"}
    bs = cfg["batch"]
    frames = detection_frames(cfg["frames"], cfg["size"], SEED + 41)
    offline = detections_array(det.detect(
        np.stack([ssd_preprocess(f) for f in frames]), batch_size=bs, **kw))
    lock = threading.Lock()

    def detection_forward(xs):
        # one caller at a time: a detect program's graph is not
        # thread-safe
        with lock:
            return detections_array(det.detect(np.asarray(xs[0]),
                                               batch_size=bs, **kw))

    im = InferenceModel(detection_forward, batch_buckets=(bs,),
                        name="ssd300")
    queue = ShmQueue(name="smoke_ssd", slots=128,
                     slot_bytes=1 << 19, result_slots=256,
                     result_slot_bytes=1 << 13)
    scfg = ServingConfig(batch_size=8, max_batch_delay_ms=5.0,
                         decode_workers=4)
    cs = ClusterServing(im, queue, scfg, preprocess=ssd_preprocess)
    root = tempfile.mkdtemp(prefix="zoo_ssd_")
    out_path = os.path.join(root, "answers.npz")
    spec = json.dumps({"frames": cfg["frames"], "size": cfg["size"],
                       "seed": SEED + 41})
    try:
        cs.start()
        window = METRICS.snapshot()
        client = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--detect-client",
             queue.segment, out_path, spec],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            stdout, stderr = client.communicate(timeout=400)
        finally:
            if client.poll() is None:
                client.kill()
                client.communicate()
        delta = METRICS.delta(window)
    finally:
        cs.stop(timeout=30)
        del cs
        queue.stop()
    if client.returncode != 0:
        raise AssertionError(f"the detector's client failed (rc "
                             f"{client.returncode}): {stdout[-2000:]} "
                             f"{stderr[-3000:]}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    with np.load(out_path) as f:
        got = f["answers"]
    shutil.rmtree(root, ignore_errors=True)
    equal = bool(np.array_equal(got, offline))
    differ = np.nonzero(np.any(got != offline, axis=(1, 2)))[0]
    out = {**summary, "answers_equal_offline_detect": equal,
           "frames_differing": differ.tolist()[:10],
           "max_abs_diff": float(np.nanmax(np.abs(got - offline))),
           "stages": stage_rollup(delta).get("ssd300")}
    if not equal or summary["cuda_initialized"]:
        raise AssertionError(f"served SSD300 left offline detect: {out}")
    return out


def image_record_serving(torch, dq):
    """int8 ResNet-50 (``ImageClassifier("resnet-50")``, random weights
    from the seed) behind ClusterServing over a ShmQueue, its
    ``preprocessing()`` chain as the worker's host preprocess, raw
    375x500 frames from a client thread through ``enqueue_image``, top-5
    on the card; held against offline ``predict_image_set`` of the same
    int8 net on the same frames.  Kernel 3's launches are read over the
    served run only."""
    from analytics_zoo_tpu_torch.convert import load_jax_params
    from analytics_zoo_tpu_torch.data import image as dimg
    from analytics_zoo_tpu_torch.deploy import (ClusterServing,
                                                InferenceModel, InputQueue,
                                                OutputQueue, ServingConfig,
                                                ShmQueue)
    from analytics_zoo_tpu_torch.models.image import ImageClassifier
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.observe.metrics import METRICS

    cfg = RECORD_RESNET
    top_n = 5
    frames = voc_scenes(cfg["frames"], SEED + 47)[0]
    reset_name_scope()
    clf = ImageClassifier("resnet-50", class_num=1000, device="cuda")
    im = InferenceModel.from_keras_net(clf.model, device="cuda",
                                       weight_dtype="int8",
                                       batch_buckets=cfg["buckets"],
                                       name="resnet50_int8")
    # offline: the same int8 tree in the classifier's own net
    load_jax_params(clf.model, im.params(), im._net.state())
    clf.compile("sgd", "sparse_categorical_crossentropy_with_logits")
    chain = clf.preprocessing()
    t0 = time.perf_counter()
    offline_top = clf.predict_image_set(dimg.ImageSet.from_arrays(frames),
                                        batch_size=32, top_k=top_n)
    offline_s = time.perf_counter() - t0
    logits = clf.model.predict(dimg.ImageSet.from_arrays(frames).transform(
        chain).to_arrays()[0], batch_size=32)

    def preprocess(img):
        return chain.apply(dimg.ImageFeature(image=np.asarray(img)),
                           None)["sample"]

    queue = ShmQueue(name="smoke_records", slots=256, slot_bytes=1 << 20,
                     result_slots=256, result_slot_bytes=1 << 10)
    scfg = ServingConfig(postprocess_top_n=top_n, batch_size=32,
                         max_batch_delay_ms=5.0, decode_workers=6)
    cs = ClusterServing(im, queue, scfg, preprocess=preprocess)
    iq, oq = InputQueue(queue), OutputQueue(queue)
    answers, sent, seen = {}, {}, {}
    try:
        cs.start()
        # one pass to capture the bucket graphs, outside the counted run
        for b in cfg["buckets"]:
            im.predict(np.stack([preprocess(f) for f in frames[:b]]))
        window = METRICS.snapshot()
        dq.LAUNCHES.reset()
        t0 = time.perf_counter()

        def push():
            for i, f in enumerate(frames):
                sent[f"img{i}"] = time.perf_counter()
                iq.enqueue_image(f"img{i}", image=f)

        pusher = threading.Thread(target=push)
        pusher.start()
        deadline = time.monotonic() + 120
        while len(answers) < len(frames) and time.monotonic() < deadline:
            got = oq.dequeue(timeout=0.5)
            now = time.perf_counter()
            for uri, a in got.items():
                answers[uri] = a
                seen[uri] = now
        wall = time.perf_counter() - t0
        pusher.join(timeout=60)
        torch.cuda.synchronize()
        launches = dq.LAUNCHES.value
        delta = METRICS.delta(window)
    finally:
        cs.stop(timeout=30)
        del cs
        queue.stop()
    served = np.full((len(frames), top_n), -1, np.int64)
    for i in range(len(frames)):
        a = answers.get(f"img{i}")
        if isinstance(a, list) and len(a) == top_n:
            served[i] = [p[0] for p in a]
    # images whose top-6 logits all part by more than the int8 path's
    # rounding between two batch shapes (1e-5 of the largest) decide
    # their top-5 order; the rest are counted
    srt = np.sort(logits, axis=-1)[:, ::-1][:, :top_n + 1]
    gaps = np.diff(srt, axis=-1).min(axis=-1) * -1
    decided = gaps > 1e-5 * np.abs(logits).max()
    equal = bool(np.array_equal(served[decided], offline_top[decided]))
    lat = [1e3 * (seen[u] - sent[u]) for u in seen if u in sent]
    out = {"frames": len(frames), "answered": len(answers),
           "wall_s": wall, "records_per_s": len(frames) / wall,
           "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           "top5_equal_predict_image_set": equal,
           "top5_equal_all": bool(np.array_equal(served, offline_top)),
           "decided_images": int(decided.sum()),
           "offline_predict_image_set_s": offline_s,
           "dequant_matmul_launches": launches,
           "compile_count": im.compile_count,
           "stages": stage_rollup(delta).get("resnet50_int8"),
           "device_busy": device_busy(delta, wall)}
    if (len(answers) != len(frames) or not equal or launches <= 0
            or decided.sum() < len(frames) // 2):
        raise AssertionError(f"int8 ResNet-50 image records failed: {out}")
    del im, clf
    free_card(torch)
    return out


def detection_phase(torch, dq, card):
    """Phase 15: SSD300 (VOC, 21 classes) trained in bf16 from VOC-shaped
    scenes through the ROI pipeline, evaluated (mAP at init and after),
    detect graphed against eager and the CPU, served from raw frames;
    int8 ResNet-50 answering image records on kernel 3."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.convert import export_params, export_state

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="zoo_voc_")
    try:
        (x, b, lab), (hx, hb, hl), data = ssd_data(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("detection_data", json.dumps(data))
    det = ssd_detector(torch)
    n_params = sum(p.numel() for p in det.model.parameters())
    init = (export_params(det.model), export_state(det.model))
    det.compile("sgd", det.loss(), compute_dtype="bfloat16")
    kw = {k: v for k, v in SSD_DETECT.items() if k != "batch"}
    map_init = voc_map(det.detect(hx, batch_size=SSD_DETECT["batch"], **kw),
                       hb, hl)
    xt = torch.from_numpy(x).cuda()
    bt, lt = torch.from_numpy(b).cuda(), torch.from_numpy(lab).cuda()
    training = ssd_training(torch, det, xt, bt, lt)
    training.update(parameters=n_params, priors=int(det.priors.shape[0]),
                    card=card)
    log("detection_training", json.dumps(training))
    got, detection = ssd_detection_checks(torch, det, hx, hb, hl)
    detection.update(map_init=map_init, map_trained=voc_map(got, hb, hl),
                     card=card)
    log("detection_eval", json.dumps(detection))
    if not detection["map_trained"] > detection["map_init"]:
        raise AssertionError(f"SSD300's mAP did not rise: {detection}")
    compare = ssd_graphed_vs_eager(torch, init, xt, bt, lt)
    log("detection_graphed_vs_eager", json.dumps(compare))
    del xt, bt, lt
    free_card(torch)
    serving = ssd_serving(torch, det)
    serving["card"] = card
    log("detection_serving", json.dumps(serving))
    del det
    free_card(torch)
    records = image_record_serving(torch, dq)
    records["card"] = card
    log("image_records", json.dumps(records))
    summary = {"card": card, "seconds": time.perf_counter() - t_phase,
               "train_ms_per_step_wall": training["ms_per_step_wall"],
               "train_imgs_per_s": training["imgs_per_s"],
               "train_ms_per_step_device": training["ms_per_step_device"],
               "loss": [training["first_loss"], training["last_loss"]],
               "map": [detection["map_init"], detection["map_trained"]],
               "detect_ms_per_batch": detection["graphed_ms_per_batch"],
               "served_records_per_s": serving["records_per_s"],
               "served_p50_ms": serving["p50_ms"],
               "image_records_per_s": records["records_per_s"],
               "image_records_p50_ms": records["p50_ms"],
               "augment_ms_per_image": data["augment_ms_per_image"]}
    log("detection_summary", json.dumps(summary))
    return {"image_records": records["dequant_matmul_launches"]}


# ---------------------------------------------------------------------------
# model-import phase (phase 16): the ONNX, Caffe, BigDL and torch importers,
# GraphNet.new_graph and int8 post-training quantization

# BERT-Base (phase 5's) written as ONNX: L = 128, 2 labels; served f32 and
# int8 (8 calibration batches of 8 rows) from buckets 8 and 32
IMPORT_BERT = dict(length=128, labels=2, calib_batches=8, calib_rows=8,
                   requests=64, threads=4, buckets=(8, 32), timed=20)
# the f32 import against the native model: phase 5's bound on a logit
IMPORT_BERT_TOL = 1e-3
# int8 against f32: every Dense quantized (74), activations per tensor
# from a 99.9th-percentile calibration; held within 10% of the largest
# f32 logit, the agreement of the two argmaxes printed beside
IMPORT_INT8_REL = 0.1
# the int8 product against torch.matmul, BERT-Base's Dense shapes at M=4096
INT8_MM_SHAPES = ((4096, 768, 768), (4096, 768, 3072), (4096, 3072, 768))
# KaimingHe/deep-residual-networks ResNet-50-deploy.prototxt's stages
CAFFE_RESNET = dict(stages=((3, 64), (4, 128), (6, 256), (3, 512)),
                    batch=32, rows=64, epochs=3, lr=1e-4, graphed_steps=4)
# the import against the port net it was written from (plain versions,
# f32, cuDNN deterministic): the softmax outputs' centred log-probabilities
# (the logits up to a common shift) within 1e-3 of the largest
IMPORT_RESNET_REL = 1e-3
# Analytics Zoo's vgg-16 layer names (BigDL ``.model``)
VGG_REF_NAMES = tuple(f"conv{b + 1}_{r + 1}" for b, reps in
                      enumerate((2, 2, 3, 3, 3)) for r in range(reps))
IMPORT_VGG = dict(buckets=(1, 8, 32), head=10, rows=64, batch=32, epochs=2,
                  lr=1e-3)
# int8 VGG-16 against the plain versions on the dequantized tree: phase
# 10's 1e-4 of the largest logit for each of its three Dense layers on
# kernel 3 in a chain.  fc6 sums K = 25088 products: kernel 3 and
# cuBLAS part there by 6-7e-5 of the largest output (the kernel leg), as
# two f32 sums in another order over terms of random sign do, so the
# chain's answers part by about 1e-4 of the largest logit (0.98e-4 on an
# H100), which a single 1e-4 would hold only by chance
IMPORT_VGG_REL = 3 * SERVE_F32_REL
# torchvision's vgg11 ('A'): the imported program against the module;
# SGD at 0.05, so that one step on the 16 rows moves the loss by more
# than the dropout masks do (at 1e-3 they hid it)
IMPORT_VGG11 = dict(batch=8, train_rows=16, lr=0.05, tol=1e-4)
# kernel 3 at VGG-16's Dense shapes (fc6, fc7, fc8)
VGG_DENSE = (("vgg16_fc6", 25088, 4096), ("vgg16_fc7", 4096, 4096),
             ("vgg16_fc8", 4096, 1000))


def pb_varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def pb_key(field, wire):
    return pb_varint((field << 3) | wire)


def pb_int(field, v):
    return pb_key(field, 0) + pb_varint(int(v))


def pb_msg(field, payload):
    return pb_key(field, 2) + pb_varint(len(payload)) + payload


ONNX_ELEM = {np.dtype(np.float32): 1, np.dtype(np.int64): 7,
             np.dtype(np.int32): 6}


def onnx_tensor(name, arr):
    """TensorProto: dims (1), data_type (2), name (8), raw_data (9)."""
    arr = np.asarray(arr)
    return b"".join([pb_int(1, d) for d in arr.shape]
                    + [pb_int(2, ONNX_ELEM[arr.dtype]),
                       pb_msg(8, name.encode()),
                       pb_msg(9, arr.tobytes())])


def onnx_attr(name, value):
    """AttributeProto: name (1), f (2), i (3), t (5), ints (8), type (20)."""
    out = [pb_msg(1, name.encode())]
    if isinstance(value, float):
        out += [pb_key(2, 5) + np.float32(value).tobytes(), pb_int(20, 1)]
    elif isinstance(value, int):
        out += [pb_int(3, value), pb_int(20, 2)]
    elif isinstance(value, np.ndarray):
        out += [pb_msg(5, onnx_tensor(name, value)), pb_int(20, 4)]
    else:
        out += [pb_int(8, v) for v in value] + [pb_int(20, 7)]
    return b"".join(out)


class OnnxWriter:
    """An ONNX graph in the exporters' vocabulary, encoded by hand
    (ModelProto / GraphProto / NodeProto field numbers of onnx.proto)."""

    def __init__(self):
        self.nodes, self.inits, self.n = [], [], 0

    def init(self, name, arr):
        self.inits.append(pb_msg(5, onnx_tensor(name, arr)))
        return name

    def op(self, op_type, *inputs, **attrs):
        self.n += 1
        out = f"{op_type.lower()}_{self.n}"
        self.nodes.append(pb_msg(1, b"".join(
            [pb_msg(1, i.encode()) for i in inputs]
            + [pb_msg(2, out.encode()), pb_msg(3, out.encode()),
               pb_msg(4, op_type.encode())]
            + [pb_msg(5, onnx_attr(k, v)) for k, v in attrs.items()])))
        return out

    def const(self, value, dtype=np.float32):
        return self.op("Constant", value=np.asarray(value, dtype))

    def encode(self, inputs, output, opset=13):
        def value_info(name, elem, shape):
            dims = b"".join(pb_msg(1, pb_msg(2, str(d).encode())
                                   if isinstance(d, str) else pb_int(1, d))
                            for d in shape)
            tensor_type = pb_int(1, elem) + pb_msg(2, dims)
            return pb_msg(1, name.encode()) + pb_msg(2, pb_msg(1,
                                                              tensor_type))

        graph = b"".join(
            self.nodes + [pb_msg(2, b"zoo_import")] + self.inits
            + [pb_msg(11, value_info(n, 7, ("batch", "seq")))
               for n in inputs]
            + [pb_msg(12, value_info(output, 1, ("batch", "labels")))])
        return b"".join([pb_int(1, 8), pb_msg(2, b"chip_smoke"),
                         pb_msg(7, graph),
                         pb_msg(8, pb_msg(1, b"") + pb_int(2, opset))])


def bert_onnx_bytes(params, nhead):
    """BERTClassifier's weights as an ONNX graph in the exporters'
    vocabulary: Gather embeddings (positions sliced by a Shape chain),
    LayerNorm decomposed (ReduceMean / Sub / Pow / Sqrt / Div / Mul /
    Add), every Dense as MatMul + Add over an (in, out) initializer,
    heads split and merged by Shape -> Gather -> Unsqueeze -> Concat ->
    Reshape chains and Transpose, the mask through Unsqueeze / Cast / Sub
    / Mul, Softmax, and the model's GELU (the tanh form, as exported)."""
    (bname, bert), = [(k, v) for k, v in params.items() if k != "head"]
    w = OnnxWriter()

    def t(tree, *path):
        for k in path:
            tree = tree[k]
        return tree.detach().cpu().numpy()

    def dense(x, tree, prefix):
        k = w.init(f"{prefix}.weight", t(tree, "kernel"))
        b = w.init(f"{prefix}.bias", t(tree, "bias"))
        return w.op("Add", w.op("MatMul", x, k), b)

    def layer_norm(x, tree, prefix):
        mean = w.op("ReduceMean", x, axes=[-1])
        d = w.op("Sub", x, mean)
        var = w.op("ReduceMean", w.op("Pow", d, w.const(2.0)), axes=[-1])
        y = w.op("Div", d, w.op("Sqrt", w.op("Add", var, w.const(1e-5))))
        y = w.op("Mul", y, w.init(f"{prefix}.gamma", t(tree, "gamma")))
        return w.op("Add", y, w.init(f"{prefix}.beta", t(tree, "beta")))

    def dims(x, *idx):
        shape = w.op("Shape", x)
        return [w.op("Unsqueeze", w.op("Gather", shape, w.const(i, np.int64),
                                       axis=0), axes=[0]) for i in idx]

    hidden = bert["pooler"]["kernel"].shape[0]
    hd = hidden // nhead
    word = w.op("Gather", w.init("embeddings.word", t(bert, "word_embed")),
                "input_ids")
    typ = w.op("Gather", w.init("embeddings.type", t(bert, "type_embed")),
               "token_type_ids")
    max_pos = bert["pos_embed"].shape[0]
    ids_len, = dims("input_ids", 1)
    pos_ids = w.op("Slice", w.init("embeddings.position_ids", np.arange(
        max_pos, dtype=np.int64)[None]), w.const([0], np.int64), ids_len,
        w.const([1], np.int64))
    pos = w.op("Gather", w.init("embeddings.position",
                                t(bert, "pos_embed")), pos_ids)
    x = layer_norm(w.op("Add", w.op("Add", word, typ), pos),
                   bert["embed_ln"], "embeddings.ln")
    mask = w.op("Cast", w.op("Unsqueeze", "attention_mask", axes=[1, 2]),
                to=1)
    ext = w.op("Mul", w.op("Sub", w.const(1.0), mask), w.const(-10000.0))
    for i in range(len([k for k in bert if k.startswith("enc")])):
        blk, p = bert[f"enc{i}"], f"encoder.layer.{i}"
        b_dim, l_dim = dims(x, 0, 1)
        heads = w.op("Concat", b_dim, l_dim, w.const([nhead], np.int64),
                     w.const([hd], np.int64), axis=0)

        def split(name, perm, blk=blk, heads=heads, p=p, x=x):
            y = dense(x, blk["attn"][name], f"{p}.attention.{name}")
            return w.op("Transpose", w.op("Reshape", y, heads), perm=perm)

        q = split("q", [0, 2, 1, 3])
        k = split("k", [0, 2, 3, 1])
        v = split("v", [0, 2, 1, 3])
        scores = w.op("Add", w.op("Div", w.op("MatMul", q, k),
                                  w.const(float(np.sqrt(hd)))), ext)
        ctx = w.op("MatMul", w.op("Softmax", scores, axis=-1), v)
        merged = w.op("Concat", b_dim, l_dim, w.const([hidden], np.int64),
                      axis=0)
        ctx = w.op("Reshape", w.op("Transpose", ctx, perm=[0, 2, 1, 3]),
                   merged)
        x = layer_norm(w.op("Add", dense(ctx, blk["attn"]["o"],
                                         f"{p}.attention.o"), x),
                       blk["ln1"], f"{p}.ln1")
        h = dense(x, blk["ffn1"], f"{p}.ffn1")
        inner = w.op("Mul", w.const(float(np.sqrt(2.0 / np.pi))), w.op(
            "Add", h, w.op("Mul", w.const(0.044715),
                           w.op("Pow", h, w.const(3.0)))))
        gelu = w.op("Mul", w.op("Mul", w.const(0.5), h),
                    w.op("Add", w.const(1.0), w.op("Tanh", inner)))
        x = layer_norm(w.op("Add", dense(gelu, blk["ffn2"], f"{p}.ffn2"), x),
                       blk["ln2"], f"{p}.ln2")
    first = w.op("Gather", x, w.const(0, np.int64), axis=1)
    pooled = w.op("Tanh", dense(first, bert["pooler"], "pooler"))
    logits = dense(pooled, params["head"], "classifier")
    return w.encode(["input_ids", "token_type_ids", "attention_mask"],
                    logits)


def import_bert_requests(n, seed):
    """(ids, segments, mask) rows at L = 128: random lengths, padded with
    id 0 and mask 0 (the [CLS] slot is always real)."""
    rs = np.random.RandomState(seed)
    length = IMPORT_BERT["length"]
    rows = []
    for _ in range(n):
        real = rs.randint(8, length + 1)
        ids = rs.randint(1, BERT_BASE["vocab"], (1, length)).astype(np.int32)
        seg = np.zeros((1, length), np.int32)
        seg[0, rs.randint(1, real):real] = 1
        mask = np.zeros((1, length), np.int32)
        mask[0, :real] = 1
        ids[0, real:] = 0
        rows.append([ids, seg, mask])
    return rows


def rows_of(reqs):
    return [np.concatenate([r[i] for r in reqs]) for i in range(len(reqs[0]))]


def served_ms(torch, im, xs, n):
    """Wall ms per ``predict`` of one captured bucket (copies in and out
    included) and the device ms of its replay (the graph's own events)."""
    im.predict(xs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        im.predict(xs)
    wall = (time.perf_counter() - t0) * 1e3 / n
    prog = max(im._programs.values(), key=lambda p: (
        p.inputs[0].shape[0] == xs[0].shape[0], p.graph.replays))
    return {"wall_ms": wall, "device_ms": prog.replay_s() * 1e3,
            "rows_per_s": xs[0].shape[0] / wall * 1e3,
            "replays": prog.graph.replays}


def int8_product_cases(torch):
    """The int8 x int8 -> int32 product (``torch._int_mm`` behind
    ``int8_matmul``) at BERT-Base's Dense shapes, exact against a float64
    product, timed beside ``torch.matmul`` in f32 and bf16."""
    from analytics_zoo_tpu_torch.ops.quantization import int8_matmul

    out = []
    g = torch.Generator(device="cuda").manual_seed(SEED + 16)
    for m, k, n in INT8_MM_SHAPES:
        a = torch.randint(-127, 128, (m, k), device="cuda", generator=g,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), device="cuda", generator=g,
                          dtype=torch.int8)
        acc = int8_matmul(a, b)
        exact = bool(torch.equal(acc.double(), a.double() @ b.double()))
        af, bf = a.float(), b.float()
        ah, bh = af.bfloat16(), bf.bfloat16()
        case = {"m": m, "k": k, "n": n, "exact": exact,
                "int8_ms": device_ms(torch, lambda: int8_matmul(a, b), 50),
                "f32_ms": device_ms(torch, lambda: torch.matmul(af, bf), 50),
                "bf16_ms": device_ms(torch, lambda: torch.matmul(ah, bh),
                                     50),
                **bound(2 * m * k + 4 * m * n, 2 * m * n * k,
                        PEAK_BF16_FLOPS * 2)}
        out.append(case)
        if not exact:
            raise AssertionError(f"int8 product not exact: {case}")
    return out


def onnx_bert_leg(torch, root, card):
    """(a) BERT-Base written as ONNX from the port's seeded
    BERTClassifier, served in f32 against the native model, then int8
    (calibrated, 74 quantized Dense) behind DynamicBatcher."""
    from analytics_zoo_tpu_torch.deploy import DynamicBatcher, InferenceModel
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    cfg = IMPORT_BERT
    net = BERTClassifier(cfg["labels"], bert_config=dict(
        BERT_BASE, hidden_drop=0.0, attn_drop=0.0),
        generator=torch.Generator().manual_seed(SEED + 161))
    t0 = time.perf_counter()
    buf = bert_onnx_bytes(net.params(), BERT_BASE["nhead"])
    path = os.path.join(root, "bert_base.onnx")
    with open(path, "wb") as f:
        f.write(buf)
    write_s, size = time.perf_counter() - t0, len(buf)
    del buf
    native = InferenceModel.from_keras_net(net, batch_buckets=cfg["buckets"],
                                           name="bert_native")
    del net
    t0 = time.perf_counter()
    im32 = InferenceModel.load_onnx(path, batch_buckets=cfg["buckets"],
                                    name="bert_onnx_f32")
    load_s = time.perf_counter() - t0
    reqs = import_bert_requests(cfg["requests"], SEED + 162)
    xs = rows_of(reqs[:32])
    want = native.predict(xs)
    got32 = im32.predict(xs)
    err32 = float(np.abs(got32 - want).max())
    del native
    free_card(torch)
    cal = [rows_of(import_bert_requests(cfg["calib_rows"], SEED + 170 + i))
           for i in range(cfg["calib_batches"])]
    t0 = time.perf_counter()
    im8 = InferenceModel.load_onnx(path, int8=True, calibration_inputs=cal,
                                   batch_buckets=cfg["buckets"],
                                   name="bert_onnx_int8")
    quant_s = time.perf_counter() - t0
    qnodes = len(im8.onnx_program.quantized_nodes)
    for b in cfg["buckets"]:                    # eager, then captured
        for _ in range(2):
            im8.predict(rows_of(reqs[:b]))
    batcher = DynamicBatcher(im8, max_batch=32, max_latency_ms=2.0)
    t0 = time.perf_counter()
    ans8, lat = serve_requests(batcher, reqs, cfg["threads"])
    wall = time.perf_counter() - t0
    batcher.close()
    ref32 = im32.predict(rows_of(reqs))
    err8 = float(np.abs(ans8 - ref32).max())
    top = float(np.abs(ref32).max())
    agree = float(np.mean(ans8.argmax(-1) == ref32.argmax(-1)))
    timing = {}
    for name, im in (("f32", im32), ("int8", im8)):
        for b in cfg["buckets"]:
            timing[f"{name}_b{b}"] = served_ms(torch, im, rows_of(reqs[:b]),
                                               cfg["timed"])
    out = {"card": card, "onnx_bytes": size, "write_s": write_s,
           "load_s": load_s, "quantize_s": quant_s,
           "nodes": len(im32.onnx_program.nodes),
           "f32_max_abs_logit_diff_vs_native": err32,
           "quantized_nodes": qnodes,
           "act_scales": len(im8.onnx_program.act_scales),
           "int8_max_abs_logit_diff_vs_f32": err8, "f32_largest_logit": top,
           "int8_argmax_agreement": agree,
           "int8_served": {"requests": len(reqs), "wall_s": wall,
                           "p50_ms": float(np.percentile(lat, 50)),
                           "p99_ms": float(np.percentile(lat, 99))},
           "timing": timing,
           "int8_programs": programs_of(im8._programs),
           "int8_product": int8_product_cases(torch)}
    log("import_onnx_bert", json.dumps(out))
    if (err32 > IMPORT_BERT_TOL or qnodes < 74
            or not np.all(np.isfinite(ans8)) or ans8.shape != (
                len(reqs), cfg["labels"]) or err8 > IMPORT_INT8_REL * top):
        raise AssertionError(f"ONNX BERT-Base import failed: {out}")
    del im32, im8
    free_card(torch)
    return out


def caffe_resnet_native(torch, generator):
    """The port net whose weights the Caffe files carry: ResNet-50 in the
    deploy prototxt's form (the 7x7/2 stem on 3 pixels of zero padding,
    BatchNorm eps 1e-5, stride on the 1x1 branch2a and branch1 of each
    first block, the ceil-mode 3x3/2 max pool, the 7x7 average pool,
    fc1000, softmax), layers named as the prototxt's."""
    from analytics_zoo_tpu_torch.nn import Input, Model
    from analytics_zoo_tpu_torch.nn.layers import (
        Activation, BatchNormalization, Convolution2D, Dense,
        GlobalAveragePooling2D, MaxPooling2D, ZeroPadding2D, merge)

    def conv_bn(x, f, k, stride, conv, bn, relu=True):
        x = Convolution2D(f, k, k, subsample=(stride, stride),
                          border_mode="same", bias=False, name=conv)(x)
        x = BatchNormalization(epsilon=1e-5, name=bn)(x)
        return Activation("relu")(x) if relu else x

    inp = Input(shape=(224, 224, 3), name="data")
    x = Convolution2D(64, 7, 7, subsample=(2, 2), border_mode="valid",
                      bias=False, name="conv1")(ZeroPadding2D((3, 3))(inp))
    x = Activation("relu")(BatchNormalization(epsilon=1e-5,
                                              name="bn_conv1")(x))
    x = MaxPooling2D((3, 3), strides=(2, 2), border_mode="same")(x)
    for s, (blocks, f) in enumerate(CAFFE_RESNET["stages"]):
        for b in range(blocks):
            n = f"{s + 2}{'abcdef'[b]}"
            stride = 2 if b == 0 and s > 0 else 1
            short = (conv_bn(x, 4 * f, 1, stride, f"res{n}_branch1",
                             f"bn{n}_branch1", relu=False) if b == 0 else x)
            y = conv_bn(x, f, 1, stride, f"res{n}_branch2a",
                        f"bn{n}_branch2a")
            y = conv_bn(y, f, 3, 1, f"res{n}_branch2b", f"bn{n}_branch2b")
            y = conv_bn(y, 4 * f, 1, 1, f"res{n}_branch2c",
                        f"bn{n}_branch2c", relu=False)
            x = Activation("relu")(merge([short, y], mode="sum"))
    x = Dense(1000, name="fc1000")(GlobalAveragePooling2D()(x))
    model = Model(inp, Activation("softmax")(x), name="resnet50_caffe")
    model.build(generator)
    return model


def caffe_resnet_files(torch, net, root):
    """The deploy prototxt (KaimingHe/deep-residual-networks
    ResNet-50-deploy.prototxt's layers and names) and a caffemodel (V2
    ``layer`` records) carrying ``net``'s weights: kernels OIHW, BatchNorm
    blobs (mean, var, scale factor 1) with ``use_global_stats``, Scale
    (gamma, beta), InnerProduct (out, in)."""
    params = {k: {n: v.detach().cpu().numpy() for n, v in t.items()}
              for k, t in net.params().items()}
    state = {k: {n: v.detach().cpu().numpy() for n, v in t.items()}
             for k, t in net.state().items()}
    text = ['name: "ResNet-50"', 'input: "data"', "input_dim: 1",
            "input_dim: 3", "input_dim: 224", "input_dim: 224"]
    blobs = []

    def blob(arr):
        shape = b"".join(pb_int(1, d) for d in arr.shape)
        return pb_msg(7, shape) + pb_msg(5, np.ascontiguousarray(
            arr, "<f4").tobytes())

    def layer(name, *arrays):
        blobs.append(pb_msg(100, pb_msg(1, name.encode()) + b"".join(
            pb_msg(7, blob(a)) for a in arrays)))

    def conv(name, bottom, top, f, k, stride, pad):
        text.append(
            f'layer {{ bottom: "{bottom}" top: "{top}" name: "{name}" '
            f'type: "Convolution" convolution_param {{ num_output: {f} '
            f'kernel_size: {k} pad: {pad} stride: {stride} '
            f'bias_term: false }} }}')
        layer(name, params[name]["kernel"].transpose(3, 2, 0, 1))

    def bn_scale(bn, scale, top):
        text.append(f'layer {{ bottom: "{top}" top: "{top}" name: "{bn}" '
                    f'type: "BatchNorm" batch_norm_param {{ '
                    f'use_global_stats: true }} }}')
        text.append(f'layer {{ bottom: "{top}" top: "{top}" name: "{scale}" '
                    f'type: "Scale" scale_param {{ bias_term: true }} }}')
        layer(bn, state[bn]["moving_mean"], state[bn]["moving_var"],
              np.ones(1, np.float32))
        layer(scale, params[bn]["gamma"], params[bn]["beta"])

    def relu(top):
        text.append(f'layer {{ bottom: "{top}" top: "{top}" '
                    f'name: "{top}_relu" type: "ReLU" }}')

    conv("conv1", "data", "conv1", 64, 7, 2, 3)
    bn_scale("bn_conv1", "scale_conv1", "conv1")
    relu("conv1")
    text.append('layer { bottom: "conv1" top: "pool1" name: "pool1" '
                'type: "Pooling" pooling_param { kernel_size: 3 stride: 2 '
                'pool: MAX } }')
    prev = "pool1"
    for s, (blocks, f) in enumerate(CAFFE_RESNET["stages"]):
        for b in range(blocks):
            n = f"{s + 2}{'abcdef'[b]}"
            stride = 2 if b == 0 and s > 0 else 1
            if b == 0:
                conv(f"res{n}_branch1", prev, f"res{n}_branch1", 4 * f, 1,
                     stride, 0)
                bn_scale(f"bn{n}_branch1", f"scale{n}_branch1",
                         f"res{n}_branch1")
            bottom = prev
            for part, k, fo, st, pad in (("2a", 1, f, stride, 0),
                                         ("2b", 3, f, 1, 1),
                                         ("2c", 1, 4 * f, 1, 0)):
                top = f"res{n}_branch{part}"
                conv(top, bottom, top, fo, k, st, pad)
                bn_scale(f"bn{n}_branch{part}", f"scale{n}_branch{part}",
                         top)
                if part != "2c":
                    relu(top)
                bottom = top
            short = f"res{n}_branch1" if b == 0 else prev
            text.append(f'layer {{ bottom: "{short}" bottom: "{bottom}" '
                        f'top: "res{n}" name: "res{n}" type: "Eltwise" }}')
            relu(f"res{n}")
            prev = f"res{n}"
    text.append(f'layer {{ bottom: "{prev}" top: "pool5" name: "pool5" '
                f'type: "Pooling" pooling_param {{ kernel_size: 7 '
                f'stride: 1 pool: AVE }} }}')
    text.append('layer { bottom: "pool5" top: "fc1000" name: "fc1000" '
                'type: "InnerProduct" inner_product_param { '
                'num_output: 1000 } }')
    text.append('layer { bottom: "fc1000" top: "prob" name: "prob" '
                'type: "Softmax" }')
    layer("fc1000", params["fc1000"]["kernel"].T, params["fc1000"]["bias"])
    proto_path = os.path.join(root, "ResNet-50-deploy.prototxt")
    model_path = os.path.join(root, "ResNet-50-model.caffemodel")
    with open(proto_path, "w") as f:
        f.write("\n".join(text) + "\n")
    with open(model_path, "wb") as f:
        f.write(pb_msg(1, b"ResNet-50") + b"".join(blobs))
    return proto_path, model_path


def seeded_resnet_state(torch, net, seed):
    """Moving statistics and affine leaves away from the identity, with
    the residual branches' last gammas small, so the 16 blocks keep their
    activations in range, and a classifier whose logits spread."""
    from analytics_zoo_tpu_torch.convert import load_jax_params

    rs = np.random.RandomState(seed)
    params = {k: dict(v) for k, v in net.params().items()}
    state = {}
    for name, leaves in net.state().items():
        if not leaves:
            continue
        c = leaves["moving_mean"].shape[0]
        state[name] = {"moving_mean": (0.1 * rs.randn(c)).astype(np.float32),
                       "moving_var": (1 + 0.2 * rs.rand(c)).astype(
                           np.float32)}
        gamma = 0.2 if name.endswith("2c") else 1.0
        params[name] = {"gamma": (gamma * (1 + 0.1 * rs.randn(c))).astype(
                            np.float32),
                        "beta": (0.05 * rs.randn(c)).astype(np.float32)}
    # logits spread over a few units, so the softmax is far from flat
    fc = params["fc1000"]
    params["fc1000"] = {"kernel": (0.05 * rs.randn(*fc["kernel"].shape))
                        .astype(np.float32),
                        "bias": np.zeros(fc["bias"].shape, np.float32)}
    load_jax_params(net, params, state)


def import_fit(torch, prog, x, y, steps, lr, graphed, optimizer="sgd",
               epochs=1):
    """``to_model(prog)`` compiled on the card and fitted ``epochs`` epochs
    of ``steps`` batches of 32 (no shuffle), graphed or eager; returns
    (history, final params on the host, the model)."""
    import contextlib

    from analytics_zoo_tpu_torch.convert import export_params
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.onnx import to_model
    from analytics_zoo_tpu_torch.train import optimizers as opt

    model = to_model(prog)
    tx = opt.SGD(lr=lr) if optimizer == "sgd" else opt.Adam(lr=lr)
    model.compile(tx, "sparse_categorical_crossentropy", device="cuda")
    batch = CAFFE_RESNET["batch"]
    with contextlib.ExitStack() as stack:
        if not graphed:
            stack.enter_context(graphs.disabled())
        hist = model.fit(x[:steps * batch], y[:steps * batch],
                         batch_size=batch, nb_epoch=epochs, shuffle=False,
                         verbose=False)
    torch.cuda.synchronize()
    return hist, export_params(model), model


def caffe_resnet_leg(torch, root, card):
    """(b) ResNet-50 written as a Caffe prototxt + caffemodel from a
    seeded port net, imported with ``Net.load_caffe``, held against the
    port net (plain versions, f32, cuDNN deterministic) and served from a
    bucket graph; then ``to_model`` -> ``compile`` -> ``fit``, graphed
    against eager over 4 f32 steps."""
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.nn.net import Net
    from analytics_zoo_tpu_torch.onnx import to_model
    from analytics_zoo_tpu_torch.ops import dispatch

    cfg = CAFFE_RESNET
    net = caffe_resnet_native(torch, torch.Generator().manual_seed(SEED + 163))
    seeded_resnet_state(torch, net, SEED + 164)
    t0 = time.perf_counter()
    proto_path, model_path = caffe_resnet_files(torch, net, root)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog = Net.load_caffe(proto_path, model_path)
    load_s = time.perf_counter() - t0
    x, y = scene_images(cfg["rows"] * 2, 224, SEED + 165)
    xc = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    b = cfg["batch"]
    torch.backends.cudnn.deterministic = True
    try:
        ref_net = net.cuda().eval()
        with torch.no_grad(), dispatch.forced("reference"):
            want = ref_net(torch.from_numpy(x[:b]).cuda()).cpu().numpy()
        imported = to_model(prog).cuda().eval()
        with torch.no_grad(), dispatch.forced("reference"):
            eager = imported(torch.from_numpy(xc[:b]).cuda()).cpu().numpy()
    finally:
        torch.backends.cudnn.deterministic = False
    del ref_net, imported
    free_card(torch)
    im = InferenceModel.from_keras_net(to_model(prog), batch_buckets=(b,),
                                       name="resnet50_caffe")
    im.predict(xc[:b])                           # eager warm-up
    served = im.predict(xc[:b])                  # captured
    # the softmax outputs compared as centred log-probabilities: the
    # logits up to their common shift, so a flat softmax hides nothing
    def centred(p):
        lp = np.log(p.astype(np.float64))
        return lp - lp.mean(axis=-1, keepdims=True)

    top = float(np.abs(centred(want)).max())
    err_eager = float(np.abs(centred(eager) - centred(want)).max())
    err_served = float(np.abs(centred(served) - centred(want)).max())
    serve = served_ms(torch, im, [xc[:b]], 10)
    del im
    free_card(torch)
    hist, _, model = import_fit(torch, prog, xc, y, cfg["rows"] // b,
                                cfg["lr"], True, optimizer="adam",
                                epochs=cfg["epochs"])
    losses = [h["loss"] for h in hist]
    progs = programs_of(model.estimator._programs)
    del model
    free_card(torch)
    steps = cfg["graphed_steps"]
    torch.backends.cudnn.deterministic = True
    try:
        g_hist, g_params, gm = import_fit(torch, prog, xc, y, steps, 1e-2,
                                          True)
        del gm
        e_hist, e_params, em = import_fit(torch, prog, xc, y, steps, 1e-2,
                                          False)
        del em
    finally:
        torch.backends.cudnn.deterministic = False
    init = prog.params
    moved = np.sqrt(sum(float(np.sum((g_params[k] - init[k]) ** 2))
                        for k in init))
    apart = np.sqrt(sum(float(np.sum((g_params[k] - e_params[k]) ** 2))
                        for k in init))
    bits = all(np.array_equal(g_params[k], e_params[k]) for k in init)
    out = {"card": card, "caffemodel_bytes": os.path.getsize(model_path),
           "layers": len(prog.nodes), "params": len(prog.params),
           "write_s": write_s, "load_s": load_s,
           "max_abs_diff_eager_vs_port_plain": err_eager,
           "max_abs_diff_served_vs_port_plain": err_served,
           "largest_centred_log_prob": top,
           "largest_prob": float(want.max()), "top1_agreement": float(np.mean(
               served.argmax(-1) == want.argmax(-1))),
           "serve_b32": serve, "fit_losses": losses,
           "fit_programs": progs,
           "graphed_vs_eager": {"steps": steps,
                                "graphed_losses": [h["loss"]
                                                   for h in g_hist],
                                "eager_losses": [h["loss"] for h in e_hist],
                                "l2_apart": apart, "l2_moved": moved,
                                "bit_equal": bits}}
    log("import_caffe_resnet50", json.dumps(out))
    if (max(err_eager, err_served) > IMPORT_RESNET_REL * top
            or not losses[-1] < losses[0] or not np.isfinite(losses).all()
            or apart > GRAPHED_REL * moved or moved == 0):
        raise AssertionError(f"Caffe ResNet-50 import failed: {out}")
    return out


class Pb:
    """A length-delimited protobuf field built from parts (bytes, arrays
    or ``Pb``), written to a file without joining its large parts."""

    def __init__(self, field, *parts):
        self.field = field
        self.parts = [memoryview(np.ascontiguousarray(p)).cast("B")
                      if isinstance(p, np.ndarray) else p for p in parts]

    def body_size(self):
        return sum(p.size() if isinstance(p, Pb) else len(p)
                   for p in self.parts)

    def size(self):
        n = self.body_size()
        return len(pb_key(self.field, 2)) + len(pb_varint(n)) + n

    def write(self, f):
        f.write(pb_key(self.field, 2) + pb_varint(self.body_size()))
        for p in self.parts:
            if isinstance(p, Pb):
                p.write(f)
            else:
                f.write(p)


def write_bigdl(path, modules):
    """A BigDL ``.model`` (the reader's documented wire format) at
    ``path``: a Sequential of (name, type, weight, bias) modules whose
    tensors carry ids, the root's ``global_storage`` attribute mapping
    each id to its data (f32, little-endian)."""
    subs, entries = [], []

    def tensor(arr, tid, data):
        storage = [pb_int(9, tid + 100000)]
        if data:
            storage.insert(0, Pb(2, arr.astype("<f4")))
        return [Pb(2, b"".join(pb_varint(d) for d in arr.shape)),
                pb_int(4, 1), pb_int(6, arr.size), Pb(8, *storage),
                pb_int(9, tid)]

    tid = 0
    for name, kind, weight, bias in modules:
        body = [Pb(1, name.encode())]
        for field, arr in ((3, weight), (4, bias)):
            tid += 1
            entries.append(Pb(2, Pb(1, str(tid).encode()), Pb(
                2, Pb(10, *tensor(arr, tid, True)))))
            body.append(Pb(field, *tensor(arr, tid, False)))
        body.append(Pb(7, f"com.intel.analytics.bigdl.nn.{kind}".encode()))
        subs.append(Pb(2, *body))
    storage = Pb(8, Pb(1, b"global_storage"), Pb(
        2, Pb(14, Pb(1, b"global_storage"), *entries)))
    with open(path, "wb") as f:
        for part in [Pb(1, b"vgg-16")] + subs + [
                Pb(7, b"com.intel.analytics.bigdl.nn.Sequential"), storage]:
            part.write(f)


def vgg_name_map(net):
    """Analytics Zoo's vgg-16 names -> the port builder's."""
    dense = [layer.name for layer in net.layers
             if type(layer).__name__ == "Dense" and layer.name != "fc"]
    natives = [f"b{b}c{r}" for b, reps in enumerate((2, 2, 3, 3, 3))
               for r in range(reps)]
    out = dict(zip(VGG_REF_NAMES, natives))
    out.update(fc6=dense[0], fc7=dense[1], fc8="fc")
    return out


def bigdl_vgg_leg(torch, dq, root, card):
    """(c) VGG-16 written as a BigDL ``.model`` from a seeded port
    ``vgg16``, imported by name into another, served int8 (kernel 3 three
    times a replay) against the plain versions, then cut at the second
    4096 Dense (``new_graph``) and fine-tuned with a new 10-class head
    over the frozen backbone."""
    from analytics_zoo_tpu_torch.bigdl import import_weights_by_name
    from analytics_zoo_tpu_torch.convert import export_params
    from analytics_zoo_tpu_torch.deploy import DynamicBatcher, InferenceModel
    from analytics_zoo_tpu_torch.deploy.inference import (dequantize_pytree,
                                                          quantize_pytree)
    from analytics_zoo_tpu_torch.models.image import vgg16
    from analytics_zoo_tpu_torch.nn import Model
    from analytics_zoo_tpu_torch.nn.layers import Dense
    from analytics_zoo_tpu_torch.nn.net import GraphNet
    from analytics_zoo_tpu_torch.train import optimizers as opt

    cfg = IMPORT_VGG
    src = vgg16(1000, generator=torch.Generator().manual_seed(SEED + 166))
    names = vgg_name_map(src)
    inverse = {v: k for k, v in names.items()}
    mods = []
    for layer in src.layers:
        if layer.name not in inverse:
            continue
        w = layer.leaf("kernel").detach().numpy()
        w = (w.transpose(3, 2, 0, 1)[None] if w.ndim == 4 else w.T)
        mods.append((inverse[layer.name], "SpatialConvolution"
                     if w.ndim == 5 else "Linear", w,
                     layer.leaf("bias").detach().numpy()))
    t0 = time.perf_counter()
    path = os.path.join(root, "vgg-16.model")
    write_bigdl(path, mods)
    write_s = time.perf_counter() - t0
    del mods
    net = vgg16(1000, generator=torch.Generator().manual_seed(SEED + 167))
    names = vgg_name_map(net)           # its Dense layers' own auto names
    t0 = time.perf_counter()
    copied = import_weights_by_name(net, path, name_map=names)
    import_s = time.perf_counter() - t0
    want_tree, got_tree = export_params(src), export_params(net)
    same = all(np.array_equal(got_tree[names[inverse[k]]][n], v)
               for k, t in want_tree.items() if k in inverse
               for n, v in t.items())
    del src, want_tree, got_tree
    x = scene_images(cfg["rows"], 224, SEED + 168)[0]
    deq = dequantize_pytree(quantize_pytree(net.params(), bits=8))
    want = served_reference(torch, net, x, deq)
    im = InferenceModel.from_keras_net(net, weight_dtype="int8",
                                       batch_buckets=cfg["buckets"],
                                       name="vgg16_int8")
    for b in cfg["buckets"]:
        for _ in range(2):                      # eager, then captured
            im.predict(x[:b])
    before = sum(p.graph.replays for p in im._programs.values())
    dq.LAUNCHES.reset()
    batcher = DynamicBatcher(im, max_batch=32, max_latency_ms=2.0)
    singles, _ = serve_rows(batcher, [x[i:i + 1] for i in range(16)], 4)
    batcher.close()
    eights = [im.predict(x[16 + 8 * i:24 + 8 * i]) for i in range(2)]
    full = im.predict(x[32:64])
    launches = dq.LAUNCHES.value
    replays = sum(p.graph.replays for p in im._programs.values()) - before
    got = np.concatenate([singles] + eights + [full])
    top = float(np.abs(want).max())
    err = float(np.abs(got - want[:64]).max())
    progs = programs_of(im._programs)
    timing = {f"b{b}": served_ms(torch, im, [x[:b]], 10)
              for b in cfg["buckets"]}
    del im
    free_card(torch)
    # new_graph at the second 4096 Dense, features held against the
    # source net's intermediate output (a forward hook)
    cut = names["fc7"]
    net = net.cuda().eval()
    seen = []
    hook = net.subtree(cut).register_forward_hook(
        lambda m, i, o: seen.append(o.detach().clone()))
    gn = GraphNet(net).new_graph(cut)
    feats_model = gn.model.cuda().eval()
    with torch.no_grad():
        xt = torch.from_numpy(x[:8]).cuda()
        net(xt)
        feats = feats_model(xt)
    hook.remove()
    feat_diff = float((feats - seen[0]).abs().max())
    feat_top = float(seen[0].abs().max())
    # a new head over the frozen backbone
    head = Dense(cfg["head"], name="new_head")
    head.build(torch.Generator().manual_seed(SEED + 169), (2, 4096))
    tuned = Model(gn.model.inputs, head(gn.model.outputs[0]))
    tuned._output_shape = tuned.output_shape()
    backbone = [layer.name for layer in tuned.layers
                if layer.name != "new_head"]
    GraphNet(tuned).freeze(backbone)
    frozen_before = {k: v for k, v in export_params(tuned).items()
                     if k in backbone}
    head_before = export_params(tuned)["new_head"]
    tuned.compile(opt.Adam(lr=cfg["lr"]),
                  "sparse_categorical_crossentropy_with_logits",
                  device="cuda")
    labels = np.random.RandomState(SEED + 170).randint(
        0, cfg["head"], cfg["rows"]).astype(np.int32)
    hist = tuned.fit(x, labels, batch_size=cfg["batch"],
                     nb_epoch=cfg["epochs"], verbose=False)
    after = export_params(tuned)
    frozen_kept = all(np.array_equal(after[k][n], v)
                      for k, t in frozen_before.items() for n, v in t.items())
    head_moved = any(not np.array_equal(after["new_head"][n], v)
                     for n, v in head_before.items())
    losses = [h["loss"] for h in hist]
    out = {"card": card, "model_bytes": os.path.getsize(path),
           "write_s": write_s, "import_s": import_s, "copied": len(copied),
           "import_equal": same, "int8_max_abs_err_vs_plain": err,
           "largest_logit": top, "dequant_matmul_launches": launches,
           "replays": replays, "programs": progs, "timing": timing,
           "new_graph_feature_max_abs_diff": feat_diff,
           "new_graph_feature_largest": feat_top,
           "fine_tune_losses": losses, "frozen_kept": frozen_kept,
           "head_moved": head_moved}
    log("import_bigdl_vgg16", json.dumps(out))
    bad = (not same or len(copied) != 16 or err > IMPORT_VGG_REL * top
           or launches != 3 * replays or replays == 0
           or any(v["launches_per_replay"] != {"dequant_matmul": 3}
                  for v in progs.values())
           or feat_diff > 1e-6 * feat_top or not frozen_kept or not head_moved
           or not losses[-1] < losses[0])
    if bad:
        raise AssertionError(f"BigDL VGG-16 import failed: {out}")
    del tuned, gn, feats_model, net
    free_card(torch)
    return out


def torch_vgg11(torch, classes=1000):
    """torchvision's VGG-11 ('A') layer sequence, seeded: features, the
    7x7 flatten, the 4096-4096-classes classifier (torchvision's
    AdaptiveAvgPool2d((7, 7)) is the identity at 224x224 and is left
    out: it is not in the converter's vocabulary)."""
    nn = torch.nn
    torch.manual_seed(SEED + 171)
    layers, cin = [], 3
    for v in (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
              "M"):
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
            cin = v
    layers += [nn.Flatten(), nn.Linear(512 * 7 * 7, 4096), nn.ReLU(),
               nn.Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(),
               nn.Dropout(0.5), nn.Linear(4096, classes)]
    return nn.Sequential(*layers).eval()


def torch_vgg_leg(torch, card):
    """(d) ``Net.load_torch`` on the VGG-11 sequence at 224x224 against
    the torch module on the card, then 2 steps under
    ``TorchCriterion(CrossEntropyLoss())``."""
    from analytics_zoo_tpu_torch.nn.net import Net
    from analytics_zoo_tpu_torch.tfpark import TorchCriterion, TorchModel
    from analytics_zoo_tpu_torch.train import optimizers as opt

    cfg = IMPORT_VGG11
    vgg = torch_vgg11(torch)
    t0 = time.perf_counter()
    tm = Net.load_torch(vgg)
    convert_s = time.perf_counter() - t0
    x = scene_images(cfg["train_rows"], 224, SEED + 172)[0]
    xc = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    module = vgg.cuda()
    with torch.no_grad():
        want = module(xc[:cfg["batch"]].cuda()).cpu().numpy()
    got = tm.predict(xc[:cfg["batch"]].numpy(), batch_size=cfg["batch"])
    err = float(np.abs(got - want).max())
    del module
    trainer = TorchModel(vgg.cpu(), optimizer=opt.SGD(lr=cfg["lr"]),
                         loss=TorchCriterion(torch.nn.CrossEntropyLoss()))
    y = np.arange(cfg["train_rows"], dtype=np.int32) % 1000
    hist = trainer.fit(xc.numpy(), y, batch_size=cfg["train_rows"],
                       epochs=2, verbose=False)
    losses = [h["loss"] for h in hist]
    out = {"card": card, "convert_s": convert_s,
           "max_abs_diff_vs_torch": err, "largest": float(np.abs(want).max()),
           "criterion_losses": losses,
           "params": sum(v.numel() for v in tm.model.parameters())}
    log("import_torch_vgg11", json.dumps(out))
    if (err > cfg["tol"] or got.shape != want.shape
            or not np.all(np.isfinite(losses)) or not losses[1] < losses[0]):
        raise AssertionError(f"torch VGG-11 import failed: {out}")
    del tm, trainer
    free_card(torch)
    return out


def int8_dot_case(torch, dq, m, k, n, iters=200):
    """``int8_dot(weight_only=True)`` (kernel 3) at ``(m, k, n)`` against
    ``dequant_matmul``'s plain version, timed beside it."""
    from analytics_zoo_tpu_torch.ops.quantization import int8_dot

    rs = np.random.RandomState(SEED + m + k)
    q, scale = dq.quantize_weights(torch.from_numpy(
        rs.randn(k, n).astype(np.float32)), bits=8)
    q, scale = q.cuda(), scale.cuda()
    x = torch.from_numpy(rs.randn(m, k).astype(np.float32)).cuda()
    out = int8_dot(x, q, scale, weight_only=True)
    ref = dq.dequant_matmul_reference(x, q, scale)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    top = float(ref.abs().max())
    w_lib = q.float() * scale
    case = {"case": "int8_dot_weight_only", "m": m, "k": k, "n": n,
            "bits": 8, "dtype": "float32", "out_dtype": "float32",
            "max_abs_err": err, "max_rel_err": err / max(top, 1e-30),
            **dq_bound(torch, torch.float32, 4 * m * k + k * n + 4 * n
                       + 4 * m * n, 2 * m * n * k),
            "library_call": "torch.matmul(x, dequant(q))",
            **timings(torch, {
                "kernel": lambda: int8_dot(x, q, scale, weight_only=True),
                "plain": lambda: dq.dequant_matmul_reference(x, q, scale),
                "library": lambda: torch.matmul(x, w_lib)}, iters)}
    if err > 1e-4 * top:
        raise AssertionError(f"int8_dot(weight_only) disagrees: {case}")
    return case


def import_kernel_cases(torch, dq):
    """Kernel 3 at VGG-16's Dense shapes (M = 1, 8, 32; int8 and int4;
    f32 x) and ``int8_dot(weight_only=True)`` at ResNet-50's head."""
    cases = []
    for label, k, n in VGG_DENSE:
        for bits in (8, 4):
            for m in (1, 8, 32):
                cases.append(dq_case(torch, dq, label, m, k, n, bits,
                                     iters=20 if k > 4096 else 50))
    for m in (1, 32):
        cases.append(int8_dot_case(torch, dq, m, 2048, 1000, iters=50))
    for c in cases:
        log("kernel_case", json.dumps(c))
    return cases


def model_import_phase(torch, dq, card):
    """Phase 16: model import and int8 post-training quantization on the
    card, every file written to a temporary directory and removed after;
    returns kernel 3's launches on the VGG-16 int8 serving path."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="zoo_import_")
    try:
        bert = onnx_bert_leg(torch, root, card)
        caffe = caffe_resnet_leg(torch, root, card)
        vgg = bigdl_vgg_leg(torch, dq, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tvgg = torch_vgg_leg(torch, card)
    summary = {
        "card": card, "seconds": time.perf_counter() - t_phase,
        "bert_f32_vs_native": bert["f32_max_abs_logit_diff_vs_native"],
        "bert_quantized_nodes": bert["quantized_nodes"],
        "bert_int8_vs_f32": bert["int8_max_abs_logit_diff_vs_f32"],
        "bert_int8_argmax_agreement": bert["int8_argmax_agreement"],
        "bert_ms_per_batch": {k: v["device_ms"]
                              for k, v in bert["timing"].items()},
        "resnet50_caffe_vs_port": caffe["max_abs_diff_served_vs_port_plain"],
        "resnet50_caffe_losses": caffe["fit_losses"],
        "vgg16_int8_err": vgg["int8_max_abs_err_vs_plain"],
        "vgg16_launches": [vgg["dequant_matmul_launches"], vgg["replays"]],
        "vgg16_fine_tune_losses": vgg["fine_tune_losses"],
        "vgg11_vs_torch": tvgg["max_abs_diff_vs_torch"]}
    log("model_import_summary", json.dumps(summary))
    return {"vgg16_int8_serving": vgg["dequant_matmul_launches"]}


# ---------------------------------------------------------------------------
# phase 17: int8 / int4 BERT-Base served from the native model, and the
# layer vocabulary (SparseEmbedding, WordEmbedding, the merge modes,
# advanced activations, torch-style layers, keras2) on the card

QBERT = dict(length=128, buckets=(1, 8, 32), requests=64, threads=4,
             cluster_records=512)
# the quantized model through the kernels against the same model through
# the plain versions (dispatch.forced("reference")), max abs logit:
# phase 3's bound for f32 BERT-Base (K-long f32 sums in another order,
# carried through 12 blocks)
QBERT_PLAIN_TOL = 1e-3
# Dense layers of one BERT-Base forward on kernel 3: q, k, v, o, ffn1 and
# ffn2 in each block, the pooler and the head (768 x 2 = 1536 elements,
# over quantize_pytree's 1,024-element floor)
QBERT_DQ_PER_FORWARD = 6 * BERT_BASE["n_block"] + 2
# SparseEmbedding at kernel 1's bench shape: a 256 MB table (a CTR
# feature's size), 32 ids a bag, about a quarter of them the pad id
SPARSE = dict(vocab=1 << 20, dim=64, bags=4096, nnz=32, pad_id=0,
              steps=8, epochs=3, lr=1e-2)
# a GloVe-format file at the TextClassifier's reference width, feeding
# its layers with the table frozen
GLOVE = dict(words=5001, dim=200, rows=1024, batch=128, epochs=2, lr=1e-3)
VOCAB_NET = dict(rows=32, buckets=(8, 32), vocab=1000, width=32)


def qbert_kernel_cases(torch, dq):
    """Kernel 3 at BERT-Base's block shapes ((768, 768) for q, k, v and o;
    (768, 3072) ffn1; (3072, 768) ffn2): M = 1024 in int8 and int4, and
    M = 4096 in int4 where the kernel phase times int8 only."""
    cases = []
    for m in (1024, 4096):
        for k, n in ((768, 768), (768, 3072), (3072, 768)):
            for bits in (8, 4):
                if m == 4096 and (bits == 8 or (k, n) == (768, 3072)):
                    continue                    # in the kernel phase
                cases.append(dq_case(torch, dq, "bert_block", m, k, n, bits,
                                     iters=50))
    for c in cases:
        log("kernel_case", json.dumps(c))
    return cases


def fc6_f64_case(torch, dq):
    """VGG-16's fc6 (K = 25088, N = 4096, int8, f32 x of post-ReLU sign)
    at M = 1, 8, 32 through kernel 3 and through its plain version, each
    against an f64 product of the same dequantized weights, beside the
    summation bound K * 2^-24 * sum_k |x_ik| |w_kj| of an f32 sum of K
    rounded products in any order.  A kernel over the bound where the
    plain version is within it is the kernel's fault."""
    k, n = 25088, 4096
    rs = np.random.RandomState(SEED + 251)
    q, scale = dq.quantize_weights(torch.from_numpy(
        (rs.randn(k, n) * 0.01).astype(np.float32)), bits=8)
    q, scale = q.cuda(), scale.cuda()
    w64 = q.double() * scale.double().reshape(1, -1)
    rows = []
    for m in (1, 8, 32):
        x = torch.from_numpy(np.abs(rs.randn(m, k)).astype(np.float32)).cuda()
        exact = x.double() @ w64
        limit = k * 2.0 ** -24 * (x.double().abs() @ w64.abs())
        row = {"m": m, "largest": float(exact.abs().max()),
               "bound_max": float(limit.max())}
        for name, got in (("kernel", dq.dequant_matmul(x, q, scale)),
                          ("plain", dq.dequant_matmul_reference(x, q, scale))):
            err = (got.double() - exact).abs()
            row[f"{name}_max_abs_err"] = float(err.max())
            row[f"{name}_max_err_over_bound"] = float((err / limit).max())
        rows.append(row)
    del w64
    torch.cuda.empty_cache()
    fault = any(r["kernel_max_err_over_bound"] > 1.0
                and r["plain_max_err_over_bound"] <= 1.0 for r in rows)
    out = {"case": "vgg16_fc6_vs_f64", "k": k, "n": n, "bits": 8,
           "rows": rows, "kernel_fault": fault,
           "both_within_bound": all(r["kernel_max_err_over_bound"] <= 1.0
                                    and r["plain_max_err_over_bound"] <= 1.0
                                    for r in rows)}
    log("c4_fc6_f64", json.dumps(out))
    if fault:
        raise AssertionError(f"kernel 3 at fc6 is over the summation bound "
                             f"where its plain version is not: {out}")
    return out


def cluster_records_leg(torch, name, im, recs, ref, card):
    """``recs`` (one row a record) behind one ``ClusterServing`` worker
    over a ``ShmQueue`` from a client thread of this process; every
    record's top-2 held against ``ref``, the plain path's scores
    (``cluster_check``).  Returns the leg's numbers."""
    from analytics_zoo_tpu_torch.deploy import (ClusterServing, InputQueue,
                                                OutputQueue, ServingConfig,
                                                ShmQueue)
    from analytics_zoo_tpu_torch.observe.metrics import METRICS

    n = len(recs)
    queue = ShmQueue(name=f"smoke_{name}", slots=1024, slot_bytes=1 << 12,
                     result_slots=1024, result_slot_bytes=1 << 10)
    cfg = ServingConfig(postprocess_top_n=CLUSTER_TOP_N, batch_size=32,
                        max_batch_delay_ms=2.0, decode_workers=4)
    cs = ClusterServing({name: im}, queue, cfg)
    iq, oq = InputQueue(queue), OutputQueue(queue)
    answers = {}
    try:
        cs.start()
        window = METRICS.snapshot()
        t0 = time.perf_counter()
        pusher = threading.Thread(target=lambda: [
            iq.enqueue(uri=f"{name}{r}", model=name, x=recs[r])
            for r in range(n)])
        pusher.start()
        deadline = time.monotonic() + 120
        while len(answers) < n and time.monotonic() < deadline:
            answers.update(oq.dequeue(timeout=0.5))
        wall = time.perf_counter() - t0
        pusher.join(timeout=60)
        delta = METRICS.delta(window)
    finally:
        cs.stop(timeout=30)
        del cs
        queue.stop()
    idx = np.full((n, CLUSTER_TOP_N), -1, np.int64)
    val = np.full((n, CLUSTER_TOP_N), np.nan, np.float64)
    for r in range(n):
        a = answers.get(f"{name}{r}")
        if isinstance(a, list) and len(a) == CLUSTER_TOP_N:
            idx[r] = [p[0] for p in a]
            val[r] = [p[1] for p in a]
    check = cluster_check("bert", idx, val, ref)
    out = {"card": card, "records": n, "answered": len(answers),
           "wall_s": wall, "records_per_s": n / wall, "check": check,
           "stages": stage_rollup(delta).get(name),
           "device_busy": device_busy(delta, wall)}
    if len(answers) != n or not check["ok"]:
        raise AssertionError(f"{name} ClusterServing failed: {out}")
    return out


def qbert_leg(torch, eb, dq, fa, card):
    """(a) ``BERTClassifier(2, BERT_BASE)`` from a seed, served at L = 128
    in f32, int8 and int4 through ``InferenceModel.from_keras_net``
    (buckets 1, 8, 32, one CUDA graph each).  For int8 and int4: 64
    single requests behind a ``DynamicBatcher`` from 4 threads, every
    quantized Dense on kernel 3 (74 a replay) and attention on kernel 4
    (12 a replay); the answers against the plain versions within
    ``QBERT_PLAIN_TOL`` and against the f32 model; weight bytes; device
    ms a replay at buckets 8 and 32 beside the f32 model's; the device ms
    of dequantizing the three embedding tables, which a replay runs; and
    512 records through ``ClusterServing`` over a ``ShmQueue``."""
    from analytics_zoo_tpu_torch.core.context import init_zoo_context
    from analytics_zoo_tpu_torch.deploy import DynamicBatcher, InferenceModel
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.ops.dequant_matmul import dequantize_leaf
    from analytics_zoo_tpu_torch.ops.dispatch import PATH_REFERENCE, forced
    from analytics_zoo_tpu_torch.tfpark import BERTClassifier

    cfg = QBERT
    init_zoo_context()
    reset_name_scope()
    net = BERTClassifier(num_classes=2, bert_config=BERT_BASE,
                         generator=torch.Generator().manual_seed(SEED + 171))
    reqs = bert_requests(cfg["requests"], cfg["length"], SEED + 172)
    xs = batch_of(reqs)
    models, out = {}, {"card": card, "model": {
        **BERT_BASE, "num_classes": 2, "length": cfg["length"]}}
    for wd in ("float32", "int8", "int4"):
        t0 = time.perf_counter()
        im = InferenceModel.from_keras_net(net, device="cuda",
                                           weight_dtype=wd,
                                           batch_buckets=cfg["buckets"],
                                           name=f"bert_{wd}")
        for b in cfg["buckets"]:
            for _ in range(2):                  # eager, then captured
                im.predict([x[:b] for x in xs])
        models[wd] = im
        out[wd] = {"setup_s": time.perf_counter() - t0,
                   "weight_nbytes": im.weight_nbytes()}
    del net
    f32 = models["float32"].predict(xs)
    out["float32"]["timing"] = {f"b{b}": served_ms(
        torch, models["float32"], [x[:b] for x in xs], 10) for b in (8, 32)}
    recs = np.random.RandomState(SEED + 173).randint(
        0, BERT_BASE["vocab"], (cfg["cluster_records"], cfg["length"])
    ).astype(np.int32)
    launches = {}
    for wd in ("int8", "int4"):
        im, rec = models[wd], out[wd]
        # one replay at bucket 32
        reset_counts(eb, dq, fa)
        im.predict([x[:32] for x in xs])
        rec["per_replay"] = {"dequant_matmul": dq.LAUNCHES.value,
                             "flash_attention": fa.LAUNCHES.value}
        # the main path: single requests through the batcher
        before = sum(p.graph.replays for p in im._programs.values())
        reset_counts(eb, dq, fa)
        batcher = DynamicBatcher(im, max_batch=32, max_latency_ms=2.0)
        t0 = time.perf_counter()
        ans, lat = serve_requests(batcher, reqs, cfg["threads"])
        wall = time.perf_counter() - t0
        batcher.close()
        torch.cuda.synchronize()
        replays = sum(p.graph.replays for p in im._programs.values()) - before
        launches[wd] = {"dequant_matmul": dq.LAUNCHES.value,
                        "flash_attention": fa.LAUNCHES.value,
                        "embedding_bag": eb.LAUNCHES.value}
        with forced(PATH_REFERENCE):
            plain = im.predict(xs)
        top = float(np.abs(f32).max())
        rec.update({
            "requests": len(lat), "batcher_wall_s": wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "replays": replays, "launches": launches[wd],
            "programs": programs_of(im._programs),
            "max_abs_logit_diff_vs_plain": float(np.abs(ans - plain).max()),
            "max_abs_logit_diff_vs_f32": float(np.abs(ans - f32).max()),
            "largest_f32_logit": top,
            "argmax_agreement_vs_f32": float(np.mean(
                ans.argmax(1) == f32.argmax(1))),
            "timing": {f"b{b}": served_ms(torch, im, [x[:b] for x in xs], 10)
                       for b in (8, 32)}})
        rec["rel_logit_diff_vs_f32"] = (rec["max_abs_logit_diff_vs_f32"]
                                        / max(top, 1e-30))
        bert = im._net.bert
        tables = [bert.qleaf(t) for t in ("word_embed", "pos_embed",
                                          "type_embed")]
        rec["table_kinds"] = [sorted(set(t) - {"scale"}) for t in tables]
        rec["embedding_dequantize_ms"] = device_ms(
            torch, lambda: [dequantize_leaf(t) for t in tables], 20)
        with forced(PATH_REFERENCE):
            ref = np.concatenate([im.predict(recs[s:s + 32])
                                  for s in range(0, len(recs), 32)])
        rec["cluster_serving"] = cluster_records_leg(
            torch, f"bert_{wd}", im, recs, ref, card)
        ok = (rec["per_replay"] == {"dequant_matmul": QBERT_DQ_PER_FORWARD,
                                    "flash_attention": BERT_BASE["n_block"]}
              and replays > 0
              and launches[wd]["dequant_matmul"]
              == QBERT_DQ_PER_FORWARD * replays
              and launches[wd]["flash_attention"]
              == BERT_BASE["n_block"] * replays
              and not launches[wd]["embedding_bag"]
              and all(v["launches_per_replay"] == {
                  "dequant_matmul": QBERT_DQ_PER_FORWARD,
                  "flash_attention": BERT_BASE["n_block"]}
                  for v in rec["programs"].values())
              and ans.shape == (len(reqs), 2)
              and bool(np.all(np.isfinite(ans)))
              and rec["max_abs_logit_diff_vs_plain"] <= QBERT_PLAIN_TOL
              and None not in tables)
        log("quantized_bert", json.dumps({"weight_dtype": wd, **rec}))
        if not ok:
            raise AssertionError(f"{wd} BERT-Base serving failed: {rec}")
    log("quantized_bert_f32", json.dumps(out["float32"]))
    del models, im
    free_card(torch)
    return out, launches


def sparse_ids(torch, g, bags=SPARSE["bags"]):
    cfg = SPARSE
    ids = torch.randint(0, cfg["vocab"], (bags, cfg["nnz"]), device="cuda",
                        generator=g, dtype=torch.int32)
    ids[torch.rand(ids.shape, device="cuda", generator=g) < 0.25] = \
        cfg["pad_id"]
    ids[0] = cfg["pad_id"]                      # an all-pad bag
    return ids


def sparse_embedding_leg(torch, eb, card):
    """(b) ``SparseEmbedding`` at kernel 1's bench shape (V = 2^20, D =
    64, B = 4096, 32 ids a bag, pad id 0) with sum, mean and sqrtn: the
    layer's forward and its table gradient through kernels 1 and 2
    against the plain versions (forward within 1e-5 + 1e-5 |plain|, the
    gradient within 1e-6 + 1e-5 of each element's summed magnitude, as
    the kernel phase holds them), each timed; then a CTR-shaped net
    (``SparseEmbedding(mean)`` -> ``Dense(1, sigmoid)``) trained through
    ``compile`` / ``fit`` (graphed steps), one launch of each kernel a
    step, the loss falling."""
    from analytics_zoo_tpu_torch.nn import Sequential, reset_name_scope
    from analytics_zoo_tpu_torch.nn.layers import Dense, SparseEmbedding
    from analytics_zoo_tpu_torch.ops.dispatch import PATH_REFERENCE, forced
    from analytics_zoo_tpu_torch.train.optimizers import Adam

    cfg = SPARSE
    v, d, pad = cfg["vocab"], cfg["dim"], cfg["pad_id"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 181)
    ids = sparse_ids(torch, g)
    grad_out = torch.randn(cfg["bags"], d, device="cuda", generator=g)
    out = {"card": card, **cfg, "layer": {}}
    fwd_cases, bwd_cases = [], []
    for combiner in ("sum", "mean", "sqrtn"):
        reset_name_scope()
        layer = SparseEmbedding(v, d, combiner=combiner, pad_id=pad)
        layer.build(torch.Generator().manual_seed(SEED + 182),
                    (cfg["bags"], cfg["nnz"]))
        layer = layer.cuda()
        table = layer.leaf("table")

        def run():
            table.grad = None
            y = layer(ids)
            (y * grad_out).sum().backward()
            return y.detach(), table.grad.detach().clone()

        eb.LAUNCHES.reset()
        eb.BWD_LAUNCHES.reset()
        y_k, g_k = run()
        launched = [eb.LAUNCHES.value, eb.BWD_LAUNCHES.value]
        with forced(PATH_REFERENCE):
            y_p, g_p = run()
        mass = eb.embedding_bag_backward_reference(v, ids, grad_out.abs(),
                                                   combiner, pad)
        fwd_err = (y_k - y_p).abs()
        bwd_err = (g_k - g_p).abs()
        fwd_ok = bool(torch.all(fwd_err <= 1e-5 + 1e-5 * y_p.abs()))
        bwd_ok = bool(torch.all(bwd_err <= 1e-6 + 1e-5 * mass))
        row = {"launches": launched,
               "fwd_max_abs_err": float(fwd_err.max()),
               "bwd_max_abs_err": float(bwd_err.max()),
               "pad_row_grad": float(g_k[pad].abs().max())}
        del g_k, g_p, mass, bwd_err
        with torch.no_grad():
            row.update(timings(torch, {
                "kernel": lambda: layer(ids),
                "plain": lambda: eb.embedding_bag_reference(
                    table, ids, combiner, pad)}, 50))
        out["layer"][combiner] = row
        table.grad = None
        del layer, table
        torch.cuda.empty_cache()
        if not (fwd_ok and bwd_ok and launched == [1, 1]
                and row["pad_row_grad"] == 0.0):
            raise AssertionError(f"SparseEmbedding {combiner}: {row}")
        # the kernels alone on these ids (each case pads a further
        # quarter of the slots): bound, plain version and library call
        label = f"sparse_embedding_{combiner}"
        fwd_cases.append(bag_case(torch, eb, label, v, d, cfg["bags"],
                                  cfg["nnz"], combiner, pad, iters=50,
                                  ids=ids.clone()))
        bwd_cases.append(bag_bwd_case(torch, eb, label, v, d, cfg["bags"],
                                      cfg["nnz"], combiner, pad, iters=50,
                                      ids=ids.clone()))
    for c in fwd_cases + bwd_cases:
        log("kernel_case", json.dumps(c))
    # trained through compile / fit
    rows = cfg["steps"] * cfg["bags"]
    x = sparse_ids(torch, torch.Generator(device="cuda").manual_seed(
        SEED + 183), rows).cpu().numpy()
    hidden = np.random.RandomState(SEED + 184).randn(v).astype(np.float32)
    live = x != pad
    score = (hidden[x] * live).sum(1) / np.maximum(live.sum(1), 1)
    y = (score > 0).astype(np.float32)[:, None]
    reset_name_scope()
    net = Sequential([SparseEmbedding(v, d, combiner="mean", pad_id=pad,
                                      input_shape=(cfg["nnz"],),
                                      name="ctr_feature"),
                      Dense(1, activation="sigmoid", name="ctr_head")])
    net.build(torch.Generator().manual_seed(SEED + 185))
    net.compile(Adam(lr=cfg["lr"]), "binary_crossentropy", device="cuda")
    eb.LAUNCHES.reset()
    eb.BWD_LAUNCHES.reset()
    t0 = time.perf_counter()
    hist = net.fit(x, y, batch_size=cfg["bags"], nb_epoch=cfg["epochs"],
                   shuffle=False, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    steps = cfg["steps"] * cfg["epochs"]
    launched = {"embedding_bag_fwd": eb.LAUNCHES.value,
                "embedding_bag_bwd": eb.BWD_LAUNCHES.value}
    losses = [h["loss"] for h in hist]
    out["cases"] = (fwd_cases, bwd_cases)
    out["fit"] = {"steps": steps, "wall_s": fit_s, "losses": losses,
                  "launches": launched,
                  "programs": programs_of(net.estimator._programs)}
    log("sparse_embedding", json.dumps(
        {k: v for k, v in out.items() if k != "cases"}))
    del net
    free_card(torch)
    if (launched != {"embedding_bag_fwd": steps, "embedding_bag_bwd": steps}
            or not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]):
        raise AssertionError(f"SparseEmbedding training: {out['fit']}")
    return out, launched


def glove_leg(torch, eb, card):
    """(c) A seeded GloVe-format file of 5001 words x 200 (the
    TextClassifier's reference width; ids 1 .. 5000 in the vocabulary,
    the last word not) read by ``WordEmbedding.from_glove`` into a
    frozen table that feeds the TextClassifier's layers; a few graphed
    steps train the rest.  The table must come out of ``fit`` equal to
    the file's vectors bit for bit, with kernel 1 launched once a step
    and kernel 2 never."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.nn import Sequential, reset_name_scope
    from analytics_zoo_tpu_torch.nn.layers import (Convolution1D, Dense,
                                                   GlobalMaxPooling1D,
                                                   WordEmbedding)
    from analytics_zoo_tpu_torch.train.optimizers import Adam

    cfg = GLOVE
    rs = np.random.RandomState(SEED + 191)
    vectors = (rs.randn(cfg["words"], cfg["dim"]) * 0.3).astype(np.float32)
    words = [f"w{i}" for i in range(cfg["words"])]
    word_index = {w: i + 1 for i, w in enumerate(words[:-1])}
    root = tempfile.mkdtemp(prefix="zoo_glove_")
    try:
        path = os.path.join(root, f"glove.6B.{cfg['dim']}d.txt")
        t0 = time.perf_counter()
        lines = [w + " " + " ".join(f"{a:.6f}" for a in vec)
                 for w, vec in zip(words, vectors)]
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        write_s = time.perf_counter() - t0
        reset_name_scope()
        t0 = time.perf_counter()
        emb = WordEmbedding.from_glove(
            path, word_index, name="glove_embed",
            input_shape=(TEXT_CONFIG["sequence_length"],))
        read_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # the file's vectors as numpy reads them; the last word is not in
    # the vocabulary, and row 0 is the pad
    want = np.zeros((cfg["words"], cfg["dim"]), np.float32)
    want[1:] = np.asarray([ln.split(" ")[1:] for ln in lines[:-1]],
                          np.float32)
    net = Sequential([emb, Convolution1D(256, 5, activation="relu"),
                      GlobalMaxPooling1D(), Dense(128, activation="relu"),
                      Dense(TEXT_CONFIG["class_num"])])
    net.build(torch.Generator().manual_seed(SEED + 192))
    net.compile(Adam(lr=cfg["lr"]), TEXT_LOSS, device="cuda")
    x, y = text_corpus(cfg["rows"], SEED + 193)
    before = emb.leaf("table").detach().cpu().clone()
    eb.LAUNCHES.reset()
    eb.BWD_LAUNCHES.reset()
    hist = net.fit(x, y, batch_size=cfg["batch"], nb_epoch=cfg["epochs"],
                   verbose=False)
    torch.cuda.synchronize()
    launched = {"embedding_bag_fwd": eb.LAUNCHES.value,
                "embedding_bag_bwd": eb.BWD_LAUNCHES.value}
    after = emb.leaf("table").detach().cpu()
    steps = cfg["epochs"] * cfg["rows"] // cfg["batch"]
    losses = [h["loss"] for h in hist]
    out = {"card": card, "words": cfg["words"], "dim": cfg["dim"],
           "file_bytes": file_bytes, "write_s": write_s, "read_s": read_s,
           "table_equals_file": bool(np.array_equal(before.cpu().numpy(),
                                                    want)),
           "table_unchanged_by_fit": bool(torch.equal(after, before)),
           "steps": steps, "losses": losses, "launches": launched}
    log("glove_text", json.dumps(out))
    del net, emb
    free_card(torch)
    if (not out["table_equals_file"] or not out["table_unchanged_by_fit"]
            or launched != {"embedding_bag_fwd": steps,
                            "embedding_bag_bwd": 0}
            or not np.all(np.isfinite(losses))):
        raise AssertionError(f"WordEmbedding.from_glove leg: {out}")
    return out, launched


def vocabulary_net(torch):
    """One graph net over the new vocabulary: keras2 Dense / Add /
    Maximum / Minimum / Average / Multiply / Concatenate / Reshape, every
    merge mode, the advanced activations (the noise layers at inference)
    and torch-style layers, over two float inputs and a bag of ids."""
    import analytics_zoo_tpu_torch.nn.keras2 as k2
    from analytics_zoo_tpu_torch.nn import Input, Model, reset_name_scope
    from analytics_zoo_tpu_torch.nn import layers as L

    cfg = VOCAB_NET
    w = cfg["width"]
    reset_name_scope()
    a, b = Input((w,)), Input((w,))
    ids = Input((8,), dtype=torch.int32)
    e = L.ELU(0.5)(L.SparseEmbedding(cfg["vocab"], w, combiner="mean")(ids))
    h1 = L.SReLU()(k2.Dense(w, activation="relu")(a))
    h2 = L.PReLU()(L.GaussianNoise(0.1)(k2.Dense(w)(b)))
    merged = [L.merge([h1, h2, e], mode=m)
              for m in ("concat", "sum", "mul", "ave", "max", "min")]
    merged += [L.merge([h1, h2], mode="dot"), L.merge([h1, e], mode="cos"),
               k2.Add()(h1, e), k2.Maximum()(h2, e), k2.Minimum()(h1, h2),
               k2.Average()(h1, h2), k2.Multiply()(h2, e)]
    z = k2.Concatenate(axis=-1)(*merged)         # 3w + 5w + 1 + 1 + 5w
    width = 13 * w + 2
    z = L.HardTanh(-3.0, 3.0)(L.CAdd((width,))(L.CMul((width,))(z)))
    z = L.Narrow(1, 0, 13 * w)(z)
    z = L.LeakyReLU(0.1)(L.Scale((13 * w,))(z))
    z = L.RReLU()(L.SoftShrink(0.01)(L.GaussianDropout(0.2)(z)))
    seq = k2.Dense(64, activation="tanh")(L.SpatialDropout1D(0.2)(
        k2.Reshape((13, w))(z)))                 # (B, 13, 64)
    z = L.Log()(L.Sqrt()(L.AddConstant(0.5)(L.Square()(
        L.Select(1, 0)(seq)))))
    z = L.Negative()(L.MulConstant(2.0)(L.Identity()(z)))
    z = L.HardShrink(0.001)(L.Threshold(-5.0, 0.0)(z))
    z = L.Mul()(L.Power(2.0, scale=0.5, shift=1.0)(L.ThresholdedReLU(
        -10.0)(z)))
    peaks = L.Squeeze(2)(L.Max(2)(seq))          # (B, 13)
    out = k2.Dense(4)(k2.Concatenate()(L.Exp()(L.MulConstant(-0.1)(z)),
                                       peaks))
    model = Model([a, b, ids], out)
    model.build(torch.Generator().manual_seed(SEED + 201))
    return model


def vocabulary_net_leg(torch, eb, dq, card):
    """(d) ``vocabulary_net`` served int8 (its Dense kernels on kernel 3,
    the bag table on kernel 1) from bucket graphs: graphed equal to eager
    (``graphs.disabled()``) bit for bit, both within ``SERVE_F32_REL`` of
    the largest output of the plain versions."""
    from analytics_zoo_tpu_torch.core import graphs
    from analytics_zoo_tpu_torch.deploy import InferenceModel
    from analytics_zoo_tpu_torch.ops.dispatch import PATH_REFERENCE, forced

    cfg = VOCAB_NET
    net = vocabulary_net(torch)
    rs = np.random.RandomState(SEED + 202)
    xs = [rs.randn(cfg["rows"], cfg["width"]).astype(np.float32),
          rs.randn(cfg["rows"], cfg["width"]).astype(np.float32),
          rs.randint(0, cfg["vocab"], (cfg["rows"], 8)).astype(np.int32)]
    xs[2][:, 6:] = 0
    im = InferenceModel.from_keras_net(net, device="cuda",
                                       weight_dtype="int8",
                                       batch_buckets=cfg["buckets"],
                                       name="vocabulary_net")
    for b in cfg["buckets"]:
        for _ in range(2):
            im.predict([x[:b] for x in xs])
    eb.LAUNCHES.reset()
    dq.LAUNCHES.reset()
    graphed = np.concatenate([im.predict([x[s:s + 8] for x in xs])
                              for s in range(0, cfg["rows"], 8)]
                             + [im.predict(xs)])
    launched = {"embedding_bag_fwd": eb.LAUNCHES.value,
                "dequant_matmul": dq.LAUNCHES.value}
    with graphs.disabled():
        eager = np.concatenate([im.predict([x[s:s + 8] for x in xs])
                                for s in range(0, cfg["rows"], 8)]
                               + [im.predict(xs)])
    with forced(PATH_REFERENCE):
        plain = np.concatenate([im.predict([x[s:s + 8] for x in xs])
                                for s in range(0, cfg["rows"], 8)]
                               + [im.predict(xs)])
    top = float(np.abs(plain).max())
    progs = programs_of(im._programs)
    out = {"card": card, "layers": len(net.layers),
           "graphed_equals_eager": bool(np.array_equal(graphed, eager)),
           "max_abs_diff_vs_plain": float(np.abs(graphed - plain).max()),
           "largest": top, "launches": launched, "programs": progs,
           "finite": bool(np.all(np.isfinite(graphed)))}
    log("vocabulary_net", json.dumps(out))
    replays = cfg["rows"] // 8 + 1
    if (not out["graphed_equals_eager"] or not out["finite"]
            or out["max_abs_diff_vs_plain"] > SERVE_F32_REL * top
            or launched["embedding_bag_fwd"] != replays
            or launched["dequant_matmul"] != 3 * replays):
        raise AssertionError(f"vocabulary net: {out}")
    del im, net
    free_card(torch)
    return out, launched


def vocabulary_phase(torch, eb, dq, fa, card):
    """Phase 17: int8 / int4 BERT-Base from the native model, and the
    layer vocabulary on the card; returns each leg's launches by
    kernel."""
    t_phase = time.perf_counter()
    bert, bert_launches = qbert_leg(torch, eb, dq, fa, card)
    reset_counts(eb, dq, fa)
    sparse, sparse_launches = sparse_embedding_leg(torch, eb, card)
    reset_counts(eb, dq, fa)
    glove, glove_launches = glove_leg(torch, eb, card)
    reset_counts(eb, dq, fa)
    vnet, vnet_launches = vocabulary_net_leg(torch, eb, dq, card)
    summary = {
        "card": card, "seconds": time.perf_counter() - t_phase,
        "bert_weight_nbytes": {wd: bert[wd]["weight_nbytes"]
                               for wd in ("float32", "int8", "int4")},
        "bert_device_ms": {wd: {b: t["device_ms"]
                                for b, t in bert[wd]["timing"].items()}
                           for wd in ("float32", "int8", "int4")},
        "bert_vs_plain": {wd: bert[wd]["max_abs_logit_diff_vs_plain"]
                          for wd in ("int8", "int4")},
        "bert_vs_f32": {wd: [bert[wd]["rel_logit_diff_vs_f32"],
                             bert[wd]["argmax_agreement_vs_f32"]]
                        for wd in ("int8", "int4")},
        "bert_records_per_s": {
            wd: bert[wd]["cluster_serving"]["records_per_s"]
            for wd in ("int8", "int4")},
        "bert_embedding_dequantize_ms": {
            wd: bert[wd]["embedding_dequantize_ms"]
            for wd in ("int8", "int4")},
        "sparse_fit_losses": sparse["fit"]["losses"],
        "glove_table_unchanged": glove["table_unchanged_by_fit"],
        "vocabulary_net_vs_plain": vnet["max_abs_diff_vs_plain"]}
    log("vocabulary_summary", json.dumps(summary))
    return {"bert": bert_launches, "sparse": sparse_launches,
            "glove": glove_launches, "vocabulary_net": vnet_launches,
            "bag_cases": sparse["cases"][0], "bwd_cases": sparse["cases"][1]}


# ---------------------------------------------------------------------------
# phase 18: AutoML forecasting and the host data modules

# (b) ML-1M-shaped ratings as TFRecords; ml-1m has 1,000,209 ratings,
# cut to 100,000 for time
TFREC = dict(records=100_000, epochs=2, batch=TRAIN_BATCH)
# (c) the giant table: JAX bench.py's giant leg at one shard
GIANT = dict(rows=10 ** 8, dim=2, seed=11, ids=8192, chunk_rows=1 << 22)
# (d) nyc_taxi's length at half-hour resolution, with one extra feature
SERIES = dict(points=10_320, val_share=0.1)
BAYES_SAMPLES, BAYES_PARALLEL, MTNET_PARALLEL = 8, 2, 4
# (e) the vmap population: an 8 x 8 grid of (lr, init scale)
POPULATION = dict(rows=4096, features=16, hidden=64, steps=60,
                  lrs=(1e-3, 2e-3, 5e-3, 1e-2, 2e-2, 5e-2, 1e-1, 2e-1),
                  scales=(0.05, 0.08, 0.11, 0.14, 0.17, 0.2, 0.25, 0.3))
VMAP_RTOL = 1e-4


def native_leg(card):
    """(a) The native library: crc32c over 4 MB, and gather_rows at 1,
    4, 16 and 64 MiB batches of 256-byte rows (its own thread count, and
    1 / 2 / 4 / 8 threads) against their Python and numpy versions."""
    from analytics_zoo_tpu_torch import native
    from analytics_zoo_tpu_torch.core.summary import crc32c as table_crc

    if not native.available():
        raise AssertionError("the native library did not build (g++)")
    rs = np.random.RandomState(SEED + 181)
    data = rs.bytes(4 << 20)
    t0 = time.perf_counter()
    want = table_crc(data)
    py_s = time.perf_counter() - t0
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        got = native.crc32c(data)
    native_s = (time.perf_counter() - t0) / reps
    src = rs.randn(1 << 20, 64).astype(np.float32)      # 256 MB, 256 B rows
    variants = [("native", native.gather_rows),
                ("numpy", lambda a, i: a[i])] + [
        (f"threads_{t}", lambda a, i, t=t: native.gather_rows(
            a, i, n_threads=t)) for t in (1, 2, 4, 8)]
    gathers = {}
    equal = True
    for mib in (1, 4, 16, 64):                           # batch MiB
        idx = rs.randint(0, len(src), (mib << 20) // 256)
        n_rep = reps if mib < 64 else 5
        for _, fn in variants:
            fn(src, idx)                                 # warm
        # three rounds in rotated order, the best of each: the first
        # variant timed in a round reads slower, whichever it is
        best = {}
        for r in range(3):
            for name, fn in variants[r:] + variants[:r]:
                t0 = time.perf_counter()
                for _ in range(n_rep):
                    fn(src, idx)
                t = (time.perf_counter() - t0) / n_rep
                best[name] = min(best.get(name, t), t)
        equal = equal and bool(np.array_equal(native.gather_rows(src, idx),
                                              src[idx]))
        gathers[f"{mib}MiB"] = {k: len(idx) * 256 / v / 1e9
                                for k, v in best.items()}
    out = {"card": card, "host_cpus": os.cpu_count(),
           "crc_bytes": len(data), "crc_equal": got == want,
           "crc_native_mb_per_s": len(data) / native_s / 1e6,
           "crc_python_mb_per_s": len(data) / py_s / 1e6,
           "gather_gb_per_s": gathers, "gather_equal": equal,
           "gather_native_gb_per_s": gathers["4MiB"]["native"],
           "gather_numpy_gb_per_s": gathers["4MiB"]["numpy"],
           "host_clock": True}
    log("native", json.dumps(out))
    if not (out["crc_equal"] and equal):
        raise AssertionError(f"native leg: {out}")
    return out


def tfrecord_estimator_leg(torch, eb, card):
    """(b) ML-1M-shaped ratings through TFRecords into ``TFEstimator``:
    the losses equal ``Estimator.fit``'s from the same init and order,
    4 + 4 kernel launches a step."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.convert import export_params
    from analytics_zoo_tpu_torch.data.tfrecord import (make_example,
                                                       write_tfrecords)
    from analytics_zoo_tpu_torch.models import NeuralCF
    from analytics_zoo_tpu_torch.nn import reset_name_scope
    from analytics_zoo_tpu_torch.tfpark import (EstimatorSpec, TFDataset,
                                                TFEstimator)
    from analytics_zoo_tpu_torch.train.estimator import Estimator
    from analytics_zoo_tpu_torch.train.optimizers import Adam

    cfg = TFREC
    rs = np.random.RandomState(SEED + 182)
    n = cfg["records"]
    u = rs.randint(1, USERS + 1, n)
    it = rs.randint(1, ITEMS + 1, n)
    y = rs.randint(0, 5, n)
    root = tempfile.mkdtemp(prefix="zoo_tfrecord_")
    try:
        path = os.path.join(root, "ratings.tfrecord")
        t0 = time.perf_counter()
        write_tfrecords(path, [make_example(
            {"user": [int(a)], "item": [int(b)], "label": [int(c)]})
            for a, b, c in zip(u, it, y)])
        write_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        ds = TFDataset.from_tfrecord_file(path, ["user", "item"], "label",
                                          batch_size=cfg["batch"])
        read_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    data_equal = (np.array_equal(ds.features[0][:, 0], u)
                  and np.array_equal(ds.features[1][:, 0], it)
                  and np.array_equal(ds.y, y))

    def ncf():
        reset_name_scope()
        return NeuralCF(USERS, ITEMS, class_num=5, user_embed=20,
                        item_embed=20, hidden_layers=(40, 20, 10),
                        mf_embed=20, device="cuda")

    model = ncf()
    init = export_params(model.model)

    def model_fn(features, labels, mode, params):
        return EstimatorSpec(mode, model=model.model,
                             loss="sparse_categorical_crossentropy",
                             optimizer=Adam(lr=1e-3), metrics=["accuracy"])

    est = TFEstimator(model_fn)
    eb.LAUNCHES.reset()
    eb.BWD_LAUNCHES.reset()
    t0 = time.perf_counter()
    est.train(lambda: ds, batch_size=cfg["batch"], epochs=cfg["epochs"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launched = {"embedding_bag_fwd": eb.LAUNCHES.value,
                "embedding_bag_bwd": eb.BWD_LAUNCHES.value}
    steps = est.estimator.global_step
    losses = [h["loss"] for h in est.estimator.history]
    ref = ncf()
    plain = Estimator(ref.model, optimizer=Adam(lr=1e-3),
                      loss="sparse_categorical_crossentropy",
                      metrics=["accuracy"])
    plain.set_initial_weights(init)
    plain.fit(ds.features, ds.y, batch_size=cfg["batch"],
              epochs=cfg["epochs"], verbose=False)
    ref_losses = [h["loss"] for h in plain.history]
    evaluated = est.evaluate(lambda: (ds.features, ds.y),
                             batch_size=cfg["batch"])
    out = {"card": card, "records": n, "file_bytes": file_bytes,
           "write_records_per_s": n / write_s,
           "read_records_per_s": n / read_s, "data_equal": data_equal,
           "steps": steps, "train_s": train_s,
           "samples_per_s": steps * cfg["batch"] / train_s,
           "losses": losses, "fit_losses": ref_losses,
           "losses_equal_fit": losses == ref_losses,
           "evaluate": evaluated, "launches": launched,
           "launches_per_step": {k: v / steps for k, v in launched.items()}}
    log("tfrecord_estimator", json.dumps(out))
    del est, plain, model, ref
    free_card(torch)
    if (not data_equal or not out["losses_equal_fit"]
            or launched != {"embedding_bag_fwd": 4 * steps,
                            "embedding_bag_bwd": 4 * steps}
            or not np.all(np.isfinite(losses))):
        raise AssertionError(f"TFRecord -> TFEstimator leg: {out}")
    return out, launched


def giant_table_leg(torch, eb, card):
    """(c) ``SyntheticGiantTable(10**8, 2)`` filled on the card through
    pinned buffers, looked up by kernel 1 (its case beside the plain
    version, the bound and ``F.embedding_bag``); the rows equal the
    host's bit for bit."""
    import concurrent.futures as cf

    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.data import SyntheticGiantTable

    cfg = GIANT
    table = SyntheticGiantTable(cfg["rows"], cfg["dim"], seed=cfg["seed"])
    dev = torch.empty(table.shape, dtype=torch.float32, device="cuda")
    step = cfg["chunk_rows"]
    spans = [(lo, min(lo + step, cfg["rows"]))
             for lo in range(0, cfg["rows"], step)]
    pinned = [torch.empty((step, cfg["dim"]), dtype=torch.float32)
              .pin_memory() for _ in range(2)]
    done = [None, None]
    copy_stream = torch.cuda.Stream()
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        for k, ((lo, hi), rows) in enumerate(zip(
                spans, pool.map(lambda sp: table.rows(*sp), spans))):
            slot = k % 2
            if done[slot] is not None:
                done[slot].synchronize()
            buf = pinned[slot][:hi - lo]
            buf.copy_(torch.from_numpy(rows))
            with torch.cuda.stream(copy_stream):
                dev[lo:hi].copy_(buf, non_blocking=True)
                done[slot] = torch.cuda.Event()
                done[slot].record(copy_stream)
    copy_stream.synchronize()
    fill_s = time.perf_counter() - t0
    g = torch.Generator(device="cuda").manual_seed(SEED + 183)
    ids = torch.randint(0, cfg["rows"], (cfg["ids"], 1), device="cuda",
                        generator=g, dtype=torch.int32)
    eb.LAUNCHES.reset()
    got = eb.embedding_bag(dev, ids, "sum", None)
    torch.cuda.synchronize()
    launched = {"embedding_bag_fwd": eb.LAUNCHES.value}
    host_ids = ids[:, 0].cpu().numpy()
    want = np.stack([table.row(int(i)) for i in host_ids])
    rows_equal = bool(np.array_equal(got.cpu().numpy(), want))
    ref = eb.embedding_bag_reference(dev, ids, "sum", None)
    err = (got.double() - ref.double()).abs()
    distinct = int(torch.unique(ids).numel())
    nbytes = 4 * (distinct * cfg["dim"] + cfg["ids"] * cfg["dim"]) \
        + 4 * cfg["ids"]
    flops = cfg["ids"] * cfg["dim"] * 2
    lids = ids.long()
    case = {
        "case": "giant_table_1e8", "vocab": cfg["rows"], "dim": cfg["dim"],
        "bags": cfg["ids"], "nnz": 1, "combiner": "sum", "pad_id": None,
        "clip": False, "zipf": False, "given_ids": True, "dtype": "float32",
        "piece_bytes": eb.piece_bytes(4, cfg["dim"], dev.data_ptr()),
        "distinct_rows": distinct, "table_bytes": table.nbytes,
        "max_abs_err": float(err.max()),
        "max_rel_err": float(err.max() / ref.abs().max().clamp_min(1e-30)),
        **bound(nbytes, flops),
        **timings(torch, {
            "kernel": lambda: eb.embedding_bag(dev, ids, "sum", None),
            "plain": lambda: eb.embedding_bag_reference(dev, ids, "sum",
                                                        None),
            "library": lambda: F.embedding_bag(lids, dev, mode="sum")},
            200),
        "rows_hot_in_l2": True}
    out = {"card": card, "rows": cfg["rows"], "dim": cfg["dim"],
           "table_bytes": table.nbytes, "fill_s": fill_s,
           "fill_gb_per_s": table.nbytes / fill_s / 1e9,
           "rows_equal_host": rows_equal, "launches": launched,
           "case": case}
    log("giant_table", json.dumps(out))
    del dev, pinned, ref, got
    free_card(torch)
    if not rows_equal or launched != {"embedding_bag_fwd": 1} or float(
            err.max()) != 0.0:
        raise AssertionError(f"giant table leg: {out}")
    return out, launched


def taxi_series():
    """A seeded series of nyc_taxi's length and resolution: daily and
    weekly cycles with noise, and one extra feature (a rain flag), as
    the (target, feature) matrix min-max scaled over the whole series,
    as the feature transformer scales it."""
    rs = np.random.RandomState(SEED + 184)
    t = np.arange(SERIES["points"])
    day, week = 2 * np.pi * t / 48.0, 2 * np.pi * t / (48.0 * 7)
    rain = (rs.rand(len(t)) < 0.1).astype(np.float64)
    value = (15000 + 7000 * np.sin(day - 1.2) + 2500 * np.sin(week)
             - 1500 * rain + 1200 * rs.randn(len(t)))
    mat = np.stack([value, rain], -1)
    lo, hi = mat.min(0), mat.max(0)
    return ((mat - lo) / np.where(hi > lo, hi - lo, 1.0)).astype(np.float32)


def series_windows(mat, config):
    """(x, y) windows for a trial's config, split 90 / 10 in time order
    as ``TimeSequencePredictor.fit`` splits them."""
    from analytics_zoo_tpu_torch.automl.feature.time_sequence import (
        TimeSequenceFeatureTransformer)

    cols = [0] + ([1] if "rain" in config.get("selected_features", ["rain"])
                  else [])
    x, y = TimeSequenceFeatureTransformer._roll(
        mat[:, cols], int(config.get("past_seq_len", 2)), 1)
    split = max(1, int(len(x) * (1.0 - SERIES["val_share"])))
    return (x[:split], y[:split]), (x[split:], y[split:])


class UtilSampler:
    """``nvidia-smi``'s utilization.gpu (the share of each sample period
    in which a kernel ran), sampled every 100 ms beside a window."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        vals = [float(v) for v in out.split() if v.strip().isdigit()]
        return {"utilization_gpu_mean_pct": float(np.mean(vals))
                if vals else None, "samples": len(vals)}


def search_run(torch, card, label, engine, trainable, mat):
    """One search: per-trial wall, trials/s, the card's utilization, the
    best trial against persistence on its validation windows, and the
    losers' graphs released."""
    util = UtilSampler()
    t0 = time.perf_counter()
    try:
        results = engine.run(trainable)
    finally:
        wall = time.perf_counter() - t0
        busy = util.stop()
    failed = [r.extra.get("error") for r in results if "error" in r.extra]
    best = engine.best()
    (_, _), (vx, vy) = series_windows(mat, best.config)
    persistence = float(np.mean((vx[:, -1, 0] - vy[:, 0]) ** 2))
    before = torch.cuda.memory_reserved()
    for r in results:
        if r is not best and "model" in r.extra:
            r.extra["model"].model.estimator.release_graphs()
    free_card(torch)
    out = {"card": card, "search": label, "trials": len(results),
           "failed": failed, "wall_s": wall,
           "trials_per_s": len(results) / wall,
           "trial_wall_s": [r.extra.get("wall_s") for r in results],
           "trial_mse": [r.metric for r in results],
           "best_config": {k: v for k, v in best.config.items()
                           if k != "selected_features"},
           "best_mse": best.metric, "persistence_mse": persistence,
           "beats_persistence": best.metric < persistence,
           "reserved_bytes_before_release": before,
           "reserved_bytes_after_release": torch.cuda.memory_reserved(),
           **busy}
    return out, best


def automl_search_leg(torch, card, mat):
    """(d) ``MTNetGridRandomRecipe()`` at its defaults in 4 threads, then
    ``BayesRecipe(num_samples=8)`` over VanillaLSTM in 2; the best model
    saved, restored and predicting equal bit for bit."""
    import shutil
    import tempfile

    from analytics_zoo_tpu_torch.automl import (BayesRecipe,
                                                MTNetGridRandomRecipe,
                                                SearchEngine)
    from analytics_zoo_tpu_torch.automl.model.mtnet import MTNet
    from analytics_zoo_tpu_torch.automl.model.time_sequence import (
        VanillaLSTM)

    def trainable_of(make):
        def trainable(config):
            t0 = time.perf_counter()
            train, val = series_windows(mat, config)
            model = make()
            score = model.fit_eval(train[0], train[1], validation_data=val,
                                   metric="mse", **config)
            return score, {"model": model,
                           "wall_s": time.perf_counter() - t0}
        return trainable

    legs = {}
    recipe = MTNetGridRandomRecipe()
    engine = SearchEngine(recipe.search_space(["rain"]), metric_mode="min",
                          num_samples=recipe.num_samples,
                          max_parallel=MTNET_PARALLEL, backend="thread")
    legs["mtnet"], best = search_run(torch, card, "mtnet_grid_random",
                                     engine, trainable_of(MTNet), mat)
    model = best.extra["model"]
    (_, _), (vx, _) = series_windows(mat, best.config)
    root = tempfile.mkdtemp(prefix="zoo_automl_")
    try:
        path = os.path.join(root, "mtnet.npz")
        model.save(path)
        again = MTNet()
        again.restore(path, vx.shape[1:], 1, best.config)
        restored_equal = bool(np.array_equal(again.predict(vx),
                                             model.predict(vx)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    legs["mtnet"]["restored_predicts_equal"] = restored_equal
    del model, again, best, engine
    free_card(torch)
    recipe = BayesRecipe(num_samples=BAYES_SAMPLES)
    engine = SearchEngine(recipe.search_space(["rain"]), metric_mode="min",
                          num_samples=recipe.num_samples,
                          max_parallel=BAYES_PARALLEL, search_alg="tpe",
                          n_startup=recipe.n_startup)
    legs["lstm"], _ = search_run(torch, card, "bayes_lstm", engine,
                                 trainable_of(VanillaLSTM), mat)
    del engine
    free_card(torch)
    for name, leg in legs.items():
        log("automl_search", json.dumps(leg))
    m = legs["mtnet"]
    if (m["failed"] or legs["lstm"]["failed"] or not restored_equal
            or not m["beats_persistence"]):
        raise AssertionError(f"AutoML search leg: {legs}")
    return legs


def vmap_population_leg(torch, card):
    """(e) 64 (lr, init scale) configs of a small MLP trained full batch
    for 60 steps: one ``backend="vmap"`` call against the same 64 run one
    by one."""
    from torch.func import grad

    from analytics_zoo_tpu_torch.automl import SearchEngine
    from analytics_zoo_tpu_torch.automl.search import GridSearch

    cfg = POPULATION
    rs = np.random.RandomState(SEED + 185)

    def dev(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()

    x = dev(rs.randn(cfg["rows"], cfg["features"]))
    y = x @ dev(rs.randn(cfg["features"], 1))
    w1 = dev(rs.randn(cfg["features"], cfg["hidden"]))
    w2 = dev(rs.randn(cfg["hidden"], 1))

    def loss_fn(params):
        return torch.mean((torch.tanh(x @ params[0]) @ params[1] - y) ** 2)

    def trainable(c, **shared):
        params = (c["scale"] * w1, c["scale"] * w2)
        for _ in range(c["steps"]):
            g = grad(loss_fn)(params)
            params = tuple(p - c["lr"] * gg for p, gg in zip(params, g))
        return loss_fn(params)

    space = {"lr": GridSearch(list(cfg["lrs"])),
             "scale": GridSearch(list(cfg["scales"])), "steps": cfg["steps"]}
    walls = {}
    runs = {}
    for backend in ("vmap", "thread"):
        eng = SearchEngine(space, metric_mode="min", num_samples=1,
                           backend=backend, max_parallel=1, seed=SEED)
        eng.run(trainable)                       # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[backend] = eng.run(trainable)
        torch.cuda.synchronize()
        walls[backend] = time.perf_counter() - t0
    got = np.array([r.metric for r in runs["vmap"]])
    want = np.array([r.metric for r in runs["thread"]])
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))
    out = {"card": card, "configs": len(got), "steps": cfg["steps"],
           "vmap_wall_s": walls["vmap"], "one_by_one_wall_s":
           walls["thread"], "speedup": walls["thread"] / walls["vmap"],
           "max_rel_diff": rel,
           "errors": [r.extra.get("error") for r in runs["vmap"]
                      if "error" in r.extra],
           "best_vmap": min(got.tolist()), "best_one_by_one":
           min(want.tolist())}
    log("vmap_population", json.dumps(out))
    if (out["errors"] or rel > VMAP_RTOL
            or [r.config for r in runs["vmap"]]
            != [r.config for r in runs["thread"]]):
        raise AssertionError(f"vmap population leg: {out}")
    return out


def automl_dataframe_leg(torch, card, mat):
    """(f) The DataFrame front end, where pandas imports: fit with
    ``MTNetSmokeRecipe``, predict, save, load, predict again."""
    import shutil
    import tempfile

    import pandas as pd

    from analytics_zoo_tpu_torch.automl import (MTNetSmokeRecipe,
                                                TimeSequencePredictor,
                                                load_ts_pipeline)

    n = len(mat)
    df = pd.DataFrame({
        "datetime": pd.date_range("2014-07-01", periods=n, freq="30min"),
        "value": mat[:, 0], "rain": mat[:, 1]})
    t0 = time.perf_counter()
    tsp = TimeSequencePredictor(future_seq_len=1, extra_features_col=["rain"])
    pipeline = tsp.fit(df, metric="mse", recipe=MTNetSmokeRecipe())
    fit_s = time.perf_counter() - t0
    tail = df.iloc[-480:]
    first = tsp.predict(tail)
    root = tempfile.mkdtemp(prefix="zoo_pipeline_")
    try:
        pipeline.save(root)
        second = load_ts_pipeline(root).predict(tail)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    equal = bool(first.equals(second))
    out = {"card": card, "rows": n, "fit_s": fit_s,
           "predictions": len(first), "reloaded_equal": equal,
           "mse": pipeline.evaluate(df.iloc[-2000:])}
    log("automl_dataframe", json.dumps(out))
    free_card(torch)
    if not equal or not np.isfinite(out["mse"]):
        raise AssertionError(f"AutoML DataFrame leg: {out}")
    return out


def automl_host_phase(torch, eb, dq, fa, card):
    """Phase 18: the host data modules and AutoML forecasting on the
    card; returns each leg's kernel launches and kernel 1's giant-table
    case."""
    t_phase = time.perf_counter()
    native_out = native_leg(card)
    reset_counts(eb, dq, fa)
    tfrec, tfrec_launches = tfrecord_estimator_leg(torch, eb, card)
    reset_counts(eb, dq, fa)
    giant, giant_launches = giant_table_leg(torch, eb, card)
    mat = taxi_series()
    searches = automl_search_leg(torch, card, mat)
    vmap = vmap_population_leg(torch, card)
    try:
        import pandas
        pandas_version = pandas.__version__
    except ImportError:
        pandas_version = None
    log("pandas:", pandas_version or "absent", card)
    frame = (automl_dataframe_leg(torch, card, mat) if pandas_version
             else None)
    summary = {
        "card": card, "seconds": time.perf_counter() - t_phase,
        "pandas": pandas_version or "absent",
        "crc_native_mb_per_s": native_out["crc_native_mb_per_s"],
        "gather_native_gb_per_s": native_out["gather_native_gb_per_s"],
        "tfrecord_read_records_per_s": tfrec["read_records_per_s"],
        "tfestimator_losses_equal_fit": tfrec["losses_equal_fit"],
        "giant_fill_s": giant["fill_s"],
        "giant_kernel_ms": giant["case"]["ms"],
        "giant_bound_ms": giant["case"]["bound_ms"],
        "mtnet_best_mse": searches["mtnet"]["best_mse"],
        "mtnet_persistence_mse": searches["mtnet"]["persistence_mse"],
        "lstm_best_mse": searches["lstm"]["best_mse"],
        "search_trials_per_s": {k: v["trials_per_s"]
                                for k, v in searches.items()},
        "vmap_speedup": vmap["speedup"],
        "dataframe_reloaded_equal": frame["reloaded_equal"] if frame
        else None}
    log("automl_host_summary", json.dumps(summary))
    return {"tfestimator": tfrec_launches, "giant": giant_launches,
            "giant_case": giant["case"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch.ops import _build
    from analytics_zoo_tpu_torch.ops import dequant_matmul as dq
    from analytics_zoo_tpu_torch.ops import embedding_bag as eb
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    # full f32 in every plain version and yardstick: no TF32 in cuBLAS
    # matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: matmul", torch.backends.cuda.matmul.allow_tf32, "cudnn",
        torch.backends.cudnn.allow_tf32)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("nvidia-smi:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    libs = _build.build()
    log("build_s", round(time.perf_counter() - t0, 3),
        json.dumps({k: str(v) for k, v in libs.items()}))
    for name, path in libs.items():
        log(f"ptxas[{name}]:", " | ".join(
            ln.strip() for ln in path.with_suffix(".log").read_text()
            .splitlines() if "registers" in ln or "spill" in ln))
    for name, kernels in (("flash_attention", ("flash_fwd",)),
                          ("flash_attention_bwd",
                           ("flash_bwd_dq", "flash_bwd_dkv"))):
        check_no_spills(name, libs[name].with_suffix(".log").read_text())
        log(f"sass[{name}]:",
            json.dumps(flash_sass(_build, libs[name], kernels)))
    check_no_spills("dequant_matmul",
                    libs["dequant_matmul"].with_suffix(".log").read_text())
    log("sass[dequant_matmul]:",
        json.dumps(dq_sass(_build, libs["dequant_matmul"])))
    check_no_spills("embedding_bag",
                    libs["embedding_bag"].with_suffix(".log").read_text())
    log("sass[embedding_bag]:",
        json.dumps(bag_sass(_build, libs["embedding_bag"])))

    bag_cases, bwd_cases, dq_cases = kernel_phase(torch, eb, dq)
    dq_cases += resnet_head_cases(torch, dq)
    for more in (recommender_kernel_cases(torch, eb, dq),
                 text_kernel_cases(torch, eb, dq)):
        bag_cases += more[0]
        bwd_cases += more[1]
        dq_cases += more[2]
    dq_cases += import_kernel_cases(torch, dq)
    dq_cases += qbert_kernel_cases(torch, dq)
    fc6_f64_case(torch, dq)
    fl_cases = flash_cases(torch, fa)
    lse_cases, bwd_dq_cases, bwd_dkv_cases = flash_train_cases(torch, fa)
    for c in fl_cases + lse_cases + bwd_dq_cases + bwd_dkv_cases:
        log("kernel_case", json.dumps(c))
    reset_counts(eb, dq, fa)
    served = serving_phase(torch, eb, dq)
    trained = training_phase(torch, eb, dq)
    bert = bert_serving_phase(torch, eb, dq, fa)
    bert_trained, bert_eval, bert_f32 = bert_training_phase(torch, eb, dq,
                                                            fa)
    ft_bert_launches, ft_ncf = fault_tolerant_phase(torch, eb, dq, fa,
                                                    bert_f32, card)
    graphed_phase(torch, eb, fa, card)
    cluster, shm_records_per_s = cluster_serving_phase(torch, eb, dq, fa,
                                                       card)
    reset_counts(eb, dq, fa)
    image = image_phase(torch, dq, card)
    reset_counts(eb, dq, fa)
    rec = recommender_phase(torch, eb, dq, card)
    reset_counts(eb, dq, fa)
    text = text_phase(torch, eb, dq, card)
    reset_counts(eb, dq, fa)
    loadgen = loadgen_phase(torch, eb, dq, fa, card, shm_records_per_s)
    reset_counts(eb, dq, fa)
    surface = training_surface_phase(torch, eb, dq, fa, card)
    reset_counts(eb, dq, fa)
    detection = detection_phase(torch, dq, card)
    reset_counts(eb, dq, fa)
    imported = model_import_phase(torch, dq, card)
    reset_counts(eb, dq, fa)
    vocab = vocabulary_phase(torch, eb, dq, fa, card)
    bag_cases += vocab["bag_cases"]
    bwd_cases += vocab["bwd_cases"]
    reset_counts(eb, dq, fa)
    host = automl_host_phase(torch, eb, dq, fa, card)
    bag_cases.append(host["giant_case"])
    rec_paths = ("wide_and_deep_training", "wide_and_deep_serving",
                 "session_training", "session_serving")
    fwd_by_path = {"serving": served["embedding_bag"],
                   "training": trained["embedding_bag_fwd"],
                   "bert_serving": bert["embedding_bag"],
                   "fault_tolerant_ncf": ft_ncf["embedding_bag_fwd"],
                   "cluster_serving": cluster["embedding_bag_fwd"],
                   "loadgen": loadgen["embedding_bag_fwd"],
                   **{p: rec[p]["embedding_bag_fwd"] for p in rec_paths},
                   **{p: v["embedding_bag_fwd"] for p, v in text.items()},
                   **{p: v["embedding_bag_fwd"] for p, v in surface.items()
                      if p != "training_surface_bert_eval"},
                   "sparse_embedding_training": vocab["sparse"][
                       "embedding_bag_fwd"],
                   "glove_text_training": vocab["glove"]["embedding_bag_fwd"],
                   "vocabulary_net": vocab["vocabulary_net"][
                       "embedding_bag_fwd"],
                   "tfestimator_ncf": host["tfestimator"][
                       "embedding_bag_fwd"],
                   "giant_table_lookup": host["giant"]["embedding_bag_fwd"]}
    bwd_by_path = {"training": trained["embedding_bag_bwd"],
                   "training_surface_stream": surface[
                       "training_surface_stream"]["embedding_bag_bwd"],
                   "fault_tolerant_ncf": ft_ncf["embedding_bag_bwd"],
                   **{p: rec[p]["embedding_bag_bwd"] for p in rec_paths
                      if p.endswith("_training")},
                   **{p: v["embedding_bag_bwd"] for p, v in text.items()
                      if "embedding_bag_bwd" in v},
                   "sparse_embedding_training": vocab["sparse"][
                       "embedding_bag_bwd"],
                   "tfestimator_ncf": host["tfestimator"][
                       "embedding_bag_bwd"]}
    dq_by_path = {"serving": served["dequant_matmul"],
                  "training": trained["dequant_matmul"],
                  "bert_serving": bert["dequant_matmul"],
                  "cluster_serving": cluster["dequant_matmul"],
                  "loadgen": loadgen["dequant_matmul"],
                  "resnet50_serving": image["dequant_matmul"],
                  "image_records": detection["image_records"],
                  "vgg16_int8_serving": imported["vgg16_int8_serving"],
                  **{p: rec[p]["dequant_matmul"] for p in rec_paths
                     if p.endswith("_serving")},
                  **{p: v["dequant_matmul"] for p, v in text.items()
                     if "dequant_matmul" in v},
                  "bert_int8_serving": vocab["bert"]["int8"]["dequant_matmul"],
                  "bert_int4_serving": vocab["bert"]["int4"]["dequant_matmul"],
                  "vocabulary_net": vocab["vocabulary_net"]["dequant_matmul"]}
    kernels = [
        headline(bag_cases, "embedding_bag_fwd", "cuda", BAG_SRC, BAG_TPU,
                 sum(fwd_by_path.values()),
                 lambda c: c["vocab"] == USERS + 1 and c["bags"] == 256),
        headline(bwd_cases, "embedding_bag_bwd", "cuda", BAG_SRC,
                 BAG_BWD_TPU, sum(bwd_by_path.values()),
                 lambda c: c["vocab"] == USERS + 1),
        headline(dq_cases, "dequant_matmul", "cuda", DQ_SRC, DQ_TPU,
                 sum(dq_by_path.values()),
                 lambda c: c["m"] == 256 and c["bits"] == 8),
    ]
    kernels[0]["launches_by_path"] = fwd_by_path
    kernels[1]["launches_by_path"] = bwd_by_path
    kernels[1]["device_kernels_per_call"] = {
        c["case"]: c["device_kernels_per_call"] for c in bwd_cases}
    dq_f32 = [c for c in dq_cases if c["dtype"] == "float32"]
    kernels[2]["max_abs_err"] = max(c["max_abs_err"] for c in dq_f32)
    kernels[2]["max_rel_err"] = max(c["max_rel_err"] for c in dq_f32)
    kernels[2]["max_abs_err_half"] = max(c["max_abs_err"] for c in dq_cases
                                         if c["dtype"] != "float32")
    kernels[2]["launches_by_path"] = dq_by_path
    fwd_paths = {"bert_serving": bert["flash_attention"],
                 "bert_training_no_grad": bert_eval["flash_attention_fwd"],
                 "fault_tolerant_no_grad": ft_bert_launches[
                     "flash_attention_fwd"],
                 "cluster_serving": cluster["flash_attention_fwd"],
                 "loadgen": loadgen["flash_attention_fwd"],
                 "training_surface_bert_eval": surface[
                     "training_surface_bert_eval"]["flash_attention_fwd"],
                 **{f"bert_{wd}_serving": vocab["bert"][wd]["flash_attention"]
                    for wd in ("int8", "int4")}}
    flash_rows = [
        (fl_cases, "flash_attention_fwd", FLASH_SRC, FLASH_TPU, fwd_paths,
         "bert_l128"),
        (lse_cases, "flash_attention_fwd_lse", FLASH_SRC, FLASH_LSE_TPU,
         {"bert_training": bert_trained["flash_attention_fwd_lse"],
          "fault_tolerant_bf16":
              ft_bert_launches["flash_attention_fwd_lse"]},
         "bert_train_l128"),
        (bwd_dq_cases, "flash_attention_bwd_dq", FLASH_BWD_SRC, FLASH_DQ_TPU,
         {"bert_training": bert_trained["flash_attention_bwd_dq"],
          "fault_tolerant_bf16":
              ft_bert_launches["flash_attention_bwd_dq"]},
         "bert_train_l128"),
        (bwd_dkv_cases, "flash_attention_bwd_dkv", FLASH_BWD_SRC,
         FLASH_DKV_TPU,
         {"bert_training": bert_trained["flash_attention_bwd_dkv"],
          "fault_tolerant_bf16":
              ft_bert_launches["flash_attention_bwd_dkv"]},
         "bert_train_l128")]
    for cases, name, src, tpu, by_path, head in flash_rows:
        row = headline(cases, name, "cuda", src, tpu, sum(by_path.values()),
                       lambda c, head=head: c["case"] == head)
        f32 = [c for c in cases if c["dtype"] == "float32"]
        row["max_abs_err"] = max(c["max_abs_err"] for c in f32)
        row["max_rel_err"] = max(c["max_rel_err"] for c in f32)
        row["max_abs_err_bf16"] = max(c["max_abs_err"] for c in cases
                                      if c["dtype"] == "bfloat16")
        row["launches_by_path"] = by_path
        if "pair_ms" in row["cases"][0]:
            head_case = next(c for c in cases if c["case"] == head)
            row["pair_ms"] = head_case["pair_ms"]
            row["plain_and_library_are_the_pair"] = True
        kernels.append(row)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-warm"]:
        sys.exit(serve_warm(sys.argv[2]))
    if sys.argv[1:2] == ["--serve-client"]:
        sys.exit(serve_client(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--loadgen-client"]:
        sys.exit(loadgen_client(*sys.argv[2:5]))
    if sys.argv[1:2] == ["--detect-client"]:
        sys.exit(detect_client(*sys.argv[2:5]))
    sys.exit(main())
