#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Imports nothing of JAX and nothing of ``deeplearning4j_tpu``. In order:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds every CUDA kernel under ``deeplearning4j_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` (one process per source, in parallel) and times
   the build;
3. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and at edge shapes, with a stated tolerance, and times
   the kernel, the plain version and one PyTorch library call computing the
   same function (for the LSTM kernels ``torch.nn.LSTM``, cuDNN, which has
   no peepholes);
4. serves full-width ``transformer_lm(256)`` (random weights from a seed,
   int8 at rest) through ``InferenceServer`` on the card: 8 concurrent
   ``/v1/generate`` requests over the paged KV cache and one ``/v1/predict``
   of ``[2, 512]`` ids. It checks the answers against a CPU reference and
   that every serving kernel was launched by this traffic, parses ``GET
   /metrics`` and holds the request, token, TTFT, eviction and batch
   series to what was sent and to ``/serve/status``, then repeats the
   traffic with the metrics registry off and on in turns (3 calls a side;
   decode tokens/s and predict ms printed, not gated); then the ``tracing``
   phase (A9.2) on the same server: the 8 generates one at a time and the
   predict, each with a client ``traceparent``, untraced and then traced
   (the launches of ``int8_matmul``, ``paged_gather``, ``flash_fwd`` and
   ``fixed_matmul`` and the outputs of the two runs equal bitwise, every
   echo keeps the client's trace id, every ``/serve/traces/<id>`` tree has
   the names and parents the CPU tests hold against the JAX server, the
   predict's ``batch.dispatch`` links its queue span, and
   ``dl4j_trace_spans_total`` moved by the spans the trees hold), one 429
   kept at ``sample=0``, ``GET /serve/slo`` (three objectives, two windows
   each), and the concurrent traffic with tracing off and on in turns (3
   calls a side; printed, not gated);
5. trains full-width ``transformer_lm(256)`` through
   ``MultiLayerNetwork.fit`` for 5 steps at B = 16, T = 256 (one-hot ids from
   a numpy seed, y = x, Adam at 3e-4) on the card and, from the same initial
   weights, on the CPU; checks each step's loss against the CPU run, that the
   loss falls, and the exact launch counts of the training kernels; then
   times train steps and profiles one (device time by kernel, idle share);
   then runs full-width ``transformer_lm(256, width=512)`` twice, at 4
   heads of 128 and at 2 heads of 256 (``csrc/flash_wide.cu``): one
   ``output`` and 2 ``fit`` steps at B = 4, T = 128 each against the CPU
   from the same weights, with exact flash launch counts;
6. serves full-width ``char_rnn_lstm(64, hidden=200)`` (random weights from
   a seed, float32): 8 concurrent ``/v1/generate`` requests over the LSTM
   decode engine and one ``/v1/stream`` session of 64 steps in two requests,
   then ``/v1/stream/reset``; checks every token and output against the CPU
   ``rnn_time_step`` and the exact launches of each path; profiles the
   generate traffic once more;
7. trains the same model (RMSProp at 0.01) through TBPTT ``fit``: 2
   batches of [32, 200, 64] one-hot ids (y = x), 8 chunks of 50, on the card and from the same
   weights on the CPU; checks every chunk's loss and the exact launch counts
   (``lstm_fwd`` 16, ``lstm_bwd`` 16, ``sm_xent`` 8); times chunks (wall,
   device time and idle share a chunk) and profiles one batch, with
   ``lstm_fwd``'s device time split into its hoisted input product and its
   recurrence, and ``lstm_bwd``'s into its hoisted gate product, its
   recurrence and its tail;
8. trains full-width ``lenet_mnist()`` (20 and 50 filters, 500 dense
   units; random weights from a seed) through ``fit`` for 5 steps at
   B = 128 on synthetic MNIST digits (seed 123) on the card and, from the
   same weights, on the CPU: each step's loss within 1e-4 relative, one
   ``output`` within 1e-4, exactly one ``sm_xent`` launch a step; then one
   ``fit_iterator`` epoch of 20 batches on both (on the card through the
   K-step dispatch), ``evaluate`` on 1,000
   synthetic test digits (seed 321; accuracies within 0.01), and
   ``/v1/predict`` of 64 rows through ``InferenceServer`` (within 1e-4 of
   the CPU ``output`` of the served weights); then times 20 steps (wall
   ms, samples/s) and profiles one (device time by kernel family and by
   kernel, idle share);
9. trains full-width ``resnet50()`` through ``ComputationGraph.fit``: at
   64x64 (full depth and width, 1000 classes) 3 steps at B = 8 on the card
   and, from the same weights (init on the CPU, ``clone`` to the card), on
   the CPU, each card step from the CPU run's state: each loss within 1e-4
   relative, the eval ``output`` within 1e-4, the batch-norm running
   statistics within 1e-4 of their scale, one ``sm_xent`` launch a step;
   a second card copy trains on its own and its drift is printed; then at the JAX
   bench's shape (224x224x3, B = 128, synthetic normal images and one-hot
   labels from a seed) 2 warm-up and 10 timed steps (wall ms, samples/s,
   exactly one ``sm_xent`` launch a step, peak memory) and one profiled
   step (device time by kernel family, idle share, the float32-peak share
   of the FLOPs counted from the layer shapes); ``evaluate`` on 256
   synthetic images and one ``/v1/predict`` of 2 rows, held to the card's
   own ``output``;
10. runs the K-step dispatch (a CUDA graph of the train step, captured
   once and replayed once a step) against eager single steps from one
   init, on each network type: a 20-batch ``fit_iterator`` epoch of
   full-width LeNet at ``ksteps=8`` (groups of 8, 8 and the ragged 4),
   ``fit(x, y, epochs=8)`` of full-width ``transformer_lm(256)`` at
   ``dispatch_ksteps`` 4, and full-depth ``resnet50()`` (4 steps at 64x64,
   B = 8, then ``fit(epochs=4)`` at 224x224, B = 128). Each checks the
   losses, the params and batch norm's running statistics (cuDNN
   deterministic for the check) and the exact launches as the replays
   count them, then times both paths in turns and profiles each once:
   wall ms and device µs a step, idle share, peak memory and the graph's
   pool, replays. LeNet's and the transformer's paths run right after
   serving (step 4), so their wall times come before any profiler session
   in the process (which may slow later launches on the host); their
   profiled calls wait until after step 9. Then the ``diagnostics`` phase
   (A9.3) on the same transformer at the same shape: ``fit(epochs=8)`` in
   groups of 4 with ``HealthMonitor(cadence=4)`` and ``NanAlertListener``
   (the health step graph beside the plain one) against the same fit
   unmonitored (params and losses bitwise, the same launches a replay in
   both graphs, the checks ``due_index`` names) and against an eager
   monitored fit (each summary within 1e-4 relative); the monitored
   (cadence 50) and unmonitored fits timed in turns, 5 calls a side of 50
   steps; a NaN batch at iteration 6 alarming ``nonfinite-grads`` at 8 with
   one complete bundle naming the card; a host stall under a 1 s
   watchdog counted once, its bundle's ``threads.txt`` holding the
   stalled listener;
11. builds char_rnn_lstm(64)'s layers as a ``ComputationGraph`` and trains
   it through TBPTT (8 chunks of [32, 50, 64]) on the card against the CPU
   (chunk losses within 1e-4 relative; ``lstm_fwd`` 16, ``lstm_bwd`` 16,
   ``sm_xent`` 8 launches), streams 64 steps through ``rnn_time_step`` and
   through ``/v1/stream`` against the CPU ``rnn_time_step`` of the same
   weights (1e-5; 128 one-step ``lstm_fwd`` launches each), then times
   chunks;
12. runs the ``dtype`` phase (``common.py``'s named policies, configs
   naming them): full-depth ResNet-50 under ``bfloat16_flagship`` at 64x64
   (3 steps at B = 8, each card step from the CPU flagship run's state:
   the loss and the update against float64 as step 9's gate does, the
   update's projection on the CPU's at the last step, a 1.01-rate control
   that must fail, params and BN state float32) and at 224x224, B = 128
   (eager steps in turns with float32 steps, ``fit(epochs=4)`` through the
   K-step path, one profiled step of each by family, peak memory, the bf16
   peak share, ``evaluate`` and ``/v1/predict``); full-width
   ``transformer_lm(256)`` under ``bfloat16_full`` (2 steps against the
   CPU, a K-step ``fit``, ``/v1/predict``, int8 ``/v1/generate``) and
   ``char_rnn_lstm(64)`` under ``bfloat16`` (8 TBPTT chunks against the
   CPU, decode, a 64-step ``/v1/stream``), each held to its CPU run within
   twice that run's distance to float32, the kernels' operand dtypes
   checked bf16; the kernel checks of step 3 add the bf16 operands at these
   paths' shapes;
13. runs the ``files`` phase (model zips, ``utils/model_serializer.py``):
   full-width LeNet through ``EarlyStoppingTrainer`` (a file saver, at most
   4 epochs of 20 batches, stopping after 2 epochs without improvement on
   512 held-out digits; score, score-collecting and checkpoint listeners;
   exact ``sm_xent`` launches), the best epoch's zip restored on the card
   and on the CPU (output within 1e-4 of the network at that epoch) and
   loaded into ``InferenceServer(warmup=True, max_batch=32)`` (buckets 1 to
   32 warmed, ``/v1/predict`` of 64 rows within 1e-4); full-depth ResNet-50
   at 64x64, B = 8: a zip after 2 steps (its write and restore seconds and
   size), restored on the card with every leaf and the eval output bitwise,
   2 more steps from the file and from the original bitwise equal with
   cuDNN deterministic, then served from the zip; full-width
   ``transformer_lm(256)`` after 2 steps, served int8 from memory and from
   its zip with step 4's traffic (the same greedy tokens, exact launches);
   full-width LeNet under ``optimization_algo="lbfgs"`` (10 iterations on
   one batch of 128; cuDNN deterministic) on the card against the CPU;
14. runs the ``self_attention`` path: ``SelfAttentionLayer(n_out=512,
   n_heads=8)`` (non-causal), average pooling and a 10-way output on
   ``[4, T, 512]`` normal features: at T = 512 ``output`` and 2 ``fit``
   steps, each card step from the CPU run's state, and a ragged masked
   batch (``fit`` and ``score`` through the key mask), each within 1e-4 of
   the CPU; exact flash launches; then 5 timed steps at bench_attention's
   B = 4, T = 2048 (step 3 adds the kernels' non-causal rows at that shape,
   at a ragged T = 2001 and with a key mask zeroing every row's tail);
15. runs the ``moe`` phase, the slice's main path: full-width
   ``moe_transformer_lm(256)`` (width 256, 4 layers of 4 heads and 8
   experts; the JAX bench's ``moe`` geometry, B = 8, T = 256, Adam at
   3e-4): 2 ``fit`` steps on the card, each from the CPU run's state, with
   the routing of every token held first (a token whose top-2 router
   probabilities differ by more than 1e-5 must take the CPU's expert;
   near-ties are counted), each loss (load-balance term included) within
   1e-4 relative, launches exact (4 of each flash kernel and 1 ``sm_xent``
   a step); ``fit(epochs=8)`` at ``dispatch_ksteps`` 4 against 8 eager
   steps (within 1e-5), both timed in turns and profiled (wall ms,
   samples/s, tokens/s, device µs by family, idle share, peak memory);
   ``/v1/predict`` of 2 one-hot rows in float32 and int8 (3-D expert
   leaves quantized per output channel) within 1e-4 of the CPU forward of
   the served leaves; ``tests/golden/lm_golden.zip`` restored on the card
   within 1e-4 of its expected outputs;
16. runs the ``zoo`` phase: ``vgg16()`` at 64x64, B = 4 (dropout at retain
   1.0, as the two RNGs differ) for 2 steps against the CPU, each from the
   CPU run's state (losses and the eval output within 1e-4, one
   ``sm_xent`` a step), then at the JAX bench's 224x224, B = 64 with the
   config's dropout: 2 warm-up and 10 timed steps, each from the initial
   state restored on the device (the config's rate diverges within a few
   steps on random labels; every loss must be finite), with wall ms,
   samples/s, the float32-peak share from the layer shapes' FLOPs and peak
   memory, and one profiled step by family; ``evaluate`` on 128 images and
   a 2-row ``/v1/predict`` of that network; ``alexnet()`` and ``googlenet()`` at
   64x64, B = 2 (1 step and the output within 1e-4 of the CPU) and at
   224x224, B = 32 (3 timed steps); each network's parameter count equal
   to the JAX config's;
17. runs the ``pretrain`` phase: a ``VariationalAutoencoder`` vertex at
   DL4J's VaeMNISTAnomaly widths (784 -> 256, 256 -> 32, Bernoulli): its
   pretraining step on 20 batches of 128 synthetic digits, each card
   batch from the CPU run's state, both given the same normals through the
   step's ``noise`` (losses within 1e-4 relative); then ``pretrain_layer``
   over the 20 batches on the card alone (the head's params bitwise
   unchanged, the iteration unmoved, the loss lower) and 5 ``fit`` steps
   (5 ``sm_xent`` launches); an ``RBM(784 -> 500)``,
   ``AutoEncoder(500 -> 250)``, output stack with ``pretrain(True)``: the
   RBM's first CD update on the card against the CPU from the same
   uniforms (a Bernoulli sample may differ only where its uniform lies
   within 1e-6 of its probability), then ``fit_iterator`` over the 20
   batches (pretraining, then the supervised epoch: exactly 20 ``sm_xent``
   launches);
18. runs the ``iris`` drive: ``IrisDataSetIterator(batch=30)``, a dense 4 ->
   16 -> 3 network, Adam at 0.1, 20 epochs of ``fit_iterator``: accuracy
   above 0.9, exactly 100 ``sm_xent`` launches;
19. runs the ``spec`` phase: the serve phase's full-width int8
   ``transformer_lm(256)`` on paged KV with the JAX bench's draft
   (``transformer_lm(256, width=128, n_layers=1, n_heads=2)``, float32)
   linked through ``registry.link_draft``, 3 proposals a round: the serve
   phase's 8 concurrent ``/v1/generate`` requests (every token the CPU
   oracle's argmax within 1e-4; exactly 17 ``int8_matmul`` and 8
   ``paged_gather`` launches a verify position, 4 positions a round, no
   ``flash_fwd``), then ``run_spec_ab`` at a fixed capacity of 8 (spec
   tokens equal to plain tokens; tokens/s of both), and a draft holding the
   target's own weights, both float32 on dense KV (acceptance exactly 1);
20. runs the ``replicas`` phase: ``InferenceServer(replicas=2)`` serving the
   int8 transformer, 32 ``/v1/predict`` requests of one row of 255 ids from
   8 threads with a rolling hot swap to a second version after the 12th
   answer (every answer 200 and within 1e-4 of the CPU int8 forward of the
   version that answered, both replicas serving, 4 ``flash_fwd`` launches a
   dispatch), then one ``Autoscaler`` tick sequence on an injected clock,
   with no SLO engine as the server builds it: 24 requests queued behind a
   spin on the stream scale out on queue pressure, then a scale-in drains 4
   requests queued on the new replica; before the autoscaler, ``GET
   /metrics`` after the predicts: requests, batches, routed requests by
   replica, hot swaps and the active-version series held to what was
   sent and to ``/serve/status``;
21. runs the ``multi_input`` phase: a two-input, two-output
   ``ComputationGraph`` through ``make_predict_fn`` and the micro-batcher on
   the card, within 1e-6 of its card ``output``;
22. runs the ``parallel`` phase (A7, ``ParallelWrapper`` over
   ``torch.distributed``): on an NCCL group of one, full-width
   ``transformer_lm(256)`` at B = 16, T = 256, each mode from the same state
   as ``fit`` on the same batches: sync DP as 4 single steps and an 8-step
   K-step group (a CUDA graph with the NCCL collectives captured; losses and
   params within 1e-5 relative), ``zero3``, local SGD at frequency 2, and
   ``sequence_parallel`` Ulysses and ring on ``{"data": 1, "sp": 1}``,
   ``PipelineTrainer`` on ``{"stage": 1}`` (4 microbatches of 4 rows: the
   GPipe schedule's ticks on one rank);
   ResNet-50 at 224x224, B = 128 for 2 steps through batch norm's group path
   (within 1e-4, cuDNN deterministic); ``moe_transformer_lm(256)`` at B = 8,
   T = 256 through ``expert_parallel("data", 8)`` on ``{"data": 1}`` (the
   capacity packing and the all_to_all of one rank; no token dropped);
   exact launches of the flash kernels and ``sm_xent``; then two gloo ranks
   on the one card (the modes whose collectives gloo carries on CUDA
   tensors: dp, zero3, Ulysses, the pipeline on ``{"stage": 2}``, dp_tp on
   ``{"data": 1, "model": 2}``) against one rank, within 1e-4, with each
   rank's launches (the pipeline's 4 microbatches through a stage's 2
   blocks, dp_tp's attention on 2 of the 4 heads), and the MoE LM's
   expert-parallel steps on ``{"data": 2}`` (4 experts a rank): one at
   capacity factor 8 against one rank's fit, one at the default 2.0 against
   the same step on a CPU clone in the same group (the loss, the routing
   and the drops; the gradient of the leaves no expert's ReLU slope reaches
   within 1e-5, the whole gradient within twice the dense path's own
   card-to-CPU distance on the same batch); each mode's ms a step beside
   ``fit``'s;
23. runs the ``param_server`` phase (A7.3) on the parallel phase's model
   and shapes: one inproc worker at push frequency 4 over 8 batches
   against ``fit`` from the same state (the JAX suite's rtol 2e-4, atol
   2e-5; 2 pushes; exact launches: 32 of each flash kernel, 8 ``sm_xent``),
   two inproc workers (every step counted, version == pushes, the score
   falls), then two worker processes on the card over tcp with bf16 deltas
   and two over shm (each reporting its own process's launches, the
   coordinator launching none; the shm rings and shard segments used; the
   score falls; no orphan segment); the server's ``dl4j_ps_*`` series and
   the worker processes' wire and ring series held against the stats;
   then one traced push over tcp (A9.2): the frontend's ``ps.apply`` joins
   the worker's trace id, parented on its RPC span;
24. runs the ``elastic`` phase (A7.4, A7.8's checkpoints): two shm worker
   processes on the card, shard 0's SIGKILLed once its group committed its
   first window; every group committed through its fin marker, a handoff,
   no orphan segment, the score falls; then ``save_sharded`` and
   ``restore_sharded`` on the card bitwise (params, states, updater state)
   and an async save whose sidecar appears only after ``wait``; the
   joins and handoffs series against the trainer's stats;
25. runs the ``sharded`` phase (A7.8's second half; every slot on the one
   card, so it measures correctness, launches and the cost of gathering at
   use, not a gain across cards): (a) the serve phase's full-width
   ``transformer_lm(256)`` (seed-1234 weights) pinned float32 and int8
   with ``sharding="dp_tp"`` on ``build_mesh({"data": 2, "model": 2},
   devices=["cuda:0"] * 4)``, ``[B, 512]`` ids at B = 1, 2, 3, 4, 8 held
   bitwise against the whole pin, the per-device param bytes against the
   partition math and each slot's tensors, exactly 4 ``flash_fwd`` and 17
   ``fixed_matmul`` launches for each data slot that runs rows, the wall
   ms of a sharded and a whole ``[8, 512]`` predict with the pins'
   products through ``fixed_matmul`` and, in turns, through cuBLAS; (b)
   ``InferenceServer(replicas=2, sharding="dp_tp", replica_devices=
   ["cuda:0"] * 8)`` answering 32 ``/v1/predict`` requests of two rows
   over HTTP with a rolling swap to v2 in flight (the last round of 4
   sent once the swap has returned; none lost, each the
   sharded pin's answer and the whole pin's, bitwise, 8 launches a
   dispatch, each replica's status listing its 4 slots and mesh); then on
   two gloo ranks sharing the card, (c) a sharded checkpoint of the
   train-shape model after one ``dp_tp`` step restored onto the ``dp_tp``
   specs on ``{"data": 1, "model": 2}`` (each rank's blocks bitwise the
   saved slices, ``output`` bitwise a whole restore's, 2 ``dp_tp`` steps
   from it within 1e-4 of one rank's fit from the whole restore, exact
   launches) and (d) a zip ``CheckpointListener`` and
   ``ParamAndGradientIterationListener`` on 2-step fits through ``dp_tp``,
   ``zero3`` on ``{"data": 2}`` and ``PipelineTrainer`` on
   ``{"stage": 2}``: the last zip restored bitwise the state the fit
   leaves, the launches those of the same fit without the listeners;
26. runs the ``c3`` phase (before ``sharded``): the flash forward at D = 64
   with 2 and with 4 key splits in turns at the sharded pins' predict shape
   (B 4, T 512, H 4), the serve shape (B 2, T 512), the whole pin's
   (B 8, T 512), the training shape (B 16, T 256) and the pipeline's
   microbatch (B 4, T 256), each against the plain version and beside the
   count the plan takes there (4 at T 512, 2 at T 256); and, for every
   dense product of a pin (Wqkv, Wo, W1, W2, the head; float32 and the
   int8 route's dequantized weight), whether a row comes out with the same
   bits at every row count from 1 to 4,096: under ``fixed_matmul``
   (``csrc/fixed_matmul.cu``, which must) and under cuBLAS (recorded);
27. runs the ``keras`` phase (A8.1): (a) a Keras-1 archive of
   ``keras.applications``' VGG-16 (Keras 1.2 layout, Theano ordering,
   138,357,544 float32 params from a seed, about 553 MB) written by the
   port's own HDF5 writer, read back and imported on the card and on the
   CPU (every param bitwise the archive's after the TH-to-HWIO transpose;
   the card's softmax output at B = 2 within 1e-5 of its largest value from the CPU's),
   then fine-tuned 4 steps at B = 32 on 224x224 inputs (exactly 4
   ``sm_xent`` launches), with the write, read, import and step times; (b)
   the same file through ``load_model_file`` and a ``ModelRegistry`` pin,
   bitwise the imported network's output with its dense products through
   ``fixed_matmul``, as a pin's; (c) a character LSTM archive at
   char_rnn's widths (two ``LSTM(200)`` with sigmoid gates over T 50 of
   64 characters, ``TimeDistributedDense(64, softmax)``) whose card output
   is held within 1e-5 of the CPU's, then the Keras gateway ``Server`` on
   127.0.0.1 with a token: ``call``s to ``fit`` over HDF5 minibatch
   directories of 8 batches of 32 (exactly 16 ``lstm_fwd``, 16
   ``lstm_bwd``, 8 ``sm_xent``), ``evaluate`` (16 ``lstm_fwd``) and
   ``predict`` (2); (d) the same archive with Keras 1's default
   ``hard_sigmoid`` gates: no LSTM launch, the output against the CPU, one
   ``fit`` step with one ``sm_xent``;
28. runs the ``native`` phase (A8.2 and DataVec): (a) the host runtime
   built on the card's machine (the compiler and seconds printed); (b)
   MNIST-sized IDX files (60,000 x 28 x 28 and their labels, from a seed)
   parsed natively, in Python and by ``datasets.mnist``, bitwise; (c)
   ``AsyncNativeLoader.mnist`` at B = 128, its epoch bitwise its Python
   route's, feeding one epoch of full-width LeNet-5 ``fit`` (exactly one
   ``sm_xent`` a batch), with the loader's batches/s beside the Python
   route's; (d) a CSV of 204,800 Iris-shaped rows parsed natively bitwise
   the general reader's, then through ``CSVRecordReader`` and
   ``RecordReaderDataSetIterator`` (B = 1,024) into the Iris MLP's
   ``fit_iterator`` (exactly 200 ``sm_xent``, accuracy above 0.9); (e)
   broker frames: the runtime's ``decode_records`` on each float32 array
   bitwise ``wire.decode_array``, and a consumer's frames bitwise what was
   sent;
29. runs the ``nlp`` phase (A8.3's ``nlp/`` and ``graph/``; no TPU kernel
   on the path, so no kernel's launch count may move): (a) Word2Vec at
   BASELINE config 4 through ``Word2Vec.builder()...fit()`` (vocab 10,000:
   every word once, then 200,000 Zipf-drawn tokens in sentences of 20,
   from a numpy seed; vectors of 100, 5 negatives, HS off, window 5,
   1,024-pair batches): the first 20,000 tokens fitted on the card and on
   the CPU from the same seed, syn0 and syn1neg within 1e-4 (norm); the
   whole corpus on the card, its pairs/s; 32 of its batches profiled
   (device ms a batch, idle share, top device ops); the bare step at
   bench.py's shape (32 batches of 1,024 random pairs) timed beside its
   bound; (b) one small fit each on the card against the CPU within 1e-4:
   HS CBOW Word2Vec, ParagraphVectors DBOW with ``infer_vector``, GloVe,
   ``SparkWord2Vec`` on 4 workers, DeepWalk on a 1,000-vertex graph;
30. runs the ``embed`` phase (A8.3's ``clustering/`` and ``plot/``; no TPU
   kernel on the path, so no kernel's launch count may move) over the nlp
   phase's trained ``syn0`` [10,000, 100] (a seeded table of that shape
   when the phase runs alone): (a) exact ``Tsne`` on every row (2
   components, perplexity 30, 500 iterations): wall, its step's device ms
   from the profiler over 5 steps beside its bound, peak memory, the final
   KL; (b) the same on the first 1,000 rows on the card and on the CPU: P
   within 1e-9 relative, coordinates after 3 iterations within 1e-4, each
   final KL below its value at iteration 100; (c) ``KMeansClustering`` at
   k 100, euclidean and cosine, up to 100 iterations, on the card and on
   the CPU: the same iterations and assignments, centers within 1e-5; (d)
   ``BarnesHutTsne`` on the host at 256 rows for 50 iterations, and its
   exact route at 48 rows on the card against the CPU;
31. reads the profiler's device time of every main-path kernel row and its
   library call (``fixed_matmul`` against cuBLAS at each pin product, held
   against its plain version at step 3), and of ``lstm_fwd``'s two and
   ``lstm_bwd``'s three parts a call at the training shapes;
32. prints one JSON line describing each kernel (``fixed_matmul``'s too),
   then
   ``{"ok": true, "device": {...}}`` as the last line.

To debug a phase alone on the card, ``run_phases`` sets the card up,
builds the kernels and runs the named phases (``fixed_matmul``, ``c3``,
``sharded_pins``, ``sharded``, ``keras``, ``native``, ``nlp``, ``embed``,
``serve``, ``tracing`` (the serve phase, which ends with it), ``replicas``,
``diagnostics``, ``parallel``, ``param_server``, ``elastic``).

Any failed check exits non-zero without the last line. Without CUDA it
exits non-zero before printing anything. Full results also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import copy
import http.client
import json
import os
import re
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from deeplearning4j_tpu_torch import convert
from deeplearning4j_tpu_torch.keras_server import InferenceServer
from deeplearning4j_tpu_torch.keras_server.serve_profile import (
    device_events, device_time_by_kernel)
from deeplearning4j_tpu_torch.datasets import (
    IrisDataSetIterator, MnistDataSetIterator)
from deeplearning4j_tpu_torch.models import (
    alexnet, char_rnn_lstm, googlenet, lenet_mnist, moe_transformer_lm,
    resnet50, transformer_lm, vgg16)
from deeplearning4j_tpu_torch.nn.conf.builders import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    RBM, AutoEncoder, DenseLayer, GlobalPoolingLayer, MoETransformerBlock,
    OutputLayer, SelfAttentionLayer, VariationalAutoencoder)
from deeplearning4j_tpu_torch.common import get_policy, set_policy
from deeplearning4j_tpu_torch.nn.graph_network import (
    ComputationGraph, graph_forward, make_graph_pretrain_step,
    make_graph_train_step)
from deeplearning4j_tpu_torch.nn.inference import PredictFn
from deeplearning4j_tpu_torch.nn.multilayer import (
    UPDATER_LABEL, MultiLayerNetwork)
from deeplearning4j_tpu_torch.ops import _cuda
from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
from deeplearning4j_tpu_torch.ops.flash_attention import (
    bwd_delta, flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq,
    flash_bwd_dq_plain, flash_fwd, flash_fwd_plain)
from deeplearning4j_tpu_torch.ops.paged_attention import (
    paged_gather, paged_gather_plain)
from deeplearning4j_tpu_torch.ops.fixed_matmul import (
    fixed_matmul, fixed_matmul_plain)
from deeplearning4j_tpu_torch.ops.quant import (
    dequantize_leaf, int8_matmul, int8_matmul_plain, int8_matmul_plan,
    quantize_per_channel)
from deeplearning4j_tpu_torch.ops.softmax_xent import (
    sm_xent_plan, softmax_cross_entropy, softmax_cross_entropy_plain)

SEED = 1234
#: the training phase: the JAX package's LM bench geometry
TRAIN_B, TRAIN_T, TRAIN_V, TRAIN_STEPS = 16, 256, 256, 5
#: the recurrent path: full-width char_rnn_lstm (BASELINE config 3, the JAX
#: package's bench geometry), 2 batches of T = 200 = 4 TBPTT chunks of 50
RNN_V, RNN_H, RNN_B, RNN_T, RNN_CHUNK, RNN_BATCHES = 64, 200, 32, 200, 50, 2
RNN_DECODE_B = 8
#: the wide phase: full-width transformer_lm(256, width=512), 4 heads of 128
WIDE_WIDTH, WIDE_B, WIDE_T, WIDE_STEPS = 512, 4, 128, 2
#: the D > 128 phase: full-width transformer_lm(256, width=512, n_heads=2),
#: 2 heads of 256 (csrc/flash_wide.cu), at the wide phase's B and T
WIDE2_HEADS = 2
#: head dims the flash checks add to the main paths' 64: the kernel widths
#: 16 and 128, dims padded to a width (8, 12 -> 16; 40 -> 64), and dims above
#: 128 (flash_wide.cu's column groups: 2, 2 and 4)
FLASH_EDGE_DIMS = (8, 12, 16, 40, 128, 160, 256, 512)
#: the LeNet phase: full-width lenet_mnist (BASELINE config 1) at the JAX
#: bench's batch of 128; 5 compared steps, a fit_iterator epoch of 20
#: batches, 1,000 test digits, 64 served rows, 2 warm-up and 20 timed steps
LENET_B, LENET_STEPS, LENET_EPOCH_BATCHES, LENET_TEST = 128, 5, 20, 1000
LENET_SERVE_ROWS, LENET_TIMED = 64, 20
#: RMSProp rate of the training phase. At the config's own 0.1 the loss
#: diverges (4.2 -> 44 in 8 chunks) and the card and the CPU drift 2e-4
#: apart (PERF.md, Findings); at 0.01 the run stays stable. Widths unchanged.
RNN_LR = 0.01
#: published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
#: (row, kernel call, library call[, calls a session]) whose device time
#: the profiler reads after every other measurement (see
#: measure_device_times)
DEVICE_TIMED: list = []
#: flash_wide.cu's backward at its edge shapes (no library call), device
#: time read with DEVICE_TIMED's
WIDE_EDGES: list = []
#: (row, wrapper, its arguments, its parts, the row's key) of the training
#: chunks, whose device time the profiler splits into lstm_fwd's and
#: lstm_bwd's parts after every other measurement
LSTM_SPLIT: list = []
#: lstm_bwd's parts by kernel: the hoisted gate product, the recurrence, the
#: tail's products and the sum of their slices (csrc/lstm.cu)
LSTM_BWD_PARTS = {"hoisted": ("lstm_z_kernel",),
                  "recurrence": ("lstm_bwd_kernel",),
                  "tail": ("lstm_tail_kernel", "lstm_sum_kernel")}
#: lstm_fwd's parts by kernel at T > 1: the hoisted input product and the
#: recurrence
LSTM_FWD_PARTS = {"hoisted": ("lstm_fwd_x_kernel",),
                  "recurrence": ("lstm_fwd_kernel",)}
#: the card's name and power limit, as nvidia-smi prints them
CARD = ""


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls,
    from CUDA events, after ``warmup`` calls."""
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


def device_ms(fn, iters: int = 50) -> tuple:
    """Mean device time of one call of ``fn`` in ms from ``torch.profiler``
    over ``iters`` calls, after a warm-up: the device time a recorded event
    (kernels, copies) times the events a call makes, the median of three
    sessions. Unlike :func:`time_ms` it leaves out the host's time between
    launches, which dominates a kernel of a few microseconds. Returns
    ``(ms, source)``: when fewer than three of eight sessions saw device
    time (on the H100 the profiler has, once in a run, stopped seeing any
    for a stretch of sessions), the median of those that did, else
    :func:`time_ms`'s CUDA-event time, and ``source`` says which."""
    for _ in range(3):
        fn()
    # a profiler session may record none or only a part of the device
    # events (seen on the H100: 44 of 50 launches of an 8 us kernel, a third
    # of a flash kernel's), so the time is taken a recorded event; the
    # events a call makes come from the fullest session, rounded
    got = []  # (device events, device us)

    def median():
        per_call = max(1, round(max(n for n, _ in got) / iters))
        times = sorted(us / n * per_call / 1e3 for n, us in got)
        return times[len(times) // 2]
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(device_time_by_kernel(prof).values())
        events = sum(n for _, n, _ in device_events(prof))
        if us > 0 and events > 0:
            got.append((events, us))
            if len(got) == 3:
                return median(), "torch.profiler"
        else:
            print("device_ms: the profiler saw no device time; again",
                  flush=True)
    print(f"device_ms: the profiler saw device time in {len(got)} of eight "
          "sessions", flush=True)
    if got:
        return median(), f"torch.profiler, {len(got)} sessions"
    return time_ms(fn, iters), "CUDA events"


def device_ms_by_kernel(fn, iters: int = 20):
    """Device ms a call of ``fn`` by kernel (the profiler's name), as
    :func:`device_ms` takes it: each kernel's time a recorded event times
    the events a call makes (from the fullest of three sessions), the median
    of the three; of fewer when fewer of eight sessions saw device time, and
    None when none did."""
    for _ in range(3):
        fn()
    sessions = []
    for _ in range(8):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per = {key: (n, us) for key, n, us in device_events(prof)
               if us and n}
        if per:
            sessions.append(per)
            if len(sessions) == 3:
                break
    if len(sessions) < 3:
        print(f"device_ms_by_kernel: the profiler saw device time in "
              f"{len(sessions)} of eight sessions", flush=True)
    if not sessions:
        return None
    out = {}
    for key in set().union(*sessions):
        seen = [s[key] for s in sessions if key in s]
        per_call = max(1, round(max(n for n, _ in seen) / iters))
        times = sorted(us / n for n, us in seen)
        out[key] = times[len(times) // 2] * per_call / 1e3
    return out


def kernel_parts(by_kernel: dict, parts: dict) -> dict:
    """Device time of a wrapper's parts (``LSTM_BWD_PARTS``,
    ``LSTM_FWD_PARTS``) from times by kernel name."""
    return {part: sum(v for k, v in by_kernel.items()
                      if any(n in k for n in names))
            for part, names in parts.items()}


def ptxas_report(log: str) -> list:
    """One line a kernel from nvcc's ``-Xptxas -v`` output: the kernel with
    its template arguments (read from the mangled name), registers, spills."""
    out, name, spill = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
            p = name.find("_kernelI")
            if p >= 0:  # e.g. ...19flash_bwd_dq_kernelIfLi64EEEv...
                start = p
                while start > 0 and (name[start - 1].islower()
                                     or name[start - 1] == "_"):
                    start -= 1
                args = name[p + len("_kernelI"):].split("EEv")[0]
                dtype = "bf16" if "bfloat16" in args else "float"
                ints = re.findall(r"Li(\d+)E", args + "E")
                name = f"{name[start:p]}_kernel<{', '.join([dtype, *ints])}>"
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            regs = line.split("Used")[-1].split(",")[0].strip()
            out.append(f"{name}: {regs}; {spill}")
    return out


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """Least time in ms the card could take and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def report(rows: list, name: str, shape: dict, err: float, tol: float,
           ms: float, plain_ms: float, library_ms, nbytes: float, ops: float,
           extra: dict = None, ops_per_s: float = F32_OPS_PER_S):
    """Record and print a kernel's row; its bound is ``ops`` at
    ``ops_per_s`` (the float32 peak unless the kernel runs another
    arithmetic) or ``nbytes`` at the memory's rate."""
    bound_ms, bound_by = bound(nbytes, ops, ops_per_s)
    row = {"name": name, "shape": shape, "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, **(extra or {})}
    rows.append(row)
    print(f"{name} {shape}: max_abs_err={err:.3e} (tol {tol:.0e}) "
          f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms} "
          f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}, "
          f"{100 * row['bound_ms'] / ms:.1f}% of it)"
          + (f" [{row['card']}]" if "card" in row else ""), flush=True)
    if not err <= tol:
        fail(f"{name} {shape} disagrees with its plain version: "
             f"{err} > {tol}")
    return row


def measure_device_times() -> None:
    """``device_ms`` and ``library_device_ms`` of the rows queued in
    ``DEVICE_TIMED``. Run after every other timing: the profiler is left
    attached to the process once used, and could slow later launches."""
    for row, kernel, library, *iters in DEVICE_TIMED:
        iters = iters[0] if iters else 50
        row["device_ms"], src = device_ms(kernel, iters)
        row["library_device_ms"], lib_src = (None, None) if library is None \
            else device_ms(library, iters)
        if "torch.profiler" not in src or "torch.profiler" not in (
                lib_src or src):
            row["device_ms_source"] = [src, lib_src]
        print(f"{row['name']} {row['shape']}: device_ms="
              f"{row['device_ms']:.5f} library_device_ms="
              f"{row['library_device_ms']} ({src}; {lib_src}; mean per call)",
              flush=True)
    # lstm_fwd's and lstm_bwd's parts at the training chunks' shapes
    for row, fn, args, parts, key in LSTM_SPLIT:
        by_kernel = device_ms_by_kernel(lambda: fn(**args))
        if by_kernel is None:  # not measured in this run
            row[key] = None
            continue
        got = kernel_parts(by_kernel, parts)
        row[key] = {**got, "total": sum(got.values())}
        print(f"{row['name']} {row['shape']}: device ms a call by part: "
              + ", ".join(f"{k} {v:.5f}" for k, v in row[key].items()),
              flush=True)


def check_int8(rows: list, dev) -> None:
    g = torch.Generator(device="cpu").manual_seed(SEED)
    # float32 sums in another order than cuBLAS: ~K * 2^-24 relative
    tol = 1e-4
    for M in (4, 8, 16):
        for K, N in ((256, 768), (256, 256), (256, 1024), (1024, 256)):
            x = torch.randn(M, K, generator=g).to(dev)
            leaf = quantize_per_channel(
                (torch.randn(K, N, generator=g) * 0.05).to(dev))
            wd = dequantize_leaf(leaf)
            out = int8_matmul(x, leaf.q, leaf.scale)
            ref = int8_matmul_plain(x, leaf.q, leaf.scale)
            again = int8_matmul(x, leaf.q, leaf.scale)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not torch.equal(out, again):
                fail(f"int8_matmul M={M} K={K} N={N} differs from run to run")
            kc, slices = int8_matmul_plan(
                M, K, N, torch.cuda.get_device_properties(dev)
                .multi_processor_count)

            def kernel(x=x, leaf=leaf):
                return int8_matmul(x, leaf.q, leaf.scale)

            def library(x=x, wd=wd):
                return torch.matmul(x, wd)

            row = report(rows, "int8_matmul", {"M": M, "K": K, "N": N}, err,
                         tol, time_ms(kernel),
                         time_ms(lambda: int8_matmul_plain(x, leaf.q,
                                                           leaf.scale)),
                         time_ms(library),
                         M * K * 4 + K * N + N * 4 + M * N * 4, 2 * M * K * N,
                         {"card": CARD, "plan": {"kc": kc, "slices": slices}})
            DEVICE_TIMED.append((row, kernel, library))
    x = torch.randn(16, 256, generator=g).to(dev).to(torch.bfloat16)
    leaf = quantize_per_channel(torch.randn(256, 768, generator=g).to(dev))
    err = float((int8_matmul(x, leaf.q, leaf.scale)
                 - int8_matmul_plain(x, leaf.q, leaf.scale)).abs().max())
    print(f"int8_matmul bf16 x: max_abs_err={err:.3e}", flush=True)
    if not err <= 1e-3:
        fail(f"int8_matmul with bfloat16 x disagrees: {err}")


def check_gather(rows: list, dev) -> None:
    g = torch.Generator(device="cpu").manual_seed(SEED)
    n_pages, ps, H, D, P = 16 * 32, 16, 4, 64, 32
    pool = torch.randn(n_pages + 1, ps, H, D, generator=g).to(dev)
    for cap in (8, 16):
        table = torch.randint(0, n_pages + 1, (cap, P), generator=g,
                              dtype=torch.int32)
        table[:, -3:] = 0  # trash page rows are gathered like any other
        table = table.to(dev)
        out = paged_gather(pool, table)
        ref = paged_gather_plain(pool, table)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"paged_gather cap={cap} is not bitwise equal to index_select")
        flat = table.reshape(-1).long()
        nbytes = 2 * cap * P * ps * H * D * 4 + cap * P * 4

        def kernel(table=table):
            return paged_gather(pool, table)

        def library(flat=flat):
            return pool.index_select(0, flat)

        row = report(rows, "paged_gather",
                     {"n_pages": n_pages, "ps": ps, "H": H, "D": D,
                      "cap": cap, "P": P}, 0.0, 0.0, time_ms(kernel),
                     time_ms(lambda: paged_gather_plain(pool, table)),
                     time_ms(library), nbytes, 0)
        DEVICE_TIMED.append((row, kernel, library))


def check_flash(rows: list, dev) -> None:
    """Kernel 1 at the serving path's shapes (predict [2, 512], and B = 8),
    at the training path's (B 16, T 256), and at edge shapes: a ragged
    T = 100 with a key mask that fully masks one batch row, and bfloat16."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    # float32 online softmax against the one-pass plain version
    tol = 2e-5
    H, D = 4, 64
    # besides: the pipeline's microbatch and an expert-parallel rank's rows
    # (B 4), a dp_tp rank's heads (2 of the train shape's 4), and a sharded
    # pin's data slot at B 8 on {data: 2} (4 rows of 512)
    for B, T, Hh in ((2, 512, H), (8, 512, H), (TRAIN_B, TRAIN_T, H),
                     (MOE_B, MOE_T, H), (REPLICA_B, REPLICA_T, H),
                     (TRAIN_B // PAR_PIPE_M, TRAIN_T, H),
                     (TRAIN_B, TRAIN_T, PAR_TP_HEADS),
                     (8 // SH_AXES["data"], 512, H)):
        q, k, v = (torch.randn(B, T, Hh, D, generator=g).to(dev)
                   for _ in range(3))
        out, lse = flash_fwd(q, k, v, True)
        ro, rl = flash_fwd_plain(q, k, v, True)
        again = flash_fwd(q, k, v, True)
        torch.cuda.synchronize()
        err = max(float((out - ro).abs().max()), float((lse - rl).abs().max()))
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            fail(f"flash_fwd B={B} T={T} differs from run to run")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = B * Hh * T * (T + 1) / 2
        nbytes, ops = 4 * B * T * Hh * D * 4 + B * Hh * T * 4, 4 * D * pairs

        def kernel(q=q, k=k, v=v):
            return flash_fwd(q, k, v, True)

        def library(qt=qt, kt=kt, vt=vt):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        # the kernel runs both products as three TF32 passes on the tensor
        # cores: its bound is that work at the TF32 peak; the float32 bound
        # (the same products on the CUDA cores) is kept beside it
        f32_ms, f32_by = bound(nbytes, ops)
        tc_ms, tc_by = bound(nbytes, 3 * ops, TF32_OPS_PER_S)
        row = report(rows, "flash_fwd", {"B": B, "T": T, "H": Hh, "D": D,
                                         "causal": True}, err, tol,
                     time_ms(kernel, iters=20),
                     time_ms(lambda: flash_fwd_plain(q, k, v, True), iters=20),
                     time_ms(library, iters=20), nbytes, ops,
                     {"card": CARD, "bound_ms": tc_ms, "bound_by": tc_by,
                      "bound_f32_ms": f32_ms, "bound_f32_by": f32_by})
        DEVICE_TIMED.append((row, kernel, library))
    # the wide phases' shapes (4 heads of 128; 2 heads of 256, flash_wide.cu),
    # timed beside their bounds, and bitwise the same from run to run. Every
    # width is held to the same bound: float32 work as three TF32 passes at
    # the tensor cores' peak
    for H_, D in ((H, 128), (WIDE2_HEADS, WIDE_WIDTH // WIDE2_HEADS)):
        B, T = WIDE_B, WIDE_T
        q, k, v = (torch.randn(B, T, H_, D, generator=g).to(dev)
                   for _ in range(3))
        out, lse = flash_fwd(q, k, v, True)
        again = flash_fwd(q, k, v, True)
        ro, rl = flash_fwd_plain(q, k, v, True)
        err = max(float((out - ro).abs().max()), float((lse - rl).abs().max()))
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            fail(f"flash_fwd B={B} T={T} D={D} differs from run to run")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = B * H_ * T * (T + 1) / 2
        nbytes, ops = 4 * B * T * H_ * D * 4 + B * H_ * T * 4, 4 * D * pairs

        def kernel(q=q, k=k, v=v):
            return flash_fwd(q, k, v, True)

        def library(qt=qt, kt=kt, vt=vt):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        f32_ms, f32_by = bound(nbytes, ops)
        tc_ms, tc_by = bound(nbytes, 3 * ops, TF32_OPS_PER_S)
        row = report(rows, "flash_fwd", {"B": B, "T": T, "H": H_, "D": D,
                                         "causal": True}, err, tol,
                     time_ms(kernel, iters=20),
                     time_ms(lambda: flash_fwd_plain(q, k, v, True), iters=20),
                     time_ms(library, iters=20), nbytes, ops,
                     {"card": CARD, "bound_ms": tc_ms, "bound_by": tc_by,
                      "bound_f32_ms": f32_ms, "bound_f32_by": f32_by})
        DEVICE_TIMED.append((row, kernel, library))
    # edge shapes: a ragged length, a key mask with a fully masked batch row,
    # Tq != Tk, every kernel width and padded head dims, bfloat16; each also
    # bitwise the same from run to run
    tol_bf16 = 2e-2
    cases = [(2, 100, 100, 64, False, True, torch.float32),
             (2, 100, 100, 64, True, True, torch.float32),
             (2, 130, 130, 64, True, False, torch.bfloat16)]
    cases += [(2, 100, 100, D, D not in (12, 16), D == 16, torch.float32)
              for D in FLASH_EDGE_DIMS]
    cases += [(2, 77, 200, 128, False, True, torch.float32),
              (2, 100, 100, 128, True, True, torch.float32),
              (2, 130, 130, 128, True, True, torch.bfloat16),
              (2, 100, 100, 12, True, True, torch.bfloat16),
              (2, 77, 200, 256, False, True, torch.float32),
              (2, 130, 130, 160, True, True, torch.bfloat16),
              (2, 100, 100, 256, False, True, torch.bfloat16),
              (2, 100, 100, 512, True, True, torch.bfloat16)]
    for B, Tq, Tk, D, causal, masked, dt in cases:
        H = 4 if D <= 128 else 2
        q = torch.randn(B, Tq, H, D, generator=g).to(dev).to(dt)
        k, v = (torch.randn(B, Tk, H, D, generator=g).to(dev).to(dt)
                for _ in range(2))
        km = None
        if masked:
            km = (torch.rand(B, Tk, generator=g) > 0.3).float()
            km[1] = 0.0  # every query row of batch 1 sees no key at all
            km = km.to(dev)
        out, lse = flash_fwd(q, k, v, causal, key_mask=km)
        again = flash_fwd(q, k, v, causal, key_mask=km)
        ro, rl = flash_fwd_plain(q, k, v, causal, key_mask=km)
        torch.cuda.synchronize()
        err = max(float((out.float() - ro.float()).abs().max()),
                  float((lse - rl).abs().max()))
        t = tol if dt == torch.float32 else tol_bf16
        shape = {"B": B, "Tq": Tq, "Tk": Tk, "H": H, "D": D,
                 "causal": causal, "masked": masked, "dtype": str(dt)}
        print(f"flash_fwd {shape}: max_abs_err={err:.3e} (tol {t:.0e})",
              flush=True)
        if not err <= t:
            fail(f"flash_fwd {shape} disagrees with its plain version: {err}")
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            fail(f"flash_fwd {shape} differs from run to run")
        if masked and out[1].any():
            fail(f"flash_fwd {shape}: a fully masked batch row is not 0")


#: sm_xent's shapes on the main paths: the transformer's training step,
#: char_rnn's TBPTT chunk, LeNet's (and the pretraining stacks') step,
#: ResNet-50's, the MoE LM's (B 8 x T 256 rows of 256), VGG-16's (B 64)
#: and AlexNet's and GoogLeNet's (B 32) steps of 1000 classes, their
#: checks against the CPU (VGG-16 at B 4, the other two at B 2), the
#: SelfAttention network's (B 4 of 10), Iris's (B 30 of 3) and an
#: expert-parallel rank's MoE LM rows (B 4 x T 256 of 256)
XENT_TIMED = ((TRAIN_B * TRAIN_T, TRAIN_V), (RNN_B * RNN_CHUNK, RNN_V),
              (LENET_B, 10), (128, 1000), (2048, 256), (64, 1000),
              (32, 1000), (4, 1000), (2, 1000), (4, 10), (30, 3),
              (1024, 256), (1024, 3))


def check_xent(rows: list, dev) -> None:
    """Kernel 4 at the training paths' shapes (``XENT_TIMED``: [4096, 256]
    float32 logits, char_rnn's [1600, 64], LeNet's [128, 10], ResNet-50's
    [128, 1000] and the shapes of the MoE, zoo, SelfAttention and Iris
    paths),
    at a vocab of 50,257 (a block a row), at
    the widest and the narrowest row a warp takes besides, and with bfloat16
    logits; each bitwise the same from run to run. Its yardstick is
    ``F.cross_entropy`` with probability targets, forward and backward."""
    g = torch.Generator(device="cpu").manual_seed(SEED)
    # loss: float32 row sums of up to 50,257 terms in another order; grad:
    # one float32 rounding, or one bfloat16 ulp at magnitudes up to 1
    for N, C, dt, loss_tol, grad_tol in (
            (TRAIN_B * TRAIN_T, TRAIN_V, torch.float32, 1e-5, 1e-6),
            (RNN_B * RNN_CHUNK, RNN_V, torch.float32, 1e-5, 1e-6),
            (LENET_B, 10, torch.float32, 1e-5, 1e-6),
            (128, 1000, torch.float32, 1e-5, 1e-6),
            (2048, 256, torch.float32, 1e-5, 1e-6),
            (64, 1000, torch.float32, 1e-5, 1e-6),
            (32, 1000, torch.float32, 1e-5, 1e-6),
            (4, 1000, torch.float32, 1e-5, 1e-6),
            (2, 1000, torch.float32, 1e-5, 1e-6),
            (4, 10, torch.float32, 1e-5, 1e-6),
            (30, 3, torch.float32, 1e-5, 1e-6),
            (1024, 256, torch.float32, 1e-5, 1e-6),
            (1024, 3, torch.float32, 1e-5, 1e-6),
            (64, 50257, torch.float32, 1e-5, 1e-6),
            (64, 2048, torch.float32, 1e-5, 1e-6),
            (65, 2049, torch.float32, 1e-5, 1e-6),
            (1601, 33, torch.float32, 1e-5, 1e-6),
            (TRAIN_B * TRAIN_T, TRAIN_V, torch.bfloat16, 1e-5, 4e-3)):
        x = (torch.randn(N, C, generator=g) * 3).to(dev).to(dt)
        # labels in the logits' dtype, the instantiation mcxent launches
        y = F.one_hot(torch.randint(0, C, (N,), generator=g), C).to(dev).to(dt)
        loss, grad = softmax_cross_entropy(x, y)
        again = softmax_cross_entropy(x, y)
        rl, rg = softmax_cross_entropy_plain(x, y)
        torch.cuda.synchronize()
        if not (torch.equal(loss, again[0]) and torch.equal(grad, again[1])):
            fail(f"sm_xent N={N} C={C} {dt} differs from run to run")
        lerr = float((loss - rl).abs().max())
        gerr = float((grad.float() - rg.float()).abs().max())
        print(f"sm_xent N={N} C={C} {dt}: loss max_abs_err={lerr:.3e} (tol "
              f"{loss_tol:.0e}), grad max_abs_err={gerr:.3e} (tol "
              f"{grad_tol:.0e})", flush=True)
        if not (lerr <= loss_tol and gerr <= grad_tol):
            fail(f"sm_xent N={N} C={C} {dt} disagrees with its plain version")
        xl = x.float().clone().requires_grad_(True)
        yl = y.float()

        def kernel(x=x, y=y):
            return softmax_cross_entropy(x, y)

        def library(xl=xl, yl=yl):
            return torch.autograd.grad(
                F.cross_entropy(xl, yl, reduction="sum"), xl)

        elt = x.element_size()
        plan = sm_xent_plan(N, C, dt)
        row = report(rows, "sm_xent", {"N": N, "C": C, "dtype": str(dt)},
                     max(lerr, gerr), max(loss_tol, grad_tol),
                     time_ms(kernel),
                     time_ms(lambda: softmax_cross_entropy_plain(x, y)),
                     time_ms(library) if dt == torch.float32 else None,
                     3 * N * C * elt + N * 4, 6 * N * C,
                     {"card": CARD, "plan": plan._asdict()})
        if (N, C) in XENT_TIMED and dt == torch.float32:
            DEVICE_TIMED.append((row, kernel, library))


def check_flash_bwd(rows: list, dev) -> None:
    """Kernels 2 and 3 at the training path's shape (B 16, T 256, 4 heads
    of 64, causal, float32), at the wide phases' (B 4, T 128, 4 heads of
    128 and 2 heads of 256) and at edge shapes: not causal, a ragged
    T = 100, a key mask that fully masks one batch row, every kernel width
    and padded head dims, bfloat16, and shapes that give ``flash_wide.cu``'s
    tile splits uneven or no work; each bitwise the same from run to run.
    Their yardstick is the backward of ``scaled_dot_product_attention``.
    The edges above D = 128 also get their device time (``WIDE_EDGES``)."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    # float32 sums in another order than the plain version's matmuls; one
    # bfloat16 ulp at magnitudes below 8
    tol, tol_bf16 = 2e-5, 3.2e-2
    wide2_d = WIDE_WIDTH // WIDE2_HEADS
    timed = {(TRAIN_B, TRAIN_T, 64), (WIDE_B, WIDE_T, 128),
             (WIDE_B, WIDE_T, wide2_d), (MOE_B, MOE_T, 64),
             (TRAIN_B // PAR_PIPE_M, TRAIN_T, 64)}
    cases = [(TRAIN_B, TRAIN_T, 4, 64, True, False, torch.float32),
             (MOE_B, MOE_T, 4, 64, True, False, torch.float32),
             # the pipeline's microbatch, an expert-parallel rank's rows,
             # a dp_tp rank's heads
             (TRAIN_B // PAR_PIPE_M, TRAIN_T, 4, 64, True, False,
              torch.float32),
             (TRAIN_B, TRAIN_T, PAR_TP_HEADS, 64, True, False,
              torch.float32),
             (WIDE_B, WIDE_T, 4, 128, True, False, torch.float32),
             (WIDE_B, WIDE_T, WIDE2_HEADS, wide2_d, True, False,
              torch.float32),
             (2, 100, 4, 64, False, True, torch.float32),
             (2, 100, 4, 64, True, True, torch.float32),
             (2, 100, 4, 32, True, False, torch.float32),
             (2, 256, 4, 64, False, False, torch.float32),
             (2, 128, 4, 64, True, False, torch.bfloat16)]
    cases += [(2, 100, 4 if D <= 128 else 2, D, D not in (12, 16),
               D in (16, 512), torch.float32) for D in FLASH_EDGE_DIMS]
    cases += [(2, 100, 4, 128, True, True, torch.float32),
              (2, 100, 4, 128, False, False, torch.bfloat16),
              (2, 100, 4, 8, True, True, torch.bfloat16),
              (2, 100, 4, 40, False, False, torch.bfloat16),
              (2, 100, 2, 160, False, True, torch.bfloat16),
              (2, 128, 2, 256, True, False, torch.bfloat16),
              (2, 100, 2, 512, True, True, torch.bfloat16)]
    # flash_wide.cu's 4 tile splits given uneven or empty work: 11 key
    # tiles under a causal mask at one head, a ragged T at D = 512, causal
    # and masked bfloat16, fewer tiles than splits (T = 19)
    cases += [(1, 333, 1, 256, True, False, torch.float32),
              (2, 45, 2, 512, False, True, torch.float32),
              (2, 77, 2, 256, True, True, torch.bfloat16),
              (2, 19, 2, 160, False, False, torch.float32)]
    for B, T, H, D, causal, masked, dt in cases:
        q, k, v, do = (torch.randn(B, T, H, D, generator=g).to(dev).to(dt)
                       for _ in range(4))
        km = None
        if masked:
            km = (torch.rand(B, T, generator=g) > 0.3).float()
            km[1] = 0.0  # every query row of batch 1 sees no key at all
            km = km.to(dev)
        out, lse = flash_fwd(q, k, v, causal, key_mask=km)
        delta = bwd_delta(out, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, km)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, km)
        dq2 = flash_bwd_dq(q, k, v, do, lse, delta, causal, km)
        dk2, dv2 = flash_bwd_dkv(q, k, v, do, lse, delta, causal, km)
        rq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, km)
        rk, rv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, km)
        torch.cuda.synchronize()
        eq = float((dq.float() - rq.float()).abs().max())
        ekv = max(float((dk.float() - rk.float()).abs().max()),
                  float((dv.float() - rv.float()).abs().max()))
        t = tol if dt == torch.float32 else tol_bf16
        shape = {"B": B, "T": T, "H": H, "D": D, "causal": causal,
                 "masked": masked, "dtype": str(dt)}
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                and torch.equal(dv, dv2)):
            fail(f"flash_bwd {shape} differs from run to run")
        if masked and (dq[1].any() or dk[1].any() or dv[1].any()):
            fail(f"flash_bwd {shape}: a fully masked batch row has a "
                 "gradient")
        if (B, T, D) not in timed:
            print(f"flash_bwd {shape}: dq max_abs_err={eq:.3e}, dk/dv "
                  f"max_abs_err={ekv:.3e} (tol {t:.1e})", flush=True)
            if not (eq <= t and ekv <= t):
                fail(f"flash_bwd {shape} disagrees with its plain version")
            if D > 128:  # flash_wide.cu's edges: device time, read later
                for name, kernel in (
                        ("flash_bwd_dq", lambda q=q, k=k, v=v, do=do, lse=lse,
                         delta=delta, c=causal, m=km:
                         flash_bwd_dq(q, k, v, do, lse, delta, c, m)),
                        ("flash_bwd_dkv", lambda q=q, k=k, v=v, do=do,
                         lse=lse, delta=delta, c=causal, m=km:
                         flash_bwd_dkv(q, k, v, do, lse, delta, c, m))):
                    row = {"name": name, "shape": shape, "card": CARD,
                           "max_abs_err": eq if name == "flash_bwd_dq"
                           else ekv, "tol": t}
                    WIDE_EDGES.append(row)
                    DEVICE_TIMED.append((row, kernel, None))
            continue
        qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True)
                      for a in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()

        def library(ot=ot, qt=qt, kt=kt, vt=vt, dot=dot):
            return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                       retain_graph=True)

        lib_ms = time_ms(library, iters=20)
        pairs = B * H * (T * (T + 1) / 2 if causal else T * T)
        row = B * T * H * D * 4
        stats = B * H * T * 4
        # every product as three TF32 passes on the tensor cores: the bound
        # is that work at the TF32 peak; the float32 bound (the same products
        # on the CUDA cores) is kept beside it
        for name, nbytes, ops, kernel, plain in (
                ("flash_bwd_dq", 5 * row + 2 * stats, 6 * D * pairs,
                 lambda q=q, k=k, v=v, do=do, lse=lse, delta=delta, c=causal,
                 m=km: flash_bwd_dq(q, k, v, do, lse, delta, c, m),
                 lambda: flash_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                            km)),
                ("flash_bwd_dkv", 6 * row + 2 * stats, 8 * D * pairs,
                 lambda q=q, k=k, v=v, do=do, lse=lse, delta=delta, c=causal,
                 m=km: flash_bwd_dkv(q, k, v, do, lse, delta, c, m),
                 lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                             km))):
            f32_ms, f32_by = bound(nbytes, ops)
            tc_ms, tc_by = bound(nbytes, 3 * ops, TF32_OPS_PER_S)
            r = report(rows, name, shape,
                       eq if name == "flash_bwd_dq" else ekv, t,
                       time_ms(kernel, iters=20), time_ms(plain, iters=20),
                       lib_ms, nbytes, ops,
                       {"card": CARD, "bound_ms": tc_ms, "bound_by": tc_by,
                        "bound_f32_ms": f32_ms, "bound_f32_by": f32_by})
            DEVICE_TIMED.append((r, kernel, library))


def _lstm_args(dev, g, T, B, F, H, peephole, masked):
    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    m = torch.ones(T, B)
    if masked:
        m = (torch.rand(T, B, generator=g) > 0.3).float()
        m[:, 0] = 0.0  # a batch row masked at every step
    return dict(x_t=r(T, B, F), wcat=r(F + H, 4 * H, scale=0.1),
                b=r(1, 4 * H, scale=0.1),
                peep=r(3, H, scale=0.3) if peephole else None,
                h0=r(B, H, scale=0.5), c0=r(B, H, scale=0.5), m_t=m.to(dev))


def _cudnn_lstm(dev, T, B, F, H):
    """``torch.nn.LSTM`` (cuDNN) at the same shape: the yardstick. It
    computes the cell without peepholes."""
    mod = torch.nn.LSTM(F, H).to(dev)
    x = torch.randn(T, B, F, device=dev, requires_grad=True)
    h0 = torch.zeros(1, B, H, device=dev)

    def fwd():
        with torch.no_grad():
            return mod(x, (h0, h0))

    def fwd_bwd():
        y, _ = mod(x, (h0, h0))
        return torch.autograd.grad(y.sum(), [x] + list(mod.parameters()))

    return fwd, fwd_bwd


def lstm_work(T, B, F, H):
    """(bytes, operations) of lstm_fwd and of lstm_bwd: each input read once
    and each output written once (float32); the gate matmuls at 2 operations
    a multiply-add and ~20 (forward) or ~40 (backward) elementwise
    operations per cell and step."""
    K = F + H
    w = 4 * (K * 4 * H + 4 * H + 3 * H)
    fwd_b = 4 * (T * B * F + T * B + 4 * B * H + 2 * T * B * H) + w
    fwd_o = 2 * T * B * K * 4 * H + 20 * T * B * H
    bwd_b = 4 * (T * B * (F + 3 * H) + T * B + 4 * B * H + T * B * F) + 2 * w
    bwd_o = (2 * T * B * K * 4 * H * 2 + 2 * T * B * H * 4 * H
             + 2 * T * B * F * 4 * H + 40 * T * B * H)
    return fwd_b, fwd_o, bwd_b, bwd_o


def check_lstm(rows: list, dev) -> None:
    """Kernels 5 and 6 at the recurrent path's shapes: a TBPTT chunk of each
    char_rnn layer (T 50, B 32, F 64 and 200, H 200, peepholes; the second
    with a ragged mask that holds one batch row at every step), a decode step
    (T 1, B 8) and a streamed step (T 1, B 1), each layer of the Keras
    gateway's imported LSTM (the same widths, no peepholes); and at edge
    shapes: no peepholes with a mask, H = 37. The backward gets nonzero dh/dc seeds and is run twice
    to check it bitwise."""
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    # forward: float32 dot products over F + H terms in another order
    fwd_tol = 2e-5
    # backward: dW sums T * B = 1,600 rows in another order than the plain
    # version's matmul, so each output is held to 1e-4 of its own largest
    # entry, plus 1e-5
    bwd_atol, bwd_rtol = 1e-5, 1e-4
    cases = [(RNN_CHUNK, RNN_B, RNN_V, RNN_H, True, False),
             (RNN_CHUNK, RNN_B, RNN_H, RNN_H, True, True),
             (1, RNN_DECODE_B, RNN_V, RNN_H, True, False),
             (1, RNN_DECODE_B, RNN_H, RNN_H, True, False),
             (1, 1, RNN_V, RNN_H, True, False),
             (RNN_CHUNK, RNN_B, RNN_V, RNN_H, False, True),
             (KERAS_RNN_T, KERAS_RNN_B, KERAS_RNN_V, KERAS_RNN_H, False,
              False),
             (KERAS_RNN_T, KERAS_RNN_B, KERAS_RNN_H, KERAS_RNN_H, False,
              False),
             (7, 3, 5, 37, True, True)]
    for T, B, F, H, peephole, masked in cases:
        a = _lstm_args(dev, g, T, B, F, H, peephole, masked)
        out = lstm_ops.lstm_fwd(**a)
        fagain = lstm_ops.lstm_fwd(**a)
        ref = lstm_ops.lstm_fwd_plain(**a)
        torch.cuda.synchronize()
        ferr = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        if not all(torch.equal(x, y) for x, y in zip(out, fagain)):
            fail(f"lstm_fwd {T, B, F, H} differs from run to run")
        if masked and not torch.equal(out[0][:, 0],
                                      a["h0"][0].expand(T, H)):
            fail(f"lstm_fwd {T, B, F, H}: a fully masked row moved")
        ys, cs = ref[0], ref[1]
        dys, dht, dct = (torch.randn(*s, generator=g).to(dev)
                         for s in ((T, B, H), (B, H), (B, H)))
        ba = dict(x_t=a["x_t"], hprev=torch.cat([a["h0"][None], ys[:-1]]),
                  cprev=torch.cat([a["c0"][None], cs[:-1]]), wcat=a["wcat"],
                  b=a["b"], peep=a["peep"], dys=dys, dht=dht, dct=dct,
                  m_t=a["m_t"])
        bout = lstm_ops.lstm_bwd(**ba)
        bref = lstm_ops.lstm_bwd_plain(**ba)
        again = lstm_ops.lstm_bwd(**ba)
        torch.cuda.synchronize()
        berrs = [float((o - r).abs().max()) for o, r in zip(bout, bref)]
        btols = [bwd_atol + bwd_rtol * float(r.abs().max()) for r in bref]
        shape = {"T": T, "B": B, "F": F, "H": H, "peephole": peephole,
                 "masked": masked}
        print(f"lstm {shape}: fwd max_abs_err={ferr:.3e} (tol {fwd_tol:.0e}); "
              "bwd max_abs_err (dx, dW, db, dpeep, dh0, dc0) = "
              f"{[f'{e:.2e}' for e in berrs]} against "
              f"{[f'{t:.2e}' for t in btols]}", flush=True)
        if not ferr <= fwd_tol:
            fail(f"lstm_fwd {shape} disagrees with its plain version: {ferr}")
        if not all(e <= t for e, t in zip(berrs, btols)):
            fail(f"lstm_bwd {shape} disagrees with its plain version")
        if not all(torch.equal(x, y) for x, y in zip(bout, again)):
            fail(f"lstm_bwd {shape} differs from run to run")
        if (F, H) == (5, 37) or (masked and not peephole):
            continue
        lib_f, lib_fb = _cudnn_lstm(dev, T, B, F, H)
        iters = 20 if T > 1 else 100
        fb, fo, bb, bo = lstm_work(T, B, F, H)
        shape["plan"] = lstm_ops.lstm_plan(T, B, F, H)
        shape["bwd_plan"] = lstm_ops.lstm_bwd_plan(T, B, F, H, peephole)
        def kernel(a=a):
            return lstm_ops.lstm_fwd(**a)

        row = report(rows, "lstm_fwd", shape, ferr, fwd_tol,
                     time_ms(kernel, iters=iters),
                     time_ms(lambda: lstm_ops.lstm_fwd_plain(**a), iters=5),
                     time_ms(lib_f, iters=iters), fb, fo, {"card": CARD})
        # every main-path shape: decode and stream steps (a few
        # microseconds of device) and the training chunks at 50 calls a
        # profiler session; the Keras gateway's layers (no peepholes, the
        # chunks' shapes) at 5, which keeps their readout short
        dev_iters = 50 if peephole else 5
        DEVICE_TIMED.append((row, kernel, lib_f, dev_iters))
        if T > 1 and peephole:
            LSTM_SPLIT.append((row, lstm_ops.lstm_fwd, a, LSTM_FWD_PARTS,
                               "fwd_parts_ms"))
        worst = max(range(6), key=lambda i: berrs[i] / btols[i])

        def bkernel(ba=ba):
            return lstm_ops.lstm_bwd(**ba)

        row = report(rows, "lstm_bwd", shape, berrs[worst], btols[worst],
                     time_ms(bkernel, iters=iters),
                     time_ms(lambda: lstm_ops.lstm_bwd_plain(**ba), iters=5),
                     time_ms(lib_fb, iters=iters), bb, bo)
        if T > 1:  # the backward runs in training only
            DEVICE_TIMED.append((row, bkernel, lib_fb, dev_iters))
        if T > 1 and peephole:
            LSTM_SPLIT.append((row, lstm_ops.lstm_bwd, ba, LSTM_BWD_PARTS,
                               "bwd_parts_ms"))


def post(port: int, path: str, body: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


#: one sample line of the Prometheus text exposition
_PROM_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? (\S+)$')


def scrape_metrics(port: int) -> dict:
    """``GET /metrics``, parsed: ``{(name, ((label, value), ...)): float}``
    for every sample line; fails on another status, content type or an
    unparseable line."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        ctype, text = resp.getheader("Content-Type"), resp.read().decode()
    finally:
        conn.close()
    if resp.status != 200 or ctype != "text/plain; version=0.0.4":
        fail(f"/metrics answered {resp.status} with {ctype!r}")
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _PROM_SAMPLE.match(line)
        if m is None:
            fail(f"/metrics line does not parse: {line!r}")
        labels = tuple(sorted(re.findall(r'(\w+)="([^"]*)"',
                                         m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def metric_delta(after: dict, before: dict, name: str, **labels) -> float:
    """How far one series moved between two scrapes (summed over the
    series whose labels include ``labels``)."""
    want = set((k, str(v)) for k, v in labels.items())

    def total(samples):
        return sum(v for (n, lab), v in samples.items()
                   if n == name and want <= set(lab))
    return total(after) - total(before)


def request_count_delta(port: int, before: dict, route: str,
                        want: float) -> float:
    """The request histogram's count for ``route`` since ``before``, once
    it reaches ``want`` (a handler observes after its response is written)
    or after 5 s."""
    deadline = time.perf_counter() + 5.0
    while True:
        got = metric_delta(scrape_metrics(port), before,
                           "dl4j_serve_request_seconds_count", route=route)
        if got >= want or time.perf_counter() > deadline:
            return got


def serve(kernels) -> dict:
    """The main path: generate and predict through the HTTP server."""
    V = 256
    conf = transformer_lm(V)
    net = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    ref_net = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)
    srv = InferenceServer(device="cuda", decode_kv="paged",
                          decode_page_size=16, decode_max_context=512,
                          decode_max_slots=16)
    srv.start()
    try:
        srv.register("lm", net, quant="int8")
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, V, size=int(rng.integers(16, 65))).tolist()
                   for _ in range(8)]

        def traffic():
            """The 8 generates at once, then the predict: (generate s,
            their answers, the predict's answer, its s)."""
            answers = [None] * len(prompts)

            def gen(j):
                answers[j] = post(srv.port, "/v1/generate",
                                  {"model": "lm", "prompt": prompts[j],
                                   "max_new_tokens": 32})

            t0 = time.perf_counter()
            threads = [threading.Thread(target=gen, args=(j,))
                       for j in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            gen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            answer = post(srv.port, "/v1/predict",
                          {"model": "lm", "inputs": ids.tolist()})
            return gen_s, answers, answer, time.perf_counter() - t0

        ids = rng.integers(0, V, size=(2, 512)).astype(np.float32)
        scraped = scrape_metrics(srv.port)
        for fn in kernels:
            fn.launches = 0
        gen_s, results, (status, body), predict_s = traffic()
        launches = {fn.__name__: fn.launches for fn in kernels}
        st = srv.status()
        metrics = serve_metrics_check(srv.port, scraped, st, len(prompts))
        metrics["on_off"] = metrics_on_off(traffic)
        t0 = time.perf_counter()
        traced = tracing_phase(srv, traffic, prompts, ids,
                               tuple(kernels) + (fixed_matmul,))
        traced["seconds"] = time.perf_counter() - t0
        print(f"phase tracing: {traced['seconds']:.1f}s", flush=True)
    finally:
        srv.stop()

    dec = st["decode"]["lm@v1"]
    print(f"serve: 8 x /v1/generate in {gen_s:.3f}s ({dec['steps']} decode "
          f"steps, {dec['tokens']} tokens, peak {dec['peak_active']} slots, "
          f"capacity {dec['capacity']}); /v1/predict [2,512] in "
          f"{predict_s:.3f}s; launches {launches}", flush=True)
    if status != 200:
        fail(f"/v1/predict returned {status}: {body[:500]}")
    pred = np.asarray(json.loads(body)["predictions"], np.float32)
    if pred.shape != (2, 512, V) or not np.isfinite(pred).all():
        fail(f"/v1/predict gave shape {pred.shape} or non-finite values")
    dense_err = float((PredictFn(net, device="cuda")(ids).cpu()
                       - PredictFn(ref_net, device="cpu")(ids)).abs().max())
    print(f"float32 forward [2,512], card vs CPU: max_abs_err={dense_err:.3e}",
          flush=True)
    ref_pf = PredictFn(ref_net, quant="int8", device="cpu")
    perr = float(np.abs(ref_pf(ids).numpy() - pred).max())
    print(f"/v1/predict vs CPU reference: max_abs_err={perr:.3e} (tol 1e-4)",
          flush=True)
    if not perr <= 1e-4:
        fail(f"/v1/predict disagrees with the CPU reference: {perr}")
    worst_gap = 0.0
    for prompt, (code, text) in zip(prompts, results):
        if code != 200:
            fail(f"/v1/generate returned {code}: {text[:500]}")
        lines = [json.loads(l) for l in text.splitlines() if l.strip()]
        done = lines[-1]
        toks = done.get("tokens")
        if not done.get("done") or len(toks) != 32 or len(lines) != 33:
            fail(f"/v1/generate gave {len(lines)} lines, last {done}")
        # the served greedy tokens must be argmax of the CPU full-sequence
        # forward over the same stream, to within float32 noise
        worst_gap = max(worst_gap, argmax_gap(ref_pf, prompt, toks))
    print(f"/v1/generate vs CPU full-sequence oracle: worst argmax gap "
          f"{worst_gap:.3e} (tol 1e-4)", flush=True)
    if not worst_gap <= 1e-4:
        fail(f"/v1/generate tokens are not the reference argmax: {worst_gap}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched by the served traffic")
    # exact: a decode step runs 4 int8 products in each of the 4 blocks plus
    # the head, and gathers K and V pages in each block; the predict runs
    # one attention forward a block
    want = {"int8_matmul": 17 * dec["steps"], "paged_gather": 8 * dec["steps"],
            "flash_fwd": 4}
    if launches != want:
        fail(f"serving launch counts {launches} != expected {want}")
    return {"launches": launches, "generate_s": gen_s, "predict_s": predict_s,
            "decode_steps": dec["steps"], "decode_tokens": dec["tokens"],
            "decode_capacity": dec["capacity"],
            "predict_max_abs_err": perr, "generate_worst_argmax_gap": worst_gap,
            "metrics": metrics, "tracing": traced}


def serve_metrics_check(port: int, before: dict, st: dict,
                        sessions: int) -> dict:
    """``GET /metrics`` after the serve phase's traffic (``sessions``
    generates of 32 tokens, one predict): the request, token, TTFT,
    eviction and batch series moved by what was sent and by what
    ``/serve/status`` counts."""
    after = scrape_metrics(port)
    dec = st["decode"]["lm@v1"]
    got = {
        "generate_requests": request_count_delta(port, before,
                                                 "/v1/generate", sessions),
        "predict_requests": request_count_delta(port, before,
                                                "/v1/predict", 1),
        "tokens": metric_delta(after, before, "dl4j_serve_tokens_total"),
        "ttft_count": metric_delta(after, before,
                                   "dl4j_serve_ttft_seconds_count"),
        "evictions": metric_delta(after, before, "dl4j_serve_evictions_total",
                                  reason="max_tokens"),
        "predicts_admitted": metric_delta(after, before,
                                          "dl4j_serve_requests_total",
                                          model="lm"),
        "batches": metric_delta(after, before, "dl4j_serve_batches_total",
                                model="lm")}
    want = {"generate_requests": sessions, "predict_requests": 1,
            "tokens": 32 * sessions, "ttft_count": sessions,
            "evictions": sessions, "predicts_admitted": 1,
            "batches": st["queue"]["dispatches"]}
    print(f"serve /metrics: {got} (stats: decode tokens {dec['tokens']}, "
          f"dispatches {st['queue']['dispatches']}); pages in use at the "
          f"last step {after.get(('dl4j_decode_page_in_use', ()))}",
          flush=True)
    if got != want or dec["tokens"] != 32 * sessions:
        fail(f"serve /metrics {got} != {want}")
    return got


def metrics_on_off(traffic, turns: int = 3) -> dict:
    """The serve phase's traffic with the metrics registry off and on in
    turns (``set_enabled``), ``turns`` calls a side: decode tokens/s over
    the 8 generates and the predict's wall ms. Printed, not gated: the
    host alone spreads these by milliseconds."""
    from deeplearning4j_tpu_torch.observability import global_registry
    reg = global_registry()
    out = {"on": {"tokens_per_s": [], "predict_ms": []},
           "off": {"tokens_per_s": [], "predict_ms": []}}
    try:
        for _ in range(turns):
            for side in ("off", "on"):
                reg.set_enabled(side == "on")
                gen_s, _, (code, body), predict_s = traffic()
                if code != 200:
                    fail(f"metrics on/off: /v1/predict answered {code}")
                out[side]["tokens_per_s"].append(8 * 32 / gen_s)
                out[side]["predict_ms"].append(1e3 * predict_s)
    finally:
        reg.set_enabled(True)
    print(f"metrics on/off in turns, {turns} calls a side: decode tokens/s "
          f"on {[round(v, 1) for v in out['on']['tokens_per_s']]} off "
          f"{[round(v, 1) for v in out['off']['tokens_per_s']]}; predict "
          f"[2,512] ms on {[round(v, 3) for v in out['on']['predict_ms']]} "
          f"off {[round(v, 3) for v in out['off']['predict_ms']]} [{CARD}]",
          flush=True)
    return out


def post_traced(port: int, path: str, body: dict, traceparent: str):
    """``post`` with a client ``traceparent``: (status, the echoed
    ``traceparent`` or None, body text)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json",
                      "traceparent": traceparent})
        resp = conn.getresponse()
        return resp.status, resp.getheader("traceparent"), resp.read().decode()
    finally:
        conn.close()


def get_json(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def fetch_trace(port: int, trace_id: str) -> dict:
    """``GET /serve/traces/<id>`` once the trace is finalized (a handler
    finishes its root span after writing the response), or fail after 10 s."""
    deadline = time.perf_counter() + 10.0
    while True:
        code, rec = get_json(port, f"/serve/traces/{trace_id}")
        if code == 200:
            return rec
        if time.perf_counter() > deadline:
            fail(f"tracing: trace {trace_id} never reached the store")
        time.sleep(0.01)


def tree_edges(rec: dict) -> set:
    """(span name, parent span name) of a trace; a parent outside the
    trace's spans (the client's span) is ``<remote>``."""
    by_id = {s["span_id"]: s["name"] for s in rec["spans"]}
    return {(s["name"], None if s["parent_id"] is None
             else by_id.get(s["parent_id"], "<remote>"))
            for s in rec["spans"]}


def client_traceparent(nonce: int, side: int, j: int) -> str:
    """The client's trace context of request ``j`` of run ``side``: a
    random 64-bit ``nonce`` a phase call (ids never repeat across calls in
    one process), then the run and the request, never all-zero."""
    return f"00-{nonce:016x}{side + 1:08x}{j + 1:08x}-{j + 1:016x}-01"


#: the span tree of one traced /v1/generate and one /v1/predict (names and
#: parents), as the CPU tests hold them against the JAX server
GENERATE_TREE = {("http /v1/generate", "<remote>"),
                 ("decode.queue", "http /v1/generate"),
                 ("decode.prefill", "decode.queue"),
                 ("decode.decode", "decode.queue")}
PREDICT_TREE = {("http /v1/predict", "<remote>"),
                ("admission", "http /v1/predict"),
                ("batch.queue", "http /v1/predict")}


def span_cost_us(tr, n: int = 2000) -> dict:
    """Host µs of one root span, one child span (enter and exit, with the
    tail sampler's finalize of the root) and one exemplar write, each the
    mean of ``n``, on a private store (the JAX suite's budget terms)."""
    from deeplearning4j_tpu_torch.observability import MetricsRegistry
    store = tr.TraceStore(enabled=True, sample=1.0, capacity=256,
                          registry=MetricsRegistry())
    prev = tr.global_trace_store()
    tr.set_global_trace_store(store)
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            with tr.trace_span("probe.root"):
                pass
        root = (time.perf_counter() - t0) / n
        with tr.trace_span("probe.parent") as parent:
            t0 = time.perf_counter()
            for _ in range(n):
                with tr.trace_span("probe.child", parent=parent):
                    pass
            child = (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        for _ in range(n):
            store.put_exemplar("probe", 0.001, "f" * 32)
        exemplar = (time.perf_counter() - t0) / n
    finally:
        tr.set_global_trace_store(prev)
    return {"root": round(1e6 * root, 2), "child": round(1e6 * child, 2),
            "exemplar": round(1e6 * exemplar, 2)}


def tracing_phase(srv, traffic, prompts, ids, counted) -> dict:
    """A9.2 on the serve phase's server: the 8 generates (one at a time, so
    the decode steps, and with them the launches, do not depend on when
    each request arrives) and the predict with a client ``traceparent``,
    untraced then traced. The traced run's launches of ``counted`` and its
    outputs must equal the untraced run's bitwise, every echo must keep the
    client's trace id, every trace tree must be whole, and the
    ``dl4j_trace_spans_total`` delta must equal the spans the trees hold.
    Then one 429 kept at ``sample=0``, ``GET /serve/slo``, the host cost of
    a span, and the concurrent traffic with tracing off and on in turns (3
    calls a side, the first side alternating; printed, not gated)."""
    import random
    from deeplearning4j_tpu_torch.observability import tracing as tr
    port = srv.port
    n = len(prompts)
    nonce = random.SystemRandom().getrandbits(64) | 1

    def run(side: int):
        answers = []
        _zero(counted)
        for j, prompt in enumerate(prompts):
            answers.append(post_traced(
                port, "/v1/generate", {"model": "lm", "prompt": prompt,
                                       "max_new_tokens": 32},
                client_traceparent(nonce, side, j)))
        answers.append(post_traced(
            port, "/v1/predict", {"model": "lm", "inputs": ids.tolist()},
            client_traceparent(nonce, side, n)))
        return answers, _launches(counted)

    def outputs(answers):
        out = []
        for code, _, text in answers:
            if code != 200:
                fail(f"tracing: a request answered {code}: {text[:300]}")
            lines = [json.loads(l) for l in text.splitlines() if l.strip()]
            # the generate's last line carries its TTFT, a time
            out.append(lines[-1]["tokens"] if "done" in lines[-1] else text)
        return out

    out = {}
    try:
        tr.configure(enabled=False)
        plain, plain_launches = run(0)
        if any(tp for _, tp, _ in plain):
            fail("tracing: an untraced response echoed a traceparent")
        tr.configure(enabled=True, sample=1.0)
        before = scrape_metrics(port)
        traced, traced_launches = run(1)
        print(f"tracing: launches untraced {plain_launches}, traced "
              f"{traced_launches}", flush=True)
        if traced_launches != plain_launches or not all(
                plain_launches.values()):
            fail("tracing: tracing moved the launch counts")
        if outputs(traced) != outputs(plain):
            fail("tracing: traced outputs differ from the untraced ones")
        trees, n_spans = [], 0
        queue_span = None
        for j, (_, echo, _) in enumerate(traced):
            sent = tr.parse_traceparent(client_traceparent(nonce, 1, j))
            got = tr.parse_traceparent(echo)
            if got is None or got.trace_id != sent.trace_id:
                fail(f"tracing: echo {echo!r} lost the trace id of "
                     f"{sent.traceparent()}")
            rec = fetch_trace(port, got.trace_id)
            edges = tree_edges(rec)
            want = GENERATE_TREE if j < n else PREDICT_TREE
            root = next(s for s in rec["spans"]
                        if s["parent_id"] == sent.span_id)
            if edges != want or root["span_id"] != got.span_id or any(
                    s["status"] != "ok" for s in rec["spans"]):
                fail(f"tracing: request {j}'s tree {sorted(edges)}")
            if j < n:
                dec = next(s for s in rec["spans"]
                           if s["name"] == "decode.decode")["attrs"]
                if dec.get("tokens") != 32 or dec.get("reason") !=                         "max_tokens":
                    fail(f"tracing: decode span attrs {dec}")
            else:
                queue_span = next(s for s in rec["spans"]
                                  if s["name"] == "batch.queue")["span_id"]
            n_spans += rec["n_spans"]
            trees.append(rec["n_spans"])
        # the predict's batch dispatch: a root of its own linking the
        # request's queue span
        dispatch = None
        for summary in get_json(port, "/serve/traces")[1]["traces"]:
            if summary["root"] != "batch.dispatch":
                continue
            rec = fetch_trace(port, summary["trace_id"])
            links = rec["spans"][0]["links"]
            if any(l.split("-")[2] == queue_span for l in links):
                dispatch = rec
        if dispatch is None:
            fail("tracing: no batch.dispatch span links the predict")
        attrs = dispatch["spans"][0]["attrs"]
        if (attrs["rows"], attrs["bucket"], attrs["requests"],
                attrs["version"], attrs["compile_cache_hit"]) != \
                (2, 2, 1, "v1", None):
            fail(f"tracing: dispatch attrs {attrs}")
        n_spans += dispatch["n_spans"]
        after = scrape_metrics(port)
        counted_spans = metric_delta(after, before, "dl4j_trace_spans_total")
        kept = metric_delta(after, before, "dl4j_trace_traces_kept_total")
        print(f"tracing: {n + 1} request trees whole ({trees} spans) and "
              f"the dispatch's ({dispatch['n_spans']}); spans counted "
              f"{counted_spans:g}, returned {n_spans}; traces kept "
              f"{kept:g}", flush=True)
        if counted_spans != n_spans or kept != n + 2:
            fail("tracing: dl4j_trace_spans_total moved by "
                 f"{counted_spans}, the trees hold {n_spans}")
        out.update(launches=traced_launches, spans=n_spans,
                   trees=trees, dispatch_spans=dispatch["n_spans"])

        # one 429 at sample 0: the tail sampler keeps it
        tr.configure(sample=0.0)
        adm = srv.batcher.admission
        adm.admit(adm.max_pending)
        try:
            code, echo, _ = post_traced(
                port, "/v1/predict", {"model": "lm", "inputs": [[0.0]]},
                client_traceparent(nonce, 2, 0))
        finally:
            adm.release(adm.max_pending)
        rec = fetch_trace(port, tr.parse_traceparent(echo).trace_id)
        root = next(s for s in rec["spans"] if s["name"].startswith("http"))
        if code != 429 or rec["keep_reason"] != "error" or \
                root["attrs"].get("http_status") != 429 or \
                tree_edges(rec) != {("http /v1/predict", "<remote>"),
                                    ("admission", "http /v1/predict")}:
            fail(f"tracing: the 429 ({code}) was not kept as an error: "
                 f"{rec['keep_reason']}, {sorted(tree_edges(rec))}")
        tr.configure(sample=1.0)
        print(f"tracing: a 429 at sample 0 kept ({rec['keep_reason']}, "
              f"{rec['n_spans']} spans)", flush=True)

        code, body = get_json(port, "/serve/slo")
        objectives = body.get("slo", [])
        if code != 200 or [o["name"] for o in objectives] != [
                "request_p99", "ttft_p99", "availability"] or any(
                len(o["windows"]) != 2 for o in objectives):
            fail(f"tracing: /serve/slo answered {code}: {body}")
        out["slo"] = [{"name": o["name"], "alerting": o["alerting"],
                       "burn": [w["burn_rate"] for w in o["windows"]],
                       "total": [w["total"] for w in o["windows"]]}
                      for o in objectives]
        print(f"tracing: /serve/slo {out['slo']}", flush=True)

        out["span_us"] = span_cost_us(tr)
        print(f"tracing: host µs a span (root, child) and an exemplar "
              f"{out['span_us']}", flush=True)

        # off and on in turns, the serve phase's concurrent traffic; the
        # side that goes first alternates
        on_off = {"on": {"tokens_per_s": [], "predict_ms": []},
                  "off": {"tokens_per_s": [], "predict_ms": []}}
        for turn in range(3):
            for side in (("off", "on") if turn % 2 == 0 else ("on", "off")):
                tr.configure(enabled=side == "on")
                gen_s, _, (code, _), predict_s = traffic()
                if code != 200:
                    fail(f"tracing on/off: /v1/predict answered {code}")
                on_off[side]["tokens_per_s"].append(n * 32 / gen_s)
                on_off[side]["predict_ms"].append(1e3 * predict_s)
        out["on_off"] = on_off
        print(f"tracing on/off in turns, 3 calls a side: decode tokens/s on "
              f"{[round(v, 1) for v in on_off['on']['tokens_per_s']]} off "
              f"{[round(v, 1) for v in on_off['off']['tokens_per_s']]}; "
              f"predict [2,512] ms on "
              f"{[round(v, 3) for v in on_off['on']['predict_ms']]} off "
              f"{[round(v, 3) for v in on_off['off']['predict_ms']]} "
              f"[{CARD}]", flush=True)
    finally:
        tr.configure(enabled=True, sample=1.0)
    return out


def train(kernels) -> dict:
    """The training path: ``MultiLayerNetwork.fit`` on the card against the
    same steps on the CPU, the launch counts of the 5 counted steps, then
    step timing and one profiled step."""
    conf = transformer_lm(TRAIN_V)
    ids = np.random.default_rng(SEED).integers(
        0, TRAIN_V, size=(TRAIN_B, TRAIN_T))
    x = np.eye(TRAIN_V, dtype=np.float32)[ids]
    net = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    ref = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)

    for fn in kernels:
        fn.launches = 0
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        net.fit(x, x)
        losses.append(net.score_value)
    first_steps_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}

    ref_losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        ref.fit(x, x)
        ref_losses.append(ref.score_value)
    cpu_s = time.perf_counter() - t0
    # float32 on both; sums in another order, amplified by Adam where a
    # gradient entry is near zero
    tol = 1e-4
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"train: card losses {losses}; CPU losses {ref_losses}; worst "
          f"relative difference {max(rel):.3e} (tol {tol:.0e}); "
          f"{TRAIN_STEPS} steps on the card in {first_steps_s:.3f}s (first "
          f"step included), on the CPU in {cpu_s:.3f}s; launches {launches}",
          flush=True)
    if not all(np.isfinite(losses)) or not max(rel) <= tol:
        fail(f"training losses on the card {losses} disagree with the CPU "
             f"run {ref_losses}")
    if not losses[-1] < losses[0]:
        fail(f"the training loss did not fall: {losses}")
    want = {"softmax_cross_entropy": TRAIN_STEPS,
            "flash_bwd_dq": 4 * TRAIN_STEPS, "flash_bwd_dkv": 4 * TRAIN_STEPS,
            "flash_fwd": 4 * TRAIN_STEPS, "int8_matmul": 0, "paged_gather": 0}
    if launches != want:
        fail(f"training launch counts {launches} != expected {want}")

    # step time: host clock around steps that end in a synchronize
    for _ in range(2):
        net.fit(x, x)
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        net.fit(x, x)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / n
    tokens_per_s = TRAIN_B * TRAIN_T / (step_ms / 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, x)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = device_time_by_kernel(prof)
    busy_us = sum(by_kernel.values())
    if busy_us <= 0:
        fail("the profiler saw no device time in the training step")
    result = {
        "losses": losses, "cpu_losses": ref_losses, "worst_rel_diff": max(rel),
        "launches": launches, "step_ms": step_ms, "tokens_per_s": tokens_per_s,
        "profiled_step_ms": prof_ms, "device_us_by_kernel": by_kernel,
        "device_us_total": busy_us,
        "idle_share_unprofiled": 1.0 - busy_us / 1e3 / step_ms,
        "idle_share_profiled": 1.0 - busy_us / 1e3 / prof_ms,
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    print(f"train step: {step_ms:.3f} ms wall, {tokens_per_s:.0f} tokens/s "
          f"(B={TRAIN_B}, T={TRAIN_T}); profiled step {prof_ms:.3f} ms, "
          f"device time {busy_us:.1f} us, idle share "
          f"{result['idle_share_unprofiled']:.3f} of the unprofiled step "
          f"({result['idle_share_profiled']:.3f} profiled)", flush=True)
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        print(f"  train step device time {name}: {us:.1f} us", flush=True)
    return result


def train_wide(kernels, n_heads: int = 4) -> dict:
    """Full-width ``transformer_lm(256, width=512, n_heads=n_heads)``: 4
    heads of 128 (the flash kernels' widest instantiation) or 2 heads of 256
    (``csrc/flash_wide.cu``): one ``output`` and ``WIDE_STEPS`` ``fit`` steps
    on the card against the same calls on the CPU from the same weights,
    with the exact launches of each."""
    conf = transformer_lm(TRAIN_V, width=WIDE_WIDTH, n_heads=n_heads)
    ids = np.random.default_rng(SEED + 4).integers(
        0, TRAIN_V, size=(WIDE_B, WIDE_T))
    x = np.eye(TRAIN_V, dtype=np.float32)[ids]
    net = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    ref = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)

    for fn in kernels:
        fn.launches = 0
    out = net.output(x)
    torch.cuda.synchronize()
    out_launches = {fn.__name__: fn.launches for fn in kernels}
    for fn in kernels:
        fn.launches = 0
    losses = []
    for _ in range(WIDE_STEPS):
        net.fit(x, x)
        losses.append(net.score_value)
    fit_launches = {fn.__name__: fn.launches for fn in kernels}

    ref_out = ref.output(x)
    ref_losses = []
    for _ in range(WIDE_STEPS):
        ref.fit(x, x)
        ref_losses.append(ref.score_value)
    # as the serving and training phases: the output within 1e-4 of the CPU
    # forward, each loss within 1e-4 relative of the CPU step
    out_err = float((out.cpu() - ref_out).abs().max())
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"wide transformer_lm(width={WIDE_WIDTH}, {n_heads} heads of "
          f"{WIDE_WIDTH // n_heads}) B={WIDE_B} "
          f"T={WIDE_T}: output max_abs_err {out_err:.3e} (tol 1e-4); card "
          f"losses {losses}, CPU {ref_losses}, worst relative difference "
          f"{max(rel):.3e} (tol 1e-4); launches output {out_launches}, fit "
          f"{fit_launches}", flush=True)
    if tuple(out.shape) != (WIDE_B, WIDE_T, TRAIN_V) \
            or not bool(torch.isfinite(out).all()) or not out_err <= 1e-4:
        fail(f"wide output {tuple(out.shape)} disagrees with the CPU: {out_err}")
    if not all(np.isfinite(losses)) or not max(rel) <= 1e-4:
        fail(f"wide losses on the card {losses} disagree with the CPU run "
             f"{ref_losses}")
    want_out = {fn.__name__: 0 for fn in kernels}
    want_fit = dict(want_out)
    want_out["flash_fwd"] = 4  # one attention forward a block
    want_fit.update(flash_fwd=4 * WIDE_STEPS, flash_bwd_dq=4 * WIDE_STEPS,
                    flash_bwd_dkv=4 * WIDE_STEPS,
                    softmax_cross_entropy=WIDE_STEPS)
    if out_launches != want_out or fit_launches != want_fit:
        fail(f"wide launch counts output {out_launches} != {want_out} or fit "
             f"{fit_launches} != {want_fit}")
    return {"output_launches": out_launches, "launches": fit_launches,
            "output_max_abs_err": out_err, "losses": losses,
            "cpu_losses": ref_losses, "worst_rel_diff": max(rel)}


class _LossLog:
    """A listener that keeps the loss of every update (one per TBPTT
    chunk); reading it synchronizes, so timed runs go without it."""

    def __init__(self, out: list):
        self.out = out

    def iteration_done(self, model, iteration):
        self.out.append(float(model.score_value))


def _one_hot(ids) -> np.ndarray:
    return np.eye(RNN_V, dtype=np.float32)[np.asarray(ids)]


def serve_lstm(kernels) -> dict:
    """The recurrent serving paths through the HTTP server: 8 concurrent
    /v1/generate sessions over the LSTM decode engine (dense, float32), then
    one /v1/stream session of 64 steps in two requests and its reset; every
    answer against the CPU ``rnn_time_step`` reference, and the launches of
    each path."""
    conf = char_rnn_lstm(RNN_V, hidden=RNN_H, layers=2, tbptt_length=RNN_CHUNK)
    net = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    ref = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)
    srv = InferenceServer(device="cuda", decode_max_slots=RNN_DECODE_B)
    srv.start()
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(0, RNN_V, size=int(rng.integers(8, 33))).tolist()
               for _ in range(8)]
    stream_ids = rng.integers(0, RNN_V, size=(1, 64))
    try:
        srv.register("char", net)
        results = [None] * len(prompts)

        def gen(j):
            results[j] = post(srv.port, "/v1/generate",
                              {"model": "char", "prompt": prompts[j],
                               "max_new_tokens": 32})

        def generate_all():
            threads = [threading.Thread(target=gen, args=(j,))
                       for j in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        for fn in kernels:
            fn.launches = 0
        t0 = time.perf_counter()
        generate_all()
        gen_s = time.perf_counter() - t0
        decode_launches = {fn.__name__: fn.launches for fn in kernels}
        dec = srv.status()["decode"]["char@v1"]

        for fn in kernels:
            fn.launches = 0
        outs = []
        t0 = time.perf_counter()
        for part in (stream_ids[:, :32], stream_ids[:, 32:]):
            code, text = post(srv.port, "/v1/stream",
                              {"model": "char", "session": "s1",
                               "inputs": _one_hot(part).tolist()})
            if code != 200:
                fail(f"/v1/stream returned {code}: {text[:500]}")
            lines = [json.loads(l) for l in text.splitlines() if l.strip()]
            if not lines[-1].get("done") or len(lines) != 33:
                fail(f"/v1/stream gave {len(lines)} lines, last {lines[-1]}")
            outs += [np.asarray(l["output"], np.float32)[0]
                     for l in lines[:-1]]
        stream_s = time.perf_counter() - t0
        stream_launches = {fn.__name__: fn.launches for fn in kernels}
        streams_before = srv.status()["streams"]
        code, text = post(srv.port, "/v1/stream/reset",
                          {"model": "char", "session": "s1"})
        streams_after = srv.status()["streams"]

        # the same generate traffic again, profiled: device time by kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generate_all()
            prof_s = time.perf_counter() - t0
        dec2 = srv.status()["decode"]["char@v1"]
    finally:
        srv.stop()

    if code != 200 or json.loads(text) != {"reset": True} \
            or streams_before != {"char@v1": ["s1"]} \
            or streams_after != {"char@v1": []}:
        fail(f"/v1/stream/reset: {code} {text}; streams {streams_before} -> "
             f"{streams_after}")
    worst_gap, exact = 0.0, 0
    for prompt, (code, text) in zip(prompts, results):
        if code != 200:
            fail(f"/v1/generate (LSTM) returned {code}: {text[:500]}")
        lines = [json.loads(l) for l in text.splitlines() if l.strip()]
        toks = lines[-1].get("tokens")
        if not lines[-1].get("done") or len(toks) != 32 or len(lines) != 33:
            fail(f"/v1/generate (LSTM) gave {len(lines)} lines, last {lines[-1]}")
        # greedy tokens against the CPU rnn_time_step over the same stream
        ref.rnn_clear_previous_state()
        probs = ref.rnn_time_step(_one_hot([prompt + toks])).numpy()[0]
        for t, tok in enumerate(toks):
            p = probs[len(prompt) - 1 + t]
            worst_gap = max(worst_gap, float(p.max() - p[tok]))
            exact += int(p.argmax() == tok)
    ref.rnn_clear_previous_state()
    want_out = ref.rnn_time_step(_one_hot(stream_ids)).numpy()[0]
    stream_err = float(np.abs(np.stack(outs) - want_out).max())
    steps = dec["steps"]
    print(f"serve char_rnn: 8 x /v1/generate in {gen_s:.3f}s ({steps} decode "
          f"steps, {dec['tokens']} tokens, capacity {dec['capacity']}); "
          f"{exact}/{8 * 32} tokens equal to the CPU rnn_time_step argmax, "
          f"worst argmax probability gap {worst_gap:.3e} (tol 1e-4); "
          f"/v1/stream 64 steps in {stream_s:.3f}s, max_abs_err "
          f"{stream_err:.3e} (tol 1e-5); launches decode {decode_launches}, "
          f"stream {stream_launches}", flush=True)
    if not worst_gap <= 1e-4:
        fail(f"LSTM /v1/generate tokens are not the reference argmax: "
             f"{worst_gap}")
    if not stream_err <= 1e-5:
        fail(f"/v1/stream disagrees with the CPU rnn_time_step: {stream_err}")
    want_d = {fn.__name__: 0 for fn in kernels}
    want_s = dict(want_d, lstm_fwd=2 * 64)
    want_d["lstm_fwd"] = 2 * steps
    if decode_launches != want_d or stream_launches != want_s:
        fail(f"LSTM serving launch counts decode {decode_launches} != "
             f"{want_d} or stream {stream_launches} != {want_s}")
    by_kernel = device_time_by_kernel(prof)
    busy_us = sum(by_kernel.values())
    steps2 = dec2["steps"] - steps
    result = {
        "decode_launches": decode_launches, "stream_launches": stream_launches,
        "generate_s": gen_s, "decode_steps": steps,
        "decode_tokens": dec["tokens"], "decode_capacity": dec["capacity"],
        "decode_ms_per_step": 1e3 * gen_s / steps,
        "decode_tokens_per_s": dec["tokens"] / gen_s,
        "generate_exact_argmax": exact, "generate_worst_argmax_gap": worst_gap,
        "stream_s": stream_s, "stream_ms_per_step": 1e3 * stream_s / 64,
        "stream_max_abs_err": stream_err,
        "profiled_generate_s": prof_s, "profiled_decode_steps": steps2,
        "device_us_by_kernel": by_kernel, "device_us_total": busy_us,
        "device_us_per_step": busy_us / max(steps2, 1),
        "idle_share_profiled": 1.0 - busy_us / 1e6 / prof_s}
    print(f"decode char_rnn profiled: {steps2} steps in {prof_s:.3f}s, device "
          f"{busy_us:.1f} us ({result['device_us_per_step']:.1f} us a step), "
          f"idle share {result['idle_share_profiled']:.3f}; by kernel "
          f"{ {k: round(v, 1) for k, v in by_kernel.items()} }", flush=True)
    return result


def train_lstm(kernels) -> dict:
    """The recurrent training path: TBPTT ``fit`` of full-width char_rnn on
    the card against the same chunks on the CPU, the launch counts of the 8
    counted chunks, then chunk timing and one profiled batch."""
    conf = char_rnn_lstm(RNN_V, hidden=RNN_H, layers=2, tbptt_length=RNN_CHUNK,
                         learning_rate=RNN_LR)
    rng = np.random.default_rng(SEED)
    batches = [_one_hot(rng.integers(0, RNN_V, size=(RNN_B, RNN_T)))
               for _ in range(RNN_BATCHES)]
    net = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    ref = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)
    losses, ref_losses = [], []
    net.set_listeners(_LossLog(losses))
    ref.set_listeners(_LossLog(ref_losses))
    n_chunks = RNN_BATCHES * (RNN_T // RNN_CHUNK)

    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    for x in batches:
        net.fit(x, x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    t0 = time.perf_counter()
    for x in batches:
        ref.fit(x, x)
    cpu_s = time.perf_counter() - t0
    # float32 on both; sums in another order, through 8 RMSProp updates
    tol = 1e-4
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"train char_rnn: card chunk losses {losses}; CPU {ref_losses}; "
          f"worst relative difference {max(rel):.3e} (tol {tol:.0e}); "
          f"{n_chunks} chunks on the card in {first_s:.3f}s (first included), "
          f"on the CPU in {cpu_s:.3f}s; launches {launches}", flush=True)
    if len(losses) != n_chunks or not all(np.isfinite(losses)) \
            or not max(rel) <= tol:
        fail(f"char_rnn chunk losses on the card {losses} disagree with the "
             f"CPU run {ref_losses}")
    want = {fn.__name__: 0 for fn in kernels}
    want.update(lstm_fwd=2 * n_chunks, lstm_bwd=2 * n_chunks,
                softmax_cross_entropy=n_chunks)
    if launches != want:
        fail(f"char_rnn launch counts {launches} != expected {want}")

    net.set_listeners()
    x = batches[0]
    net.fit(x, x)
    torch.cuda.synchronize()
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        net.fit(x, x)
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t0) / (n * RNN_T // RNN_CHUNK)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, x)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = device_time_by_kernel(prof)
    busy_us = sum(by_kernel.values())
    if busy_us <= 0:
        fail("the profiler saw no device time in the char_rnn batch")
    per_batch = RNN_T // RNN_CHUNK
    # the device time a chunk, by kernel and for lstm_fwd's and lstm_bwd's
    # parts (both layers), read as device_ms does it (time a recorded event
    # x events a batch, median of three sessions): a single profiled session
    # may drop part of the events
    split = device_ms_by_kernel(lambda: net.fit(x, x), iters=2)
    if split is None:
        fail("the profiler saw no device time in eight char_rnn sessions")
    fwd_parts_us, bwd_parts_us = (
        {k: 1e3 * v / per_batch for k, v in kernel_parts(split, parts).items()}
        for parts in (LSTM_FWD_PARTS, LSTM_BWD_PARTS))
    device_us_per_chunk = 1e3 * sum(split.values()) / per_batch
    result = {
        "losses": losses, "cpu_losses": ref_losses, "worst_rel_diff": max(rel),
        "launches": launches, "chunk_ms": chunk_ms,
        "tokens_per_s": RNN_B * RNN_CHUNK / (chunk_ms / 1e3),
        "profiled_batch_ms": prof_ms, "profiled_chunks": per_batch,
        "device_us_by_kernel": by_kernel, "device_us_total": busy_us,
        "idle_share_unprofiled": 1.0 - busy_us / 1e3 / (chunk_ms * per_batch),
        "idle_share_profiled": 1.0 - busy_us / 1e3 / prof_ms,
        "device_us_per_chunk": device_us_per_chunk,
        "idle_share_from_median_device":
            1.0 - device_us_per_chunk / 1e3 / chunk_ms,
        "lstm_fwd_us_per_chunk_by_part": fwd_parts_us,
        "lstm_bwd_us_per_chunk_by_part": bwd_parts_us}
    print(f"train char_rnn chunk: {chunk_ms:.3f} ms wall, "
          f"{result['tokens_per_s']:.0f} tokens/s (B={RNN_B}, T={RNN_CHUNK}); "
          f"profiled batch of {per_batch} chunks {prof_ms:.3f} ms, device time "
          f"{busy_us:.1f} us, idle share "
          f"{result['idle_share_unprofiled']:.3f} unprofiled "
          f"({result['idle_share_profiled']:.3f} profiled); device a chunk "
          f"{device_us_per_chunk:.1f} us (median of three sessions), idle "
          f"share {result['idle_share_from_median_device']:.3f} from it",
          flush=True)
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1]):
        print(f"  char_rnn batch device time {name}: {us:.1f} us", flush=True)
    for name, parts in (("lstm_fwd", fwd_parts_us), ("lstm_bwd", bwd_parts_us)):
        print(f"  {name} device time per chunk (2 layers) by part: "
              + ", ".join(f"{k} {v:.1f} us" for k, v in parts.items()),
              flush=True)
    return result


def _lenet_family(name: str) -> str:
    """A LeNet step's device kernel by family: the port's ``sm_xent``,
    copies, cuDNN's convolutions (its FFT algorithms too: the transforms,
    the filter flip and the complex GEMMs), the dense layers' GEMMs,
    pooling, and the other (elementwise, reduction, updater) PyTorch
    kernels."""
    low = name.lower()
    if "sm_xent" in low:
        return "sm_xent"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if any(k in low for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                              "implicit", "fft", "flip_filter", "cf32")):
        return "cuDNN convolution"
    if "gemm" in low or "gemv" in low:
        return "GEMM (dense layers)"
    if "pool" in low:
        return "pooling"
    return "other PyTorch kernels"


def lenet(kernels) -> dict:
    """The LeNet path: ``fit`` of full-width ``lenet_mnist()`` on the card
    against the CPU from the same weights, a ``fit_iterator`` epoch and
    ``evaluate`` on both, ``/v1/predict`` through the HTTP server, then step
    timing and one profiled step."""
    net = MultiLayerNetwork(lenet_mnist(), device="cuda").init(seed=SEED)
    ref = net.clone(device="cpu")

    def train_digits():
        return MnistDataSetIterator(
            LENET_B, num_examples=LENET_B * LENET_EPOCH_BATCHES)

    batches = list(train_digits())[:LENET_STEPS]
    # batches of 200: the iterator drops a partial last batch
    test = MnistDataSetIterator(200, train=False, shuffle=False,
                                num_examples=LENET_TEST)
    synthetic = train_digits().synthetic and test.synthetic

    for fn in kernels:
        fn.launches = 0
    losses = []
    t0 = time.perf_counter()
    for ds in batches:
        net.fit(ds)
        losses.append(net.score_value)
    first_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    ref_losses = []
    for ds in batches:
        ref.fit(ds)
        ref_losses.append(ref.score_value)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    x0 = test.features[:LENET_B]
    out_err = float((net.output(x0).cpu() - ref.output(x0)).abs().max())
    print(f"lenet: card losses {losses}; CPU {ref_losses}; worst relative "
          f"difference {max(rel):.3e} (tol 1e-4); output max_abs_err "
          f"{out_err:.3e} (tol 1e-4); {LENET_STEPS} steps on the card in "
          f"{first_s:.3f}s (first included); launches {launches}; synthetic "
          f"digits {synthetic}", flush=True)
    if not all(np.isfinite(losses)) or not max(rel) <= 1e-4:
        fail(f"LeNet losses on the card {losses} disagree with the CPU run "
             f"{ref_losses}")
    if not out_err <= 1e-4:
        fail(f"LeNet output on the card disagrees with the CPU: {out_err}")
    want = {fn.__name__: 0 for fn in kernels}
    want["softmax_cross_entropy"] = LENET_STEPS
    if launches != want:
        fail(f"LeNet launch counts {launches} != expected {want}")

    # a fit_iterator epoch and evaluate, on both devices
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    net.fit_iterator(train_digits())
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch_launches = {fn.__name__: fn.launches for fn in kernels}
    ref.fit_iterator(train_digits())
    ev, ref_ev = net.evaluate(test), ref.evaluate(test)
    acc, ref_acc = ev.accuracy(), ref_ev.accuracy()
    print(f"lenet fit_iterator: {LENET_EPOCH_BATCHES} batches in "
          f"{epoch_s:.3f}s on the card (launches {epoch_launches}); last "
          f"losses card {net.score_value:.6f} CPU {ref.score_value:.6f}; "
          f"evaluate on {ev.num_examples} test digits: accuracy card {acc:.4f}"
          f", CPU {ref_acc:.4f} (tol 0.01)", flush=True)
    if ev.num_examples != LENET_TEST or not abs(acc - ref_acc) <= 0.01:
        fail(f"LeNet accuracy on the card {acc} differs from the CPU's "
             f"{ref_acc}")
    if epoch_launches["softmax_cross_entropy"] != LENET_EPOCH_BATCHES:
        fail(f"fit_iterator launched sm_xent {epoch_launches} times, not "
             f"once a batch")

    # /v1/predict through the HTTP server
    rows = test.features[:LENET_SERVE_ROWS]
    srv = InferenceServer(device="cuda", max_batch=LENET_SERVE_ROWS)
    srv.start()
    try:
        srv.register("lenet", net)
        t0 = time.perf_counter()
        status, body = post(srv.port, "/v1/predict",
                            {"model": "lenet", "inputs": rows.tolist()})
        predict_s = time.perf_counter() - t0
    finally:
        srv.stop()
    if status != 200:
        fail(f"LeNet /v1/predict returned {status}: {body[:500]}")
    pred = np.asarray(json.loads(body)["predictions"], np.float32)
    # serving is held to the CPU forward of the weights it serves; the two
    # trained copies have drifted apart over 25 steps (sums in another
    # order, cuDNN's algorithm choice), which the accuracy check bounds
    perr = float(np.abs(
        pred - net.clone(device="cpu").output(rows).numpy()).max())
    drift = float(np.abs(pred - ref.output(rows).numpy()).max())
    print(f"lenet /v1/predict [{LENET_SERVE_ROWS}, 784] in {predict_s:.3f}s: "
          f"max_abs_err {perr:.3e} against the CPU output of the served "
          f"weights (tol 1e-4); {drift:.3e} against the CPU-trained copy",
          flush=True)
    if pred.shape != (LENET_SERVE_ROWS, 10) or not perr <= 1e-4:
        fail(f"LeNet /v1/predict {pred.shape} disagrees with the CPU: {perr}")

    # step time: host clock around steps that end in a synchronize
    x, y = batches[0].features, batches[0].labels
    for _ in range(2):
        net.fit(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LENET_TIMED):
        net.fit(x, y)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / LENET_TIMED
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for key, _, us in device_events(prof):
        if us:
            by_name[key] = by_name.get(key, 0.0) + us
    by_family = {}
    for name, us in by_name.items():
        fam = _lenet_family(name)
        by_family[fam] = by_family.get(fam, 0.0) + us
    busy_us = sum(by_name.values())
    if busy_us <= 0:
        fail("the profiler saw no device time in the LeNet step")
    result = {
        "card": CARD, "synthetic_digits": synthetic, "losses": losses,
        "cpu_losses": ref_losses, "worst_rel_diff": max(rel),
        "output_max_abs_err": out_err, "launches": launches,
        "epoch_launches": epoch_launches, "epoch_s": epoch_s,
        "accuracy": acc, "cpu_accuracy": ref_acc,
        "predict_max_abs_err": perr, "predict_s": predict_s,
        "trained_copies_output_max_abs_diff": drift,
        "step_ms": step_ms, "samples_per_s": LENET_B / (step_ms / 1e3),
        "profiled_step_ms": prof_ms, "device_us_total": busy_us,
        "device_us_by_family": by_family, "device_us_by_kernel": by_name,
        "idle_share_unprofiled": 1.0 - busy_us / 1e3 / step_ms,
        "idle_share_profiled": 1.0 - busy_us / 1e3 / prof_ms}
    print(f"lenet step: {step_ms:.3f} ms wall, "
          f"{result['samples_per_s']:.0f} samples/s (B={LENET_B}, "
          f"{LENET_TIMED} timed steps after 2 warm-up); profiled step "
          f"{prof_ms:.3f} ms, device time {busy_us:.1f} us, idle share "
          f"{result['idle_share_unprofiled']:.3f} of the unprofiled step "
          f"({result['idle_share_profiled']:.3f} profiled) [{CARD}]",
          flush=True)
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  lenet step device time {fam}: {us:.1f} us", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {us:8.1f} us  {name[:110]}", flush=True)
    return result


#: the ResNet-50 phase: card against CPU at 64x64 (full depth and width,
#: 1000 classes) for 3 steps at B = 8; then the JAX bench's shape
#: (224x224x3, B = 128, bench.py:1795-1801): 2 warm-up, 10 timed and 1
#: profiled step, evaluate on 256 images and a /v1/predict of 2 rows
RES_CHECK_SIZE, RES_CHECK_B, RES_CHECK_STEPS = 64, 8, 3
RES_SIZE, RES_B, RES_CLASSES = 224, 128, 1000
RES_WARMUP, RES_TIMED, RES_EVAL, RES_SERVE_ROWS = 2, 10, 256, 2
#: the gate on each card step of part (a), leaf by leaf. With e = ||p -
#: p64|| / ||p64 - p0|| (p0 the CPU run's params before the step, p64 the
#: params after a float64 step from the same point, p a float32 run's), the
#: card's e may be at most RES_UPD_RATIO times the CPU float32 run's e, or
#: RES_UPD_FLOOR, whichever is larger: the card's gradient and Nesterov
#: update as close to float64 as the CPU's float32 ones are. The CPU's e is
#: taken as at least its median over the step's leaves: a leaf's float32
#: error moves with the few ReLU inputs that round to the other side of 0,
#: and one CPU leaf has read 150 times below the step's median. The
#: control, a card step at RES_CONTROL_LR times the config's learning
#: rate, must fail the gate.
RES_UPD_RATIO, RES_UPD_FLOOR, RES_CONTROL_LR = 4.0, 1e-4, 1.01


def _step_flops(layer_type: str, f: dict, out, first: bool) -> float:
    """The float operations of one sample's training step through a
    convolution or dense layer, from its shapes: 2 per multiply-add, forward,
    input gradient (not for a layer fed by the network input) and weight
    gradient; 0 for other layers."""
    if layer_type == "Convolution":
        kh, kw = f["kernel_size"]
        fwd = 2.0 * out.height * out.width * out.channels * kh * kw \
            * f["n_in"]
    elif layer_type in ("Dense", "Output"):
        fwd = 2.0 * f["n_in"] * f["n_out"]
    else:
        return 0.0
    return fwd * (2 if first else 3)


def resnet_flops(conf, batch: int) -> float:
    """The float operations of one training step of a graph's convolutions
    and dense layers (:func:`_step_flops`)."""
    from deeplearning4j_tpu_torch.nn.conf.vertices import LayerVertex
    types = dict(zip(conf.network_inputs, conf.input_types))
    total = 0.0
    for name in conf.topological_order:
        v = conf.vertices[name]
        itypes = [types[s] for s in conf.vertex_inputs[name]]
        out = types[name] = v.output_type(itypes)
        if isinstance(v, LayerVertex):
            total += _step_flops(v.layer.type, v.layer.fields, out, all(
                s in conf.network_inputs for s in conf.vertex_inputs[name]))
    return total * batch


def _resnet_family(kernel: str, chain: list) -> str:
    """A ResNet step's device kernel by family, from its name and the
    names of the CPU ranges it was launched in (``chain``, innermost
    first): ``sm_xent``, batch norm (``ops/batch_norm.py``'s autograd
    function, forward and backward), the updater (its profiler range),
    cuDNN's convolutions and their gradients, GEMMs, copies, and the other
    elementwise, pooling and reduction kernels."""
    from deeplearning4j_tpu_torch.nn.graph_network import UPDATER_LABEL
    low = kernel.lower()
    if "sm_xent" in low:
        return "sm_xent"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any("BatchNormTrain" in c for c in chain):
        return "batch norm"
    if any(UPDATER_LABEL in c for c in chain):
        return "updater"
    if any("convolution" in c for c in chain) or any(
            k in low for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                               "implicit", "winograd", "fft")):
        return "convolutions"
    if "gemm" in low or "gemv" in low:
        return "GEMM"
    return "elementwise, pooling, reductions"


def device_us_by_family(prof, family) -> dict:
    """Device µs by family over a profile: each kernel is given to a family
    by ``family(kernel name, chain of enclosing CPU range names)``; what the
    events do not link to a launch is kept as ``unlinked``."""
    out = {}
    linked = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        for k in e.kernels:
            fam = family(k.name, chain)
            out[fam] = out.get(fam, 0.0) + float(k.duration)
            linked += float(k.duration)
    total = sum(us for _, _, us in device_events(prof))
    if total > linked:
        out["unlinked"] = total - linked
    return out


def _res_batch(g, n: int, size: int, classes: int, device):
    x = torch.randn(n, size, size, 3, generator=g)
    y = F.one_hot(torch.randint(0, classes, (n,), generator=g),
                  classes).float()
    return x.to(device), y.to(device)


def _f64(t):
    """A float64 CPU copy of a nested dict of tensors."""
    if isinstance(t, dict):
        return {k: _f64(v) for k, v in t.items()}
    return t.detach().to("cpu", torch.float64, copy=True)


def _from_cpu_state(card, ref) -> None:
    """The card network takes the CPU network's params, layer states,
    updater state, iteration and seed stream."""
    card.load_params(convert.to_numpy(ref.params_list),
                     convert.to_numpy(ref.state_list))
    card.load_updater_state(convert.to_numpy(ref.updater_state),
                            ref.iteration)
    card._rng.set_state(ref._rng.get_state())


class Float64Run:
    """A float64 copy of a CPU graph's params, states and updater state,
    stepped by the graph's own train step under an all-float64 dtype
    policy: the reference each float32 step is measured against."""

    def __init__(self, net: ComputationGraph):
        self.net, self.iteration = net, net.iteration
        self.params, self.states, self.upd = (
            _f64(net.params_list), _f64(net.state_list),
            _f64(net.updater_state))

    def step(self, x, y) -> float:
        prev = get_policy()
        set_policy(torch.float64, torch.float64, torch.float64)
        leaves = [v for p in self.params.values() for v in p.values()]
        try:
            for v in leaves:
                v.requires_grad_(True)
            self.states, self.upd, loss = make_graph_train_step(self.net)(
                self.params, self.states, self.upd, [x.double()],
                [y.double()], None, self.iteration)
        finally:
            set_policy(prev.param_dtype, prev.compute_dtype,
                       prev.output_dtype)
            for v in leaves:
                v.requires_grad_(False)
        self.iteration += 1
        return float(loss)


def _update_errs(params, exact: Float64Run, before) -> dict:
    """Each leaf's ``||p - p64|| / ||p64 - p0||``: a float32 step's
    params against the float64 step's, over how far the float64 step
    moved them."""
    out = {}
    for n, leaves in exact.params.items():
        for k, r in leaves.items():
            a = params[n][k].detach().to("cpu", torch.float64)
            out[f"{n}.{k}"] = float((a - r).norm()
                                    / (r - before[n][k]).norm()
                                    .clamp_min(1e-30))
    return out


def _gate_limits(cpu: dict) -> dict:
    """Each leaf's limit on the card's update error (RES_UPD_RATIO)."""
    med = float(np.median(list(cpu.values())))
    return {k: max(RES_UPD_RATIO * max(e, med), RES_UPD_FLOOR)
            for k, e in cpu.items()}


def _gate_misses(card: dict, cpu: dict) -> dict:
    """The leaves where the card's update error exceeds the gate: ``{leaf:
    (card e, CPU e)}``."""
    limit = _gate_limits(cpu)
    return {k: (card[k], cpu[k]) for k in card if not card[k] <= limit[k]}


def _logits(net, x):
    """The eval-mode input of the output layer and its logits (``W``,
    ``b``; before the softmax, which saturates at the running statistics
    of a new or barely trained network)."""
    name = net.conf.network_outputs[0]
    with torch.no_grad():
        _, _, li = graph_forward(net, net.params_list, net.state_list,
                                 [x.to(net.device)], train=False,
                                 collect_loss_inputs=True)
        p = net.params_list[name]
        return li[name].cpu(), (li[name] @ p["W"] + p["b"]).cpu()


def _scale_err(ours, ref) -> float:
    """The largest difference over the reference's largest magnitude."""
    return float((ours - ref).abs().max() / ref.abs().max())


def batch_statistics(net, x) -> dict:
    """Each batch-norm vertex's mean and biased variance over the batch
    ``x`` (a train-mode forward): the running statistics that training on
    batches like ``x`` settles at. Read from the state the forward returns,
    ``decay * state + (1 - decay) * batch``."""
    with torch.no_grad():
        _, new, _ = graph_forward(net, net.params_list, net.state_list,
                                  [x.to(net.device)], train=True)
    out = {}
    for name, state in net.state_list.items():
        if state:
            d = net.vertex_layers[name].decay
            out[name] = {k: ((new[name][k] - d * v) / (1 - d)).cpu()
                         for k, v in state.items()}
            out[name]["var"] = out[name]["var"].clamp_min(0.0)
    return out


def resnet(kernels) -> dict:
    """The ResNet-50 path on ``ComputationGraph``: (a) the card against the
    CPU from the same weights at 64x64, (b) step time, a profiled step by
    kernel family and peak memory at 224x224, B = 128, (c) ``evaluate`` and
    ``/v1/predict``, (d) ``sm_xent`` once a step."""
    # (a) full depth and width at 64x64: init on the CPU, clone to the card.
    # A free run cannot be held to 1e-4 for 3 steps: at 0.1 and B = 8 the
    # loss jumps from 7.7 to some 56 and 84, the gradient at init is only
    # about 1% accurate in float32 (against float64), and the float32 and
    # float64 CPU runs part as far as the card's does (printed below). So
    # ``lock`` starts each step from the CPU run's params, states and
    # updater state; its loss, BN running statistics and eval-mode logits
    # are held to 1e-4 and its update, leaf by leaf, to the gate above,
    # against a float64 step from the same point. ``free`` trains on its
    # own beside a float64 run from the same init; their drifts are
    # printed.
    ref = ComputationGraph(resnet50(n_classes=RES_CLASSES,
                                    image_size=RES_CHECK_SIZE),
                           device="cpu").init(seed=SEED)
    lock, free = ref.clone(device="cuda"), ref.clone(device="cuda")
    wide = Float64Run(ref)
    # the control: the config's learning rate times RES_CONTROL_LR
    conf = copy.deepcopy(ref.conf)
    for v in conf.vertices.values():
        f = getattr(getattr(v, "layer", None), "fields", {})
        for k in ("learning_rate", "bias_learning_rate"):
            if f.get(k) is not None:
                f[k] *= RES_CONTROL_LR
    control = ComputationGraph(conf, device="cuda")
    g = torch.Generator().manual_seed(SEED + 50)
    batches = [_res_batch(g, RES_CHECK_B, RES_CHECK_SIZE, RES_CLASSES, "cpu")
               for _ in range(RES_CHECK_STEPS)]
    xe = _res_batch(g, RES_CHECK_B, RES_CHECK_SIZE, RES_CLASSES, "cpu")[0]

    def logits_errs():
        """The card's eval-mode output-layer input and logits against the
        CPU's, each relative to its largest magnitude."""
        return [_scale_err(a, b) for a, b in zip(_logits(lock, xe),
                                                 _logits(ref, xe))]

    def stats_rel(net):
        """Worst relative difference (to the tensor's largest magnitude)
        of the BN running statistics against the CPU run, and where."""
        got = {f"{n}.{k}": float((net.state_list[n][k].cpu() - v).abs().max()
                                 / v.abs().max().clamp_min(1e-30))
               for n, st in ref.state_list.items() for k, v in st.items()}
        worst = max(got, key=got.get)
        return got[worst], worst

    def summary(card, cpu):
        """The worst card leaf, the medians, and the leaf nearest its
        limit: ``[leaf, card e / limit, card e, CPU e]``."""
        limit = _gate_limits(cpu)
        worst = max(card, key=card.get)
        near = max(card, key=lambda k: card[k] / limit[k])
        return {"card_worst": [worst, card[worst], cpu[worst]],
                "card_median": float(np.median(list(card.values()))),
                "cpu_median": float(np.median(list(cpu.values()))),
                "nearest_limit": [near, card[near] / limit[near], card[near],
                                  cpu[near]]}

    _from_cpu_state(lock, ref)
    logits0 = logits_errs()
    for fn in kernels:
        fn.launches = 0
    losses, free_losses, ref_losses, wide_losses = [], [], [], []
    lock_stats, upd, misses = [], [], {}
    for i, (x, y) in enumerate(batches):
        _from_cpu_state(lock, ref)
        before, exact = _f64(ref.params_list), Float64Run(ref)
        exact.step(x, y)
        lock.fit([x], [y])
        free.fit([x], [y])
        wide_losses.append(wide.step(x, y))
        if i == RES_CHECK_STEPS - 1:
            _from_cpu_state(control, ref)
            control.fit([x], [y])
        ref.fit([x], [y])
        losses.append(lock.score_value)
        free_losses.append(free.score_value)
        ref_losses.append(ref.score_value)
        lock_stats.append(stats_rel(lock))
        card_e = _update_errs(lock.params_list, exact, before)
        cpu_e = _update_errs(ref.params_list, exact, before)
        upd.append(summary(card_e, cpu_e))
        misses.update({f"step {i + 1} {k}": v
                       for k, v in _gate_misses(card_e, cpu_e).items()})
    control_e = _update_errs(control.params_list, exact, before)
    control_misses = _gate_misses(control_e, cpu_e)
    check_launches = {fn.__name__: fn.launches for fn in kernels}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    free_rel = [abs(a - b) / abs(b) for a, b in zip(free_losses, ref_losses)]
    wide_rel = [abs(a - b) / abs(b) for a, b in zip(ref_losses, wide_losses)]
    _from_cpu_state(lock, ref)
    logits1 = logits_errs()
    worst_stat = max(lock_stats)
    free_stat = stats_rel(free)
    print(f"resnet50 card vs CPU (64x64, B={RES_CHECK_B}, {RES_CHECK_STEPS} "
          f"steps, each from the CPU run's state): card losses {losses}; CPU "
          f"{ref_losses}; relative differences {rel} (tol 1e-4); eval-mode "
          f"output-layer input and logits, max_abs_err over their scale "
          f"{logits0} at init, {logits1} after (tol 1e-4); BN running stats "
          f"after each step, worst relative difference "
          f"{[f'{v:.3e} at {w}' for v, w in lock_stats]} (tol 1e-4); "
          f"launches {check_launches}", flush=True)
    for i, u in enumerate(upd):
        print(f"resnet50 step {i + 1} update against float64 from the same "
              f"point, e = ||p - p64|| / ||p64 - p0|| by leaf: {u} (gate: "
              f"card e <= max({RES_UPD_RATIO} x max(CPU e, CPU median e), "
              f"{RES_UPD_FLOOR}))", flush=True)
    print(f"resnet50 control (learning rate x{RES_CONTROL_LR}, step "
          f"{RES_CHECK_STEPS}): {summary(control_e, cpu_e)}, "
          f"{len(control_misses)} of {len(control_e)} leaves outside the "
          f"gate", flush=True)
    print(f"resnet50 drift of free runs: card against the CPU float32 run, "
          f"losses {free_losses} (relative {free_rel}; after "
          f"{RES_CHECK_STEPS} steps BN running stats worst relative "
          f"difference {free_stat[0]:.3e} at {free_stat[1]}); CPU float32 "
          f"against a CPU float64 run from the same init, float64 losses "
          f"{wide_losses} (relative {wide_rel})", flush=True)
    if not all(np.isfinite(losses)) or not max(rel) <= 1e-4:
        fail(f"ResNet-50 losses on the card {losses} disagree with the CPU "
             f"run {ref_losses}")
    if not max(logits0 + logits1) <= 1e-4:
        fail(f"ResNet-50 eval-mode logits on the card disagree with the "
             f"CPU: {logits0}, {logits1}")
    if not worst_stat[0] <= 1e-4:
        fail(f"ResNet-50 BN running statistics on the card disagree with the "
             f"CPU: {worst_stat}")
    if misses:
        fail(f"ResNet-50 updates on the card outside the gate (card e, CPU "
             f"e): {misses}")
    if not control_misses:
        fail("ResNet-50 gate control: an update at "
             f"{RES_CONTROL_LR} x the learning rate passed the gate")
    want = {fn.__name__: 0 for fn in kernels}
    want["softmax_cross_entropy"] = 2 * RES_CHECK_STEPS + 1
    if check_launches != want:
        fail(f"ResNet-50 launch counts {check_launches} != expected {want}")
    check = {"check_losses": losses, "check_cpu_losses": ref_losses,
             "check_rel_diffs": rel,
             "check_logits_scale_err": [logits0, logits1],
             "check_bn_stats_worst_rel": lock_stats,
             "check_update_errs": upd,
             "check_control": {"lr_factor": RES_CONTROL_LR,
                               **summary(control_e, cpu_e),
                               "leaves_outside_gate": len(control_misses),
                               "leaves": len(control_e)},
             "check_launches": check_launches,
             "drift_losses": free_losses, "drift_rel_diffs": free_rel,
             "drift_bn_stats_worst_rel": free_stat,
             "float64_losses": wide_losses,
             "float64_vs_cpu_rel_diffs": wide_rel}
    del ref, lock, free, control, wide, exact

    # (b) the bench's shape: the main path's launches, step time, a
    # profiled step and peak memory
    conf = resnet50()
    flops = resnet_flops(conf, RES_B)
    net = ComputationGraph(conf, device="cuda").init(seed=SEED)
    x, y = _res_batch(torch.Generator().manual_seed(SEED + 51), RES_B,
                      RES_SIZE, RES_CLASSES, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(RES_WARMUP):
        net.fit([x], [y])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(RES_TIMED):
        net.fit([x], [y])
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / RES_TIMED
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak_bytes = torch.cuda.max_memory_allocated()
    timed_loss = net.score_value
    want = {fn.__name__: 0 for fn in kernels}
    want["softmax_cross_entropy"] = RES_WARMUP + RES_TIMED
    if launches != want:
        fail(f"ResNet-50 launch counts at B={RES_B} {launches} != {want}")
    if not np.isfinite(timed_loss):
        fail(f"ResNet-50 loss at B={RES_B} is not finite: {timed_loss}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit([x], [y])
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    by_family = device_us_by_family(prof, _resnet_family)
    by_name = {}
    for key, _, us in device_events(prof):
        if us:
            by_name[key] = by_name.get(key, 0.0) + us
    busy_us = sum(by_name.values())
    if busy_us <= 0:
        fail("the profiler saw no device time in the ResNet-50 step")

    # (c) evaluate, and /v1/predict held to the card's own output
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    ge = torch.Generator().manual_seed(SEED + 52)
    eval_sets = [DataSet(*(t.numpy() for t in _res_batch(
        ge, RES_B, RES_SIZE, RES_CLASSES, "cpu")))
        for _ in range(RES_EVAL // RES_B)]
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    ev = net.evaluate(eval_sets)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = {fn.__name__: fn.launches for fn in kernels}
    if ev.num_examples != RES_EVAL or any(eval_launches.values()):
        fail(f"ResNet-50 evaluate saw {ev.num_examples} images, launches "
             f"{eval_launches}")
    # served: a new network (seed SEED + 1) with a batch's own statistics
    # as its running statistics, as a long run settles at. At the running
    # statistics of a new or briefly trained network (0 and 1, or a
    # quarter of them after 12 steps) the eval-mode softmax saturates to
    # exact one-hots, and so does a network trained at 0.1 for 12 steps;
    # such an answer would hide a wrong one
    served = ComputationGraph(conf, device="cuda").init(seed=SEED + 1)
    served.load_state(batch_statistics(served, x))
    rows = eval_sets[0].features[:RES_SERVE_ROWS]
    srv = InferenceServer(device="cuda", max_batch=RES_SERVE_ROWS)
    srv.start()
    try:
        srv.register("resnet50", served)
        t0 = time.perf_counter()
        status, body = post(srv.port, "/v1/predict",
                            {"model": "resnet50", "inputs": rows.tolist()})
        predict_s = time.perf_counter() - t0
    finally:
        srv.stop()
    if status != 200:
        fail(f"ResNet-50 /v1/predict returned {status}: {body[:500]}")
    pred = np.asarray(json.loads(body)["predictions"], np.float64)
    own = served.output(rows)[0].cpu().double().numpy()
    # log-probabilities: a probability that underflows to 0 fails
    with np.errstate(divide="ignore"):
        perr = float(np.abs(np.log(pred) - np.log(own)).max())
    print(f"resnet50 evaluate on {ev.num_examples} images in {eval_s:.3f}s "
          f"(accuracy {ev.accuracy():.4f}, random labels); /v1/predict "
          f"[{RES_SERVE_ROWS}, {RES_SIZE}, {RES_SIZE}, 3] in {predict_s:.3f}s:"
          f" log-probabilities max_abs_err {perr:.3e} against the card's "
          f"output (tol 1e-4); probabilities from {own.min():.3e} to "
          f"{own.max():.3e}", flush=True)
    if pred.shape != (RES_SERVE_ROWS, RES_CLASSES) or not perr <= 1e-4:
        fail(f"ResNet-50 /v1/predict {pred.shape} disagrees with output: "
             f"{perr}")

    result = {
        "card": CARD, **check, "launches": launches,
        "eval_launches": eval_launches, "batch": RES_B,
        "image_size": RES_SIZE, "warmup_s": warm_s, "step_ms": step_ms,
        "samples_per_s": RES_B / (step_ms / 1e3), "timed_loss": timed_loss,
        "profiled_step_ms": prof_ms, "device_us_total": busy_us,
        "device_us_by_family": by_family,
        "device_us_by_kernel": by_name,
        "idle_share_unprofiled": 1.0 - busy_us / 1e3 / step_ms,
        "idle_share_profiled": 1.0 - busy_us / 1e3 / prof_ms,
        "step_tflop": flops / 1e12,
        "f32_peak_share": flops / F32_OPS_PER_S / (step_ms / 1e3),
        "f32_peak_share_of_device_time": flops / F32_OPS_PER_S
        / (busy_us / 1e6),
        "peak_memory_bytes": peak_bytes, "eval_s": eval_s,
        "eval_accuracy": ev.accuracy(), "predict_s": predict_s,
        "predict_log_prob_max_abs_err": perr,
        "predict_prob_range": [float(own.min()), float(own.max())]}
    print(f"resnet50 step (224x224x3, B={RES_B}, float32, TF32 off): "
          f"{step_ms:.3f} ms wall, {result['samples_per_s']:.1f} samples/s "
          f"({RES_TIMED} timed steps after {RES_WARMUP} warm-up, "
          f"{warm_s:.2f}s); profiled step {prof_ms:.3f} ms, device time "
          f"{busy_us:.1f} us, idle share {result['idle_share_unprofiled']:.3f}"
          f" of the unprofiled step ({result['idle_share_profiled']:.3f} "
          f"profiled); {flops / 1e12:.4f} TFLOP a step, "
          f"{100 * result['f32_peak_share']:.1f}% of the float32 peak "
          f"(67 TFLOP/s) over the wall step, "
          f"{100 * result['f32_peak_share_of_device_time']:.1f}% over the "
          f"device time; peak memory {peak_bytes / 2**30:.2f} GiB; launches "
          f"{launches} [{CARD}]", flush=True)
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  resnet50 step device time {fam}: {us:.1f} us "
              f"({100 * us / busy_us:.1f}%)", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"    {us:9.1f} us  {name[:110]}", flush=True)
    return result


#: the K-step phase (nn/ksteps.py: a CUDA graph of the train step, replayed
#: once a step): full-width LeNet, a 20-batch fit_iterator epoch at
#: ksteps 8 (groups of 8, 8 and 4); full-width transformer_lm(256),
#: fit(x, y, epochs=8) at dispatch_ksteps 4; full-depth resnet50(), 4 steps
#: at 64x64 and B = 8, then fit(epochs=4) at 224x224, B = 128. Each against
#: eager single steps from one init, then timed in turns (KS_TURNS: eager,
#: K-step, K-step, eager, ..., five calls each) after a warm-up call and
#: profiled once
KS_LENET_K, KS_TRANSFORMER_K, KS_TRANSFORMER_STEPS, KS_RES_K = 8, 4, 8, 4
KS_TURNS = ("eager", "kstep", "kstep", "eager") * 2 + ("eager", "kstep")
#: ResNet-50's ragged epoch at ksteps 4: a group at the full batch, then a
#: group of the smaller tail batch, which captures a second step into the
#: network's one memory pool; at 64x64 against eager, at 224x224 for the
#: footprint
KS_RES_RAGGED = (4, 2)
KS_RES_TAIL_CHECK, KS_RES_TAIL = 6, 96
#: a replayed step against an eager one on the card from one state: the
#: same kernels on the same inputs (cuDNN deterministic for the check), but
#: the scalars a learning-rate policy and Adam's bias correction read come
#: from the card in a replay and from the host in an eager step: losses
#: within 1e-5 relative, params and running statistics within 1e-5 of each
#: leaf's largest magnitude
KS_TOL = 1e-5
#: (name, result, eager run, K-step run, steps) of the K-step timings whose
#: profiled call waits until the host-bound paths have been timed: a
#: profiler session may leave the process's later launches slower on the
#: host
PROFILE_LATER: list = []
#: the graph_rnn phase: char_rnn_lstm(64)'s layers built as a
#: ComputationGraph (2 x GravesLSTM(200), RnnOutput(64), mcxent, TBPTT 50,
#: RMSProp 0.95 at RNN_LR): 2 batches of [32, 200, 64] (8 chunks) and a
#: 64-step rnn_time_step and /v1/stream session, against the CPU
RNN_STREAM_STEPS = 64


def _launches(kernels) -> dict:
    return {fn.__name__: fn.launches for fn in kernels}


def _zero(kernels) -> None:
    for fn in kernels:
        fn.launches = 0


def _leaf_errs(a, b) -> dict:
    """Each leaf's largest difference over its largest magnitude, for two
    nested lists or dicts of tensors (params, or layer states)."""
    out = {}
    items = a.items() if isinstance(a, dict) else enumerate(a)
    for i, leaves in items:
        for k, v in leaves.items():
            v, w = v.detach(), b[i][k].detach()
            out[f"{i}.{k}"] = float((v - w).abs().max()) / max(
                float(w.abs().max()), 1e-12)
    return out


def _compare(name, card_losses, eager_losses, pairs) -> dict:
    """Losses and leaf errors of a K-step run against the eager one; fails
    the phase past KS_TOL."""
    rel = max(abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(card_losses, eager_losses))
    errs = {}
    for a, b in pairs:
        errs.update(_leaf_errs(a, b))
    worst = max(errs.values()) if errs else 0.0
    print(f"ksteps {name}: K-step losses {card_losses}; eager "
          f"{eager_losses}; worst relative loss difference {rel:.3e}, worst "
          f"leaf {worst:.3e} (tol {KS_TOL:.0e})", flush=True)
    if len(card_losses) != len(eager_losses) or not rel <= KS_TOL \
            or not worst <= KS_TOL or not all(np.isfinite(card_losses)):
        fail(f"{name}: the K-step run disagrees with eager single steps "
             f"(losses {rel}, worst leaf {worst})")
    return {"losses": card_losses, "eager_losses": eager_losses,
            "worst_rel_loss_diff": rel, "worst_leaf_rel_err": worst}


def _device_us(prof) -> float:
    return sum(device_time_by_kernel(prof).values())


def _timed_pair(name, eager_run, kstep_run, steps: int,
                profile_now: bool = True) -> dict:
    """Wall ms a step of both runs in turns (KS_TURNS; host clock around
    calls that end in a synchronize): the mean, the median and the range
    of each, and the speed-up's range (the slowest eager call over the
    fastest K-step one, and the other way round); the peak memory of each;
    then (:func:`_profile_pair`, at once or, with ``profile_now`` False,
    from PROFILE_LATER after the phases that time host-bound paths) one
    profiled call of each."""
    walls = {"eager": [], "kstep": []}
    peaks = {"eager": 0, "kstep": 0}
    for which in KS_TURNS:
        run = eager_run if which == "eager" else kstep_run
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls[which].append(1e3 * (time.perf_counter() - t0) / steps)
        peaks[which] = max(peaks[which], torch.cuda.max_memory_allocated())
    out = {which: {"wall_ms_per_step": float(np.mean(walls[which])),
                   "wall_ms_median": float(np.median(walls[which])),
                   "wall_ms_range": [min(walls[which]), max(walls[which])],
                   "wall_ms_runs": walls[which],
                   "peak_memory_bytes": peaks[which]}
           for which in ("eager", "kstep")}
    out["speed_up_range"] = [min(walls["eager"]) / max(walls["kstep"]),
                             max(walls["eager"]) / min(walls["kstep"])]
    pending = (name, out, eager_run, kstep_run, steps)
    if profile_now:
        _profile_pair(*pending)
    else:
        PROFILE_LATER.append(pending)
    return out


def _profile_pair(name, out, eager_run, kstep_run, steps: int) -> None:
    """One profiled call of each run: device µs a step and the idle share
    (against the unprofiled wall time) added to ``out``."""
    for which, run in (("eager", eager_run), ("kstep", kstep_run)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            prof_ms = 1e3 * (time.perf_counter() - t0) / steps
        dev_us = _device_us(prof) / steps
        if dev_us <= 0:
            fail(f"{name}: the profiler saw no device time in the {which} "
                 "run")
        o = out[which]
        o.update(device_us_per_step=dev_us,
                 idle_share=1.0 - dev_us / 1e3 / o["wall_ms_per_step"],
                 profiled_ms_per_step=prof_ms,
                 idle_share_profiled=1.0 - dev_us / 1e3 / prof_ms)
    e, k = out["eager"], out["kstep"]
    lo, hi = out["speed_up_range"]
    print(f"ksteps {name} timing [{CARD}]: K-step {k['wall_ms_per_step']:.3f} "
          f"ms a step, median {k['wall_ms_median']:.3f} (runs "
          f"{[round(v, 3) for v in k['wall_ms_runs']]}), device "
          f"{k['device_us_per_step']:.1f} us, idle share "
          f"{k['idle_share']:.3f}, peak {k['peak_memory_bytes'] / 2**30:.2f} "
          f"GiB; eager {e['wall_ms_per_step']:.3f} ms, median "
          f"{e['wall_ms_median']:.3f} (runs "
          f"{[round(v, 3) for v in e['wall_ms_runs']]}), device "
          f"{e['device_us_per_step']:.1f} us, idle share "
          f"{e['idle_share']:.3f}, peak {e['peak_memory_bytes'] / 2**30:.2f} "
          f"GiB; speed-up {e['wall_ms_per_step'] / k['wall_ms_per_step']:.2f}x "
          f"of the means ({lo:.2f}x to {hi:.2f}x over the calls)", flush=True)


def _graph_counts(net, launches: dict) -> dict:
    """The replays of a network's captured steps, each kernel's launches a
    replay and the graphs' memory pools, beside the launches counted."""
    per = {}
    replays = pool = 0
    for sg in net._step_graphs.values():
        replays += sg.replays
        pool += sg.pool_bytes
        for fn, n in sg.per_replay.items():
            per[fn.__name__] = per.get(fn.__name__, 0) + n
    return {"replays": replays, "captured_per_replay": per,
            "graph_pool_bytes": pool, "launches": launches}


def _footprint(timing: dict, graphs: dict) -> None:
    """The K-step run's peak memory with the graph's pool added: the
    allocator's peak of allocated bytes does not count the pool's blocks
    between replays."""
    k = timing["kstep"]
    k["footprint_bytes"] = k["peak_memory_bytes"] + graphs["graph_pool_bytes"]
    print(f"  K-step peak {k['peak_memory_bytes'] / 2**30:.3f} GiB allocated "
          f"+ graph pool {graphs['graph_pool_bytes'] / 2**30:.3f} GiB = "
          f"{k['footprint_bytes'] / 2**30:.3f} GiB; eager peak "
          f"{timing['eager']['peak_memory_bytes'] / 2**30:.3f} GiB",
          flush=True)


def ksteps_lenet(kernels) -> dict:
    """A 20-batch fit_iterator epoch of full-width LeNet at ksteps 8 against
    the same epoch in single steps, from one init."""
    def epoch():
        return MnistDataSetIterator(
            LENET_B, num_examples=LENET_B * LENET_EPOCH_BATCHES)

    torch.backends.cudnn.deterministic = True
    try:
        k = MultiLayerNetwork(lenet_mnist(), device="cuda").init(seed=SEED)
        e = k.clone()
        logs = {}
        counts = {}
        for name, net, ks in (("kstep", k, KS_LENET_K), ("eager", e, 1)):
            logs[name] = []
            net.set_listeners(_LossLog(logs[name]))
            _zero(kernels)
            net.fit_iterator(epoch(), ksteps=ks)
            torch.cuda.synchronize()
            counts[name] = _launches(kernels)
            net.set_listeners()
    finally:
        torch.backends.cudnn.deterministic = False
    check = _compare("lenet", logs["kstep"], logs["eager"],
                     [(k.params_list, e.params_list)])
    want = {fn.__name__: 0 for fn in kernels}
    want["softmax_cross_entropy"] = LENET_EPOCH_BATCHES
    graphs = _graph_counts(k, counts["kstep"])
    groups = [KS_LENET_K, KS_LENET_K,
              LENET_EPOCH_BATCHES - 2 * KS_LENET_K]
    print(f"ksteps lenet: launches K-step {counts['kstep']}, eager "
          f"{counts['eager']}; {graphs['replays']} replays of "
          f"{graphs['captured_per_replay']} (groups {groups}, a group's "
          f"first step of new shapes captures)", flush=True)
    if counts["kstep"] != want or counts["eager"] != want \
            or graphs["replays"] != LENET_EPOCH_BATCHES - 1 \
            or graphs["captured_per_replay"] != {"softmax_cross_entropy": 1}:
        fail(f"LeNet K-step launches {counts} or replays {graphs} wrong")

    k2 = MultiLayerNetwork(lenet_mnist(), device="cuda").init(seed=SEED + 7)
    e2 = k2.clone()
    it_k, it_e = epoch(), epoch()
    k2.fit_iterator(it_k, ksteps=KS_LENET_K)  # captures
    e2.fit_iterator(it_e, ksteps=1)
    timing = _timed_pair(
        "lenet (B = 128, a fit_iterator epoch of 20 batches)",
        lambda: e2.fit_iterator(it_e, ksteps=1),
        lambda: k2.fit_iterator(it_k, ksteps=KS_LENET_K),
        LENET_EPOCH_BATCHES, profile_now=False)
    _footprint(timing, _graph_counts(k2, {}))
    pf = k2.prefetcher
    timing["prefetch"] = {"staged": pf.staged, "bytes": pf.bytes,
                          "staging_s": pf.staging_s, "wait_s": pf.wait_s}
    print(f"  the last timed K-step epoch's prefetcher: {pf.staged} groups, "
          f"{pf.bytes / 2**20:.2f} MiB staged, {1e3 * pf.staging_s:.3f} ms "
          f"staging on its thread, {1e3 * pf.wait_s:.3f} ms waited for",
          flush=True)
    return {**check, **graphs, "eager_launches": counts["eager"],
            "groups": groups, **timing}


def ksteps_transformer(kernels) -> dict:
    """fit(x, y, epochs=8) of full-width transformer_lm(256) at B = 16,
    T = 256 (Adam at 3e-4) at dispatch_ksteps 4 against 8 single steps."""
    conf = transformer_lm(TRAIN_V)
    ids = np.random.default_rng(SEED + 11).integers(
        0, TRAIN_V, size=(TRAIN_B, TRAIN_T))
    x = np.eye(TRAIN_V, dtype=np.float32)[ids]
    k = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    k.dispatch_ksteps = KS_TRANSFORMER_K
    e = k.clone()
    e.dispatch_ksteps = 1
    logs, counts = {}, {}
    for name, net in (("kstep", k), ("eager", e)):
        logs[name] = []
        net.set_listeners(_LossLog(logs[name]))
        _zero(kernels)
        net.fit(x, x, epochs=KS_TRANSFORMER_STEPS)
        torch.cuda.synchronize()
        counts[name] = _launches(kernels)
        net.set_listeners()
    check = _compare("transformer", logs["kstep"], logs["eager"],
                     [(k.params_list, e.params_list)])
    n = KS_TRANSFORMER_STEPS
    want = {fn.__name__: 0 for fn in kernels}
    want.update(softmax_cross_entropy=n, flash_fwd=4 * n, flash_bwd_dq=4 * n,
                flash_bwd_dkv=4 * n)
    graphs = _graph_counts(k, counts["kstep"])
    print(f"ksteps transformer: launches K-step {counts['kstep']}, eager "
          f"{counts['eager']}; {graphs['replays']} replays of "
          f"{graphs['captured_per_replay']}", flush=True)
    if counts["kstep"] != want or counts["eager"] != want \
            or graphs["replays"] != n - 1:
        fail(f"transformer K-step launches {counts} or replays {graphs} "
             "wrong")
    timing = _timed_pair(
        "transformer (B = 16, T = 256, fit(epochs=8))",
        lambda: e.fit(x, x, epochs=n), lambda: k.fit(x, x, epochs=n), n,
        profile_now=False)
    _footprint(timing, graphs)
    return {**check, **graphs, "eager_launches": counts["eager"], **timing}


def _res_ragged(g, batch: int, tail: int, size: int) -> list:
    """ResNet-50's ragged epoch (KS_RES_RAGGED): full batches, then smaller
    tail batches, as host arrays."""
    from deeplearning4j_tpu_torch.nn.graph_network import MultiDataSet

    rows = [batch] * KS_RES_RAGGED[0] + [tail] * KS_RES_RAGGED[1]
    return [MultiDataSet(*([t.numpy()] for t in _res_batch(
        g, n, size, RES_CLASSES, "cpu"))) for n in rows]


def _shared_pool(net) -> bool:
    pools = {sg.graph.pool() for sg in net._step_graphs.values()}
    return len(net._step_graphs) == 2 and len(pools) == 1


def ksteps_resnet(kernels) -> dict:
    """Full-depth resnet50(). At 64x64: 4 steps at B = 8, then a ragged
    epoch (4 batches of 8, 2 of 6) whose tail captures a second step into
    the network's memory pool, K-step against eager (losses, params, batch
    norm's running statistics). At 224x224, B = 128: the K-step
    fit(epochs=4), its launches counted alone, then timed beside the eager
    steps, then a ragged epoch (4 batches of 128, 2 of 96) for the
    footprint of two captured steps in one pool."""
    from deeplearning4j_tpu_torch.nn.graph_network import MultiDataSet

    g = torch.Generator().manual_seed(SEED + 61)
    x, y = _res_batch(g, RES_CHECK_B, RES_CHECK_SIZE, RES_CLASSES, "cpu")
    mds = MultiDataSet([x.numpy()], [y.numpy()])
    ragged = _res_ragged(g, RES_CHECK_B, KS_RES_TAIL_CHECK, RES_CHECK_SIZE)
    torch.backends.cudnn.deterministic = True
    try:
        k = ComputationGraph(resnet50(n_classes=RES_CLASSES,
                                      image_size=RES_CHECK_SIZE),
                             device="cuda").init(seed=SEED)
        k.dispatch_ksteps = KS_RES_K
        e = k.clone()
        e.dispatch_ksteps = 1
        logs, counts = {}, {}
        for name, net in (("kstep", k), ("eager", e)):
            logs[name] = []
            net.set_listeners(_LossLog(logs[name]))
            _zero(kernels)
            net.fit(mds, epochs=KS_RES_K)
            net.fit_iterator(ragged)
            torch.cuda.synchronize()
            counts[name] = _launches(kernels)
            net.set_listeners()
    finally:
        torch.backends.cudnn.deterministic = False
    check = _compare("resnet50 (64x64, B = 8, then the ragged epoch)",
                     logs["kstep"], logs["eager"],
                     [(k.params_list, e.params_list),
                      (k.state_list, e.state_list)])
    want = {fn.__name__: 0 for fn in kernels}
    want["softmax_cross_entropy"] = KS_RES_K + len(ragged)
    if counts["kstep"] != want or counts["eager"] != want:
        fail(f"ResNet-50 K-step launches {counts} != {want}")
    if not _shared_pool(k):
        fail("ResNet-50's two captured steps (B = 8, 6) do not share one "
             "memory pool")
    del k, e

    conf = resnet50(n_classes=RES_CLASSES, image_size=RES_SIZE)
    xb, yb = _res_batch(torch.Generator().manual_seed(SEED + 62), RES_B,
                        RES_SIZE, RES_CLASSES, "cuda")
    big = MultiDataSet([xb], [yb])
    k = ComputationGraph(conf, device="cuda").init(seed=SEED)
    k.dispatch_ksteps = KS_RES_K
    e = k.clone()
    e.dispatch_ksteps = 1
    # the K-step path's own run, counted alone: the first step captures
    _zero(kernels)
    t0 = time.perf_counter()
    k.fit(big, epochs=KS_RES_K)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    launches = _launches(kernels)
    graphs = _graph_counts(k, launches)
    _zero(kernels)
    e.fit(big, epochs=KS_RES_K)
    torch.cuda.synchronize()
    eager_launches = _launches(kernels)
    want = {fn.__name__: 0 for fn in kernels}
    want["softmax_cross_entropy"] = KS_RES_K
    print(f"ksteps resnet50: launches at 64x64 K-step {counts['kstep']}, "
          f"eager {counts['eager']}; at 224x224 the K-step fit(epochs="
          f"{KS_RES_K}) {launches}, {graphs['replays']} replays of "
          f"{graphs['captured_per_replay']}; the eager one {eager_launches}",
          flush=True)
    if launches != want or eager_launches != want \
            or graphs["replays"] != KS_RES_K - 1 \
            or graphs["captured_per_replay"] != {"softmax_cross_entropy": 1}:
        fail(f"ResNet-50 K-step launches {launches}, eager {eager_launches} "
             f"or replays {graphs} wrong at 224x224")
    timing = _timed_pair(
        f"resnet50 (224x224x3, B = {RES_B}, fit(epochs={KS_RES_K}))",
        lambda: e.fit(big, epochs=KS_RES_K),
        lambda: k.fit(big, epochs=KS_RES_K), KS_RES_K)
    _footprint(timing, graphs)
    tail = _ragged_footprint(k, _res_ragged(
        torch.Generator().manual_seed(SEED + 63), RES_B, KS_RES_TAIL,
        RES_SIZE))
    out = {**check, "check_launches": counts, **graphs,
           "eager_launches": eager_launches, "first_call_s": capture_s,
           **timing, "ragged_epoch": tail}
    del k, e
    torch.cuda.empty_cache()
    return out


def _ragged_footprint(k, epoch: list) -> dict:
    """A ragged fit_iterator epoch of ResNet-50 at 224x224: the tail's
    group captures a second step into the network's one pool. Its losses
    must be finite; the pool's growth at that capture and the card's
    reserved memory (its peak: the pool, the tail's warm-up step outside it,
    the staged groups) are kept."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool0 = sum(sg.pool_bytes for sg in k._step_graphs.values())
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    k.set_listeners(_LossLog(losses))
    t0 = time.perf_counter()
    k.fit_iterator(epoch)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    k.set_listeners()
    tail = next(sg for sg in k._step_graphs.values()
                if sg.inputs[0].shape[0] == KS_RES_TAIL)
    out = {"rows": [int(ds.features[0].shape[0]) for ds in epoch],
           "losses": losses, "wall_s": wall_s,
           "replays": {int(sg.inputs[0].shape[0]): sg.replays
                       for sg in k._step_graphs.values()},
           "pool_before_bytes": pool0, "tail_capture_pool_bytes":
               tail.pool_bytes,
           "reserved_before_bytes": reserved0,
           "max_reserved_bytes": torch.cuda.max_memory_reserved(),
           "reserved_after_bytes": torch.cuda.memory_reserved(),
           "max_allocated_bytes": torch.cuda.max_memory_allocated()}
    gib = {key: v / 2**30 for key, v in out.items() if key.endswith("bytes")}
    print(f"ksteps resnet50 ragged epoch (rows {out['rows']}, ksteps "
          f"{KS_RES_K}) [{CARD}]: {wall_s:.3f}s, losses "
          f"{[round(v, 4) for v in losses]}; replays by batch "
          f"{out['replays']}; the shared pool {gib['pool_before_bytes']:.3f} "
          f"GiB before, grew {gib['tail_capture_pool_bytes']:.3f} GiB at "
          f"the B = {KS_RES_TAIL} capture; reserved "
          f"{gib['reserved_before_bytes']:.3f} GiB before, peak "
          f"{gib['max_reserved_bytes']:.3f}, after "
          f"{gib['reserved_after_bytes']:.3f}; peak allocated "
          f"{gib['max_allocated_bytes']:.3f} GiB", flush=True)
    if len(losses) != len(epoch) or not all(np.isfinite(losses)) \
            or not _shared_pool(k):
        fail(f"ResNet-50's ragged epoch: losses {losses}, or its two "
             "captured steps do not share one memory pool")
    return out


#: the diagnostics phase (A9.3): full-width transformer_lm(256) at the
#: train shape through fit(epochs=8) in groups of KS_TRANSFORMER_K, with a
#: HealthMonitor at DIAG_CADENCE; the cost of monitoring at
#: DIAG_COST_CADENCE over DIAG_COST_STEPS a call, DIAG_TURNS; a NaN batch at
#: iteration DIAG_NAN_AT of DIAG_NAN_STEPS; a host stall of DIAG_STALL_S
#: under a watchdog of DIAG_WATCHDOG_S
DIAG_CADENCE, DIAG_COST_CADENCE, DIAG_COST_STEPS = 4, 50, 50
DIAG_TURNS = ("plain", "health", "health", "plain") * 2 + ("plain", "health")
DIAG_NAN_AT, DIAG_NAN_STEPS = 6, 12
DIAG_WATCHDOG_S, DIAG_STALL_S, DIAG_STALL_AT = 1.0, 2.0, 6
#: a monitored K-step summary against an eager monitored fit's: K-step and
#: eager already part by up to KS_TOL in the parameters
DIAG_TOL = 1e-4


def _series(name: str, **labels) -> float:
    """The process registry's series of ``name`` whose labels include
    ``labels``, summed (a histogram's count)."""
    from deeplearning4j_tpu_torch.observability import global_registry
    fam = global_registry().snapshot().get(name, {"series": []})
    return sum(s.get("value", s.get("count", 0)) for s in fam["series"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


class _Summaries:
    """Every summary a HealthMonitor resolves, in order."""

    def __init__(self, hm):
        self.seen = []
        inner = hm._resolve

        def resolve(pending):
            alarm = inner(pending)
            self.seen.append(dict(hm.last))
            return alarm
        hm._resolve = resolve


class _Stall:
    """A listener that sleeps on the host at one iteration: the watchdog
    sees no beat meanwhile."""

    def __init__(self, at: int, seconds: float):
        self.at, self.seconds = at, seconds

    def iteration_done(self, model, iteration):
        if iteration == self.at:
            time.sleep(self.seconds)


def _diag_groups(n: int, k: int) -> list:
    return [(s, min(k, n - s)) for s in range(0, n, k)]


def diagnostics_phase(kernels) -> dict:
    """A9.3 on the card: the health variant of the K-step graph against the
    plain one, the cost of monitoring, a NaN alarm's bundle, a watchdog
    stall (see the module docstring, step 10)."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.observability import (
        HealthMonitor, NanAlertListener, global_recorder, install_watchdog,
        names, uninstall_watchdog)
    from deeplearning4j_tpu_torch.observability.flight_recorder import (
        BUNDLE_FILES, DUMP_DIR_ENV)

    t_phase = time.perf_counter()
    out = {}
    conf = transformer_lm(TRAIN_V)
    ids = np.random.default_rng(SEED + 11).integers(
        0, TRAIN_V, size=(TRAIN_B, TRAIN_T))
    x = np.eye(TRAIN_V, dtype=np.float32)[ids]
    base = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    n = KS_TRANSFORMER_STEPS

    # (a) monitored K-step fit, unmonitored, eager monitored: one init
    runs = {}
    for name, k, monitored in (("health", KS_TRANSFORMER_K, True),
                               ("plain", KS_TRANSFORMER_K, False),
                               ("eager", 1, True)):
        net = base.clone()
        net.dispatch_ksteps = k
        logs, listeners, hm, seen = [], [], None, None
        if monitored:
            hm = HealthMonitor(cadence=DIAG_CADENCE).attach(net)
            seen = _Summaries(hm)
            listeners.append(NanAlertListener())
        net.set_listeners(*listeners, _LossLog(logs))
        _zero(kernels)
        net.fit(x, x, epochs=n)
        torch.cuda.synchronize()
        if hm is not None:
            hm.poll()
        runs[name] = {"net": net, "losses": logs, "hm": hm,
                      "summaries": seen.seen if seen else None,
                      "launches": _launches(kernels)}
        net.set_listeners()
    h, p, e = runs["health"], runs["plain"], runs["eager"]
    bitwise = h["losses"] == p["losses"] and all(
        torch.equal(a[key], b[key]) for a, b in zip(
            h["net"].params_list, p["net"].params_list) for key in a)
    want_checks = sum(h["hm"].due_index(s, g) is not None
                      for s, g in _diag_groups(n, KS_TRANSFORMER_K))
    graphs = {sg.health: sg for sg in h["net"]._step_graphs.values()}
    per = {flag: {fn.__name__: c for fn, c in sg.per_replay.items()}
           for flag, sg in graphs.items()}
    pool = {("health" if flag else "plain"): sg.pool_bytes
            for flag, sg in graphs.items()}
    plain_pool = sum(sg.pool_bytes for sg in p["net"]._step_graphs.values())
    rel = {}
    for ks, eg in zip(h["summaries"], e["summaries"]):
        for key in ("grad_norm", "update_norm", "loss"):
            rel[key] = max(rel.get(key, 0.0), _rel(ks[key], eg[key]))
    want = {fn.__name__: 0 for fn in kernels}
    want.update(softmax_cross_entropy=n, flash_fwd=4 * n, flash_bwd_dq=4 * n,
                flash_bwd_dkv=4 * n)
    print(f"diagnostics (a): monitored K-step fit (cadence {DIAG_CADENCE}, "
          f"groups of {KS_TRANSFORMER_K}, {n} steps) bitwise the unmonitored "
          f"one: {bitwise}; checks {h['hm'].checks} (due_index {want_checks})"
          f" at {[s['iteration'] for s in h['summaries']]}; summaries "
          f"{h['summaries']}; eager monitored {e['summaries']}; worst "
          f"relative difference {rel} (tol {DIAG_TOL:.0e}); launches "
          f"monitored {h['launches']}, plain {p['launches']}; a replay's "
          f"launches health {per.get(True)}, plain {per.get(False)}; graph "
          f"pool grown by the captures {pool} (the unmonitored net's one "
          f"capture {plain_pool})", flush=True)
    if not bitwise:
        fail("diagnostics: the monitored fit parts from the unmonitored one")
    if h["hm"].checks != want_checks or e["hm"].checks != n // DIAG_CADENCE:
        fail(f"diagnostics: {h['hm'].checks} checks, want {want_checks}")
    if set(graphs) != {True, False} or per[True] != per[False]:
        fail(f"diagnostics: the health graph's launches {per}")
    if h["launches"] != want or p["launches"] != want:
        fail("diagnostics: launches moved under the monitor")
    if len(h["summaries"]) != len(e["summaries"]) or not all(
            v <= DIAG_TOL for v in rel.values()) or any(
            s["nonfinite_grads"] for s in h["summaries"] + e["summaries"]):
        fail(f"diagnostics: summaries against the eager fit: {rel}")
    out["fit"] = {"bitwise": bitwise, "checks": h["hm"].checks,
                  "summaries": h["summaries"],
                  "eager_summaries": e["summaries"], "worst_rel": rel,
                  "per_replay": {str(k): v for k, v in per.items()},
                  "pool_bytes": pool, "plain_pool_bytes": plain_pool}
    out["launches"] = h["launches"]
    del runs, h, p, e

    # (b) the cost of monitoring: cadence 50 against none, in turns
    nets = {"health": base.clone(), "plain": base.clone()}
    for name, net in nets.items():
        net.dispatch_ksteps = KS_TRANSFORMER_K
        if name == "health":
            HealthMonitor(cadence=DIAG_COST_CADENCE).attach(net)
            net.set_listeners(NanAlertListener())
        net.fit(x, x, epochs=DIAG_COST_STEPS)  # captures
    torch.cuda.synchronize()
    walls = {"health": [], "plain": []}
    for which in DIAG_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nets[which].fit(x, x, epochs=DIAG_COST_STEPS)
        torch.cuda.synchronize()
        walls[which].append(1e3 * (time.perf_counter() - t0)
                            / DIAG_COST_STEPS)
    checks = nets["health"].health_monitor.checks
    cost = {k: {"mean": float(np.mean(v)), "range": [min(v), max(v)],
                "runs": v} for k, v in walls.items()}
    print(f"diagnostics (b) [{CARD}]: ms a step, {len(walls['plain'])} calls "
          f"of {DIAG_COST_STEPS} steps a side in turns: monitored (cadence "
          f"{DIAG_COST_CADENCE}) {cost['health']['mean']:.3f} (range "
          f"{cost['health']['range'][0]:.3f}-{cost['health']['range'][1]:.3f}"
          f"), unmonitored {cost['plain']['mean']:.3f} (range "
          f"{cost['plain']['range'][0]:.3f}-{cost['plain']['range'][1]:.3f});"
          f" {checks} checks", flush=True)
    out["cost"] = cost
    del nets

    # (c) a NaN batch: the alarm, one bundle that names the card
    rec = global_recorder()
    old_dir, old_env = rec.dump_dir, os.environ.get(DUMP_DIR_ENV)
    tmp, tmp2 = (tempfile.mkdtemp(prefix="dl4j_flight_") for _ in range(2))
    try:
        os.environ[DUMP_DIR_ENV] = tmp
        rec.set_dump_dir(os.environ[DUMP_DIR_ENV])
        net = base.clone()
        hm = HealthMonitor(cadence=DIAG_CADENCE).attach(net)
        net.set_listeners(NanAlertListener())
        batches = []
        for i in range(DIAG_NAN_STEPS):
            xi = x.copy()
            if i == DIAG_NAN_AT:
                xi[1, 3, 0] = np.nan
            batches.append(DataSet(xi, xi))
        a0 = _series(names.HEALTH_ALARMS_TOTAL)
        net.fit_iterator(ListDataSetIterator(batches),
                         ksteps=KS_TRANSFORMER_K)
        torch.cuda.synchronize()
        hm.poll()
        alarms = _series(names.HEALTH_ALARMS_TOTAL) - a0
        bundles = rec.list_bundles()
        files = sorted(os.listdir(bundles[0]["path"])) if bundles else []
        env = {}
        if bundles:
            with open(os.path.join(bundles[0]["path"],
                                   "environment.json")) as f:
                env = json.load(f)
        cards = [d["name"] for d in env.get("devices", [])]
        alarm = hm.alarm or {}
        print(f"diagnostics (c): NaN features at iteration {DIAG_NAN_AT}: "
              f"alarm {alarm.get('why')} at iteration "
              f"{alarm.get('iteration')}, dl4j_health_alarms_total +"
              f"{alarms:g}; bundles {[b['reason'] for b in bundles]}, files "
              f"{files}, environment's cards {cards}", flush=True)
        if (alarm.get("why") != "nonfinite-grads"
                or not DIAG_NAN_AT < alarm["iteration"]
                <= DIAG_NAN_AT + DIAG_CADENCE or alarms != 1
                or len(bundles) != 1 or set(files) != set(BUNDLE_FILES)
                or torch.cuda.get_device_name(0) not in cards):
            fail("diagnostics: the NaN alarm or its bundle")
        out["nan"] = {"alarm": alarm, "bundles": len(bundles), "files": files,
                      "cards": cards}
        del net

        # (d) the watchdog: one stall, its bundle holds the stalled thread
        rec.set_dump_dir(tmp2)
        net = base.clone()
        net.dispatch_ksteps = KS_TRANSFORMER_K
        net.fit(x, x, epochs=KS_TRANSFORMER_K)  # captures, unwatched
        torch.cuda.synchronize()
        s0 = _series(names.WATCHDOG_STALLS_TOTAL)
        net.set_listeners(_Stall(net.iteration + DIAG_STALL_AT,
                                 DIAG_STALL_S))
        wd = install_watchdog(DIAG_WATCHDOG_S, poll_s=0.05)
        try:
            net.fit(x, x, epochs=n)
        finally:
            uninstall_watchdog()
        stalls = _series(names.WATCHDOG_STALLS_TOTAL) - s0
        bundles = rec.list_bundles()
        threads = ""
        if bundles:
            with open(os.path.join(bundles[0]["path"], "threads.txt")) as f:
                threads = f.read()
        held = "MainThread" in threads and "iteration_done" in threads
        print(f"diagnostics (d): a {DIAG_STALL_S:g} s host stall under a "
              f"{DIAG_WATCHDOG_S:g} s watchdog: {wd.stalls} stall(s), "
              f"dl4j_watchdog_stalls_total +{stalls:g}; bundles "
              f"{[b['reason'] for b in bundles]}; threads.txt holds the "
              f"stalled listener: {held}", flush=True)
        if wd.stalls != 1 or stalls != 1 or len(bundles) != 1 or not held:
            fail("diagnostics: the watchdog's stall")
        out["watchdog"] = {"stalls": wd.stalls, "bundles": len(bundles)}
        del net
    finally:
        rec.set_dump_dir(old_dir)
        if old_env is None:
            os.environ.pop(DUMP_DIR_ENV, None)
        else:
            os.environ[DUMP_DIR_ENV] = old_env
        for d in (tmp, tmp2):
            shutil.rmtree(d, ignore_errors=True)
    del base
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"diagnostics: {out['seconds']:.1f}s", flush=True)
    if out["seconds"] > 60.0:
        fail(f"diagnostics: the phase took {out['seconds']:.1f}s (limit 60)")
    return out


def char_rnn_graph(device):
    """char_rnn_lstm(64)'s layers (2 x GravesLSTM(200), RnnOutput(64),
    mcxent, TBPTT 50, RMSProp 0.95 at RNN_LR, Xavier) built with the
    port's graph builder, on ``device``, from SEED."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as TL

    lstm = dict(activation="tanh", forget_gate_bias_init=1.0,
                gate_activation="sigmoid")
    conf = (NeuralNetConfiguration.builder().seed(SEED)
            .learning_rate(RNN_LR).updater("rmsprop").rms_decay(0.95)
            .weight_init("xavier").graph_builder().add_inputs("in")
            .add_layer("l0", TL.GravesLSTM.conf(n_in=RNN_V, n_out=RNN_H,
                                                **lstm), "in")
            .add_layer("l1", TL.GravesLSTM.conf(n_in=RNN_H, n_out=RNN_H,
                                                **lstm), "l0")
            .add_layer("out", TL.RnnOutputLayer.conf(
                n_in=RNN_H, n_out=RNN_V, loss="mcxent",
                activation="softmax"), "l1")
            .set_outputs("out").backprop_type("TruncatedBPTT")
            .t_bptt_forward_length(RNN_CHUNK).build())
    return ComputationGraph(conf, device=device).init(seed=SEED)


def graph_rnn(kernels) -> dict:
    """char_rnn as a graph: 8 TBPTT chunks on the card against the CPU, a
    64-step rnn_time_step and a 64-step /v1/stream session against the CPU
    rnn_time_step, with exact launches; then chunk timing and one profiled
    batch."""
    from deeplearning4j_tpu_torch.nn.graph_network import MultiDataSet

    net = char_rnn_graph("cuda")
    ref = net.clone(device="cpu")
    rng = np.random.default_rng(SEED + 21)
    batches = [MultiDataSet([b], [b]) for b in (
        _one_hot(rng.integers(0, RNN_V, size=(RNN_B, RNN_T)))
        for _ in range(RNN_BATCHES))]
    n_chunks = RNN_BATCHES * (RNN_T // RNN_CHUNK)
    losses, ref_losses = [], []
    net.set_listeners(_LossLog(losses))
    ref.set_listeners(_LossLog(ref_losses))
    _zero(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for mds in batches:
        net.fit(mds)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _launches(kernels)
    peak = torch.cuda.max_memory_allocated()
    for mds in batches:
        ref.fit(mds)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(f"graph_rnn TBPTT: card chunk losses {losses}; CPU {ref_losses}; "
          f"worst relative difference {max(rel):.3e} (tol 1e-4); {n_chunks} "
          f"chunks in {first_s:.3f}s (first included); launches {launches}",
          flush=True)
    if len(losses) != n_chunks or not all(np.isfinite(losses)) \
            or not max(rel) <= 1e-4:
        fail(f"graph char_rnn chunk losses {losses} disagree with the CPU "
             f"{ref_losses}")
    want = {fn.__name__: 0 for fn in kernels}
    want.update(lstm_fwd=2 * n_chunks, lstm_bwd=2 * n_chunks,
                softmax_cross_entropy=n_chunks)
    if launches != want:
        fail(f"graph char_rnn launch counts {launches} != {want}")

    # rnn_time_step, one step a call, against the CPU forward of the card's
    # own trained weights
    ids = rng.integers(0, RNN_V, size=(1, RNN_STREAM_STEPS))
    xs = _one_hot(ids)
    own = net.clone(device="cpu")
    net.rnn_clear_previous_state()
    _zero(kernels)
    t0 = time.perf_counter()
    outs = [net.rnn_time_step(xs[:, t:t + 1])[0].cpu()
            for t in range(RNN_STREAM_STEPS)]
    step_ms = 1e3 * (time.perf_counter() - t0) / RNN_STREAM_STEPS
    step_launches = _launches(kernels)
    want_out = own.rnn_time_step(xs)[0]
    step_err = float((torch.cat(outs, dim=1) - want_out).abs().max())

    # /v1/stream: the same 64 steps in two requests
    srv = InferenceServer(device="cuda")
    srv.start()
    try:
        srv.register("char_graph", net)
        _zero(kernels)
        souts = []
        t0 = time.perf_counter()
        for part in (xs[:, :32], xs[:, 32:]):
            code, text = post(srv.port, "/v1/stream",
                              {"model": "char_graph", "session": "g1",
                               "inputs": part.tolist()})
            if code != 200:
                fail(f"/v1/stream (graph) returned {code}: {text[:500]}")
            lines = [json.loads(l) for l in text.splitlines() if l.strip()]
            if not lines[-1].get("done") or len(lines) != 33:
                fail(f"/v1/stream (graph) gave {len(lines)} lines, last "
                     f"{lines[-1]}")
            souts += [np.asarray(l["output"], np.float32)[0]
                      for l in lines[:-1]]
        stream_s = time.perf_counter() - t0
        stream_launches = _launches(kernels)
    finally:
        srv.stop()
    stream_err = float(np.abs(np.stack(souts) - want_out.numpy()[0]).max())
    print(f"graph_rnn rnn_time_step: {RNN_STREAM_STEPS} steps, "
          f"{step_ms:.3f} ms a step, max_abs_err {step_err:.3e} (tol 1e-5), "
          f"launches {step_launches}; /v1/stream {RNN_STREAM_STEPS} steps in "
          f"two requests in {stream_s:.3f}s, max_abs_err {stream_err:.3e} "
          f"(tol 1e-5), launches {stream_launches}", flush=True)
    if not step_err <= 1e-5 or not stream_err <= 1e-5:
        fail(f"graph streaming disagrees with the CPU rnn_time_step: "
             f"{step_err}, {stream_err}")
    want_s = {fn.__name__: 0 for fn in kernels}
    want_s["lstm_fwd"] = 2 * RNN_STREAM_STEPS
    if step_launches != want_s or stream_launches != want_s:
        fail(f"graph streaming launches {step_launches}, {stream_launches} "
             f"!= {want_s}")

    # chunk timing and one profiled batch (host clock, synchronized)
    net.set_listeners()
    per_batch = RNN_T // RNN_CHUNK
    net.fit(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        net.fit(batches[0])
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t0) / (3 * per_batch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(batches[0])
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = device_time_by_kernel(prof)
    busy_us = sum(by_kernel.values())
    if busy_us <= 0:
        fail("the profiler saw no device time in the graph char_rnn batch")
    result = {
        "losses": losses, "cpu_losses": ref_losses, "worst_rel_diff": max(rel),
        "launches": launches, "step_launches": step_launches,
        "stream_launches": stream_launches,
        "rnn_time_step_max_abs_err": step_err,
        "rnn_time_step_ms": step_ms, "stream_max_abs_err": stream_err,
        "stream_ms_per_step": 1e3 * stream_s / RNN_STREAM_STEPS,
        "chunk_ms": chunk_ms, "replays": 0,
        "device_us_per_chunk": busy_us / per_batch,
        "device_us_by_kernel": by_kernel,
        "idle_share": 1.0 - busy_us / 1e3 / (chunk_ms * per_batch),
        "idle_share_profiled": 1.0 - busy_us / 1e3 / prof_ms,
        "peak_memory_bytes": peak}
    print(f"graph_rnn chunk: {chunk_ms:.3f} ms wall, device "
          f"{result['device_us_per_chunk']:.1f} us a chunk, idle share "
          f"{result['idle_share']:.3f} ({result['idle_share_profiled']:.3f} "
          f"profiled), peak {peak / 2**30:.3f} GiB, no replays (TBPTT takes "
          f"single steps) [{CARD}]", flush=True)
    return result


#: the dtype phase (the named policies of common.py on both network types):
#: full-depth ResNet-50 under bfloat16_flagship (a 64x64 check as the
#: resnet50 phase's, then 224x224 at B = 128), full-width transformer_lm(256)
#: under bfloat16_full, full-width char_rnn_lstm(64) under bfloat16
FLAGSHIP, FULL_BF16, BF16 = "bfloat16_flagship", "bfloat16_full", "bfloat16"
#: ResNet-50 at 224x224: fit(epochs=DT_RES_EPOCHS) through the K-step path,
#: then DT_RES_TURN_STEPS eager steps a turn, flagship and float32 in turns
#: (flagship, float32, float32, flagship)
DT_RES_EPOCHS, DT_RES_TURN_STEPS, DT_RES_KSTEP_CALLS = 4, 4, 3
#: the bf16 tensor cores' dense peak (NVIDIA H100 SXM data sheet, at 700 W):
#: the figure the flagship step's share is taken of
BF16_OPS_PER_S = 989e12
#: card against CPU under a bf16 policy: the card's distance to the CPU run
#: of the same policy at most a stated part of the CPU run's own distance to
#: its wider counterpart (float32, or float64 for ResNet-50's loss). A path
#: the card ran wholly in float32 lands at about 1 times that distance, so
#: each limit sits between its reading on one H100 (NVIDIA H100 80GB HBM3,
#: 700 W) and 1: the transformer's losses (max over the steps, read 0.044)
#: and params (0.12), char_rnn's chunk losses (0.38) and params (0.047).
#: ResNet-50's loss against float64 is held within DT_MULT, its update by
#: the projection gate below.
DT_MULT = 2.0
DT_LM_LOSS, DT_LM_PARAMS = 0.25, 0.4
DT_RNN_LOSS, DT_RNN_PARAMS = 0.75, 0.25
#: the bf16 /v1/stream of char_rnn: within DT_STREAM of the CPU stream's own
#: bf16-float32 distance (read 1.19: the card's and the CPU's rounding part
#: them as far as bf16 parts the CPU from float32), and off the CPU float32
#: stream by at least DT_ENGAGED of it (a float32 stream on the card sits
#: within float32 rounding of it)
DT_STREAM, DT_ENGAGED = 2.0, 0.5
#: the flagship ResNet-50 update gate adds to the resnet50 phase's leaf
#: gate (the card's update against a float64 step, leaf by leaf, relative
#: to the CPU flagship step's own errors) the projection of the card's whole
#: update on the CPU flagship update from the same state, r = <u, u_cpu> /
#: <u_cpu, u_cpu> over all leaves, at the last step: within DT_PROJ_TOL of
#: 1. The leaf gate alone cannot see a 1% error under bf16. A new
#: ResNet-50's gradient is ill-conditioned (float32 is 1% off float64),
#: and in bf16 the first steps are rounding: measured on one H100, the
#: flagship update's distance to the float64 update was 1.36 of it at the
#: first step, 0.22 at the second and 0.086 at the third, and the card's
#: update projected on the CPU's 0.29, 0.989 and 0.9994. r is taken where the steps carry signal, the last. The control
#: steps from the state a run at RES_CONTROL_LR times the rate would hold
#: (the CPU run's params and BN state, its Nesterov velocity, proportional
#: to the rate, times RES_CONTROL_LR), at that rate: its update is 1.01
#: times the card's, r = 1.01.
DT_PROJ_TOL = 0.003


def _policy_conf(conf, name, lr_factor: float = 1.0):
    """A copy of a config naming the dtype policy ``name``, every learning
    rate times ``lr_factor``."""
    conf = copy.deepcopy(conf)
    conf.global_conf.dtype = name
    if lr_factor != 1.0:
        layers = ([v.layer for v in conf.vertices.values()
                   if hasattr(v, "layer")] if hasattr(conf, "vertices")
                  else conf.layers)
        for lc in layers:
            for k in ("learning_rate", "bias_learning_rate"):
                if lc.fields.get(k) is not None:
                    lc.fields[k] *= lr_factor
    return conf


class _Spy:
    """A kernel wrapper's stand-in that notes each call's operand dtype,
    then calls it; ``launches`` stays the wrapper's own (the wrapper counts
    through its module's name, which is this stand-in while installed)."""

    def __init__(self, name, fn, seen):
        self.name, self.fn, self.seen = name, fn, seen

    def __call__(self, *args, **kwargs):
        per = self.seen.setdefault(self.name, {})
        d = str(args[0].dtype)
        per[d] = per.get(d, 0) + 1
        return self.fn(*args, **kwargs)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n


class DtypeSeen:
    """While installed, records the dtype of the first operand of each call
    of the kernel wrappers the layers reach through their modules (the
    flash kernels, the LSTM kernels, int8_matmul): ``seen[name][dtype]``.
    A replay of a captured step runs no Python and is not seen; its capture
    is."""

    SITES = (("deeplearning4j_tpu_torch.ops.flash_attention",
              ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
             ("deeplearning4j_tpu_torch.ops.lstm", ("lstm_fwd", "lstm_bwd")),
             ("deeplearning4j_tpu_torch.ops.quant", ("int8_matmul",)))

    def __init__(self):
        self.seen: dict = {}
        self._saved = []

    def __enter__(self):
        for mod_name, names in self.SITES:
            mod = sys.modules[mod_name]
            for name in names:
                fn = getattr(mod, name)
                self._saved.append((mod, name, fn))
                setattr(mod, name, self._spy(name, fn))
        return self

    def _spy(self, name, fn):
        return _Spy(name, fn, self.seen)

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []

    def only(self, dtype: str, names) -> None:
        """Fail unless each of ``names`` was called, and only with
        ``dtype`` operands."""
        for name in names:
            got = self.seen.get(name, {})
            if not got or set(got) != {dtype}:
                fail(f"{name} was called with operands {got}, not only "
                     f"{dtype}")


def _tensors_of(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors_of(v)]
    return [tree]


def _all_float32(net) -> bool:
    """Params, layer states and updater state all float32."""
    return all(t.dtype == torch.float32 for t in _tensors_of(
        [net.params_list, net.state_list, net.updater_state]))


def _tree_dist(a, b) -> float:
    """||a - b|| over every leaf of two trees of one structure."""
    return float(sum(float(((x.detach().cpu().double() - y.detach().cpu()
                             .double()) ** 2).sum())
                     for x, y in zip(_tensors_of(a), _tensors_of(b))) ** 0.5)


def _projection(params, ref_params, before) -> tuple:
    """``(r, D)`` over all leaves: the update to ``params`` projected on
    the update to ``ref_params`` (float64 copies: a float64 step's, or
    another run's), ``<u, u_ref> / <u_ref, u_ref>``, and its distance to
    it, ``||u - u_ref|| / ||u_ref||``."""
    dot = nn = dd = 0.0
    for n, leaves in ref_params.items():
        for k, r in leaves.items():
            u64 = r - before[n][k]
            u = params[n][k].detach().to("cpu", torch.float64) - before[n][k]
            dot += float((u * u64).sum())
            nn += float((u64 * u64).sum())
            dd += float(((u - u64) ** 2).sum())
    return dot / nn, (dd / nn) ** 0.5


def _dtype_family(kernel: str, chain: list) -> str:
    """A ResNet step's kernel by family, as ``_resnet_family`` gives it,
    with the convolutions split into the forward and the gradients, and the
    dtype casts (``aten::_to_copy``) apart from the other elementwise
    kernels."""
    fam = _resnet_family(kernel, chain)
    if fam == "convolutions":
        back = any("backward" in c.lower() for c in chain)
        return "convolution gradients" if back else "convolutions forward"
    if fam in ("elementwise, pooling, reductions", "copies") and any(
            "_to_copy" in c for c in chain):
        return "dtype casts"
    return fam


def dtype_resnet_check(kernels) -> dict:
    """Full-depth ResNet-50 under ``bfloat16_flagship`` at 64x64, B = 8, 3
    steps, each card step from the CPU flagship run's state: the loss within
    DT_MULT of the CPU run's own distance to the float64 loss, the update
    leaf by leaf within the resnet50 phase's gate of a float64 step from the
    same point (relative to the CPU flagship step's errors), the update's
    projection on the float64 update within DT_PROJ_TOL of the CPU's, the
    control failing; params, updater state and BN running state float32."""
    ref = ComputationGraph(_policy_conf(resnet50(
        n_classes=RES_CLASSES, image_size=RES_CHECK_SIZE), FLAGSHIP),
        device="cpu").init(seed=SEED)
    lock = ref.clone(device="cuda")
    control = ComputationGraph(_policy_conf(ref.conf, FLAGSHIP,
                                            RES_CONTROL_LR), device="cuda")
    g = torch.Generator().manual_seed(SEED + 60)
    batches = [_res_batch(g, RES_CHECK_B, RES_CHECK_SIZE, RES_CLASSES, "cpu")
               for _ in range(RES_CHECK_STEPS)]

    steps, misses = [], {}
    control_out = None
    launches = {fn.__name__: 0 for fn in kernels}
    for i, (x, y) in enumerate(batches):
        _from_cpu_state(lock, ref)
        before, exact = _f64(ref.params_list), Float64Run(ref)
        loss64 = exact.step(x, y)
        # the card's flagship step alone: the control's launches are not
        # the path's
        for fn in kernels:
            fn.launches = 0
        lock.fit([x], [y])
        for fn in kernels:
            launches[fn.__name__] += fn.launches
        last = i == RES_CHECK_STEPS - 1
        if last:
            _from_cpu_state(control, ref)
            with torch.no_grad():
                for t in _tensors_of(control.updater_state):
                    t.mul_(RES_CONTROL_LR)
            control.fit([x], [y])
        ref.fit([x], [y])
        # r and D of each update against the float64 update, r against the
        # CPU flagship update (the gate)
        card_e = _update_errs(lock.params_list, exact, before)
        cpu_e = _update_errs(ref.params_list, exact, before)
        card_r64, card_d = _projection(lock.params_list, exact.params, before)
        cpu_r64, cpu_d = _projection(ref.params_list, exact.params, before)
        on_cpu = _f64(ref.params_list)
        card_r, card_dc = _projection(lock.params_list, on_cpu, before)
        if last:
            control_e = _update_errs(control.params_list, exact, before)
            control_r, control_dc = _projection(control.params_list, on_cpu,
                                                before)
            control_out = {
                "r": control_r, "D_vs_cpu": control_dc,
                "leaves_outside_gate": len(_gate_misses(control_e, cpu_e))}
        step = {"loss": lock.score_value, "cpu_loss": ref.score_value,
                "float64_loss": loss64,
                "card_e_median": float(np.median(list(card_e.values()))),
                "cpu_e_median": float(np.median(list(cpu_e.values()))),
                "card_e_worst": max(card_e.values()),
                "card_r": card_r, "card_D_vs_cpu": card_dc,
                "card_r64": card_r64, "cpu_r64": cpu_r64, "card_D64": card_d,
                "cpu_D64": cpu_d,
                "leaves_outside_gate": len(_gate_misses(card_e, cpu_e))}
        steps.append(step)
        misses.update({f"step {i + 1} {k}": v
                       for k, v in _gate_misses(card_e, cpu_e).items()})
    f32_ok = _all_float32(lock) and _all_float32(ref)
    print(f"dtype resnet50 ({FLAGSHIP}, {RES_CHECK_SIZE}x{RES_CHECK_SIZE}, "
          f"B={RES_CHECK_B}, each card step from the CPU flagship run's "
          f"state): {steps}; control (rate x{RES_CONTROL_LR}, last step) "
          f"{control_out}; params, updater and BN state float32: {f32_ok}; "
          f"launches {launches} [{CARD}]", flush=True)
    for i, s in enumerate(steps):
        bound_loss = DT_MULT * abs(s["cpu_loss"] - s["float64_loss"])
        if not (np.isfinite(s["loss"])
                and abs(s["loss"] - s["cpu_loss"]) <= bound_loss):
            fail(f"flagship ResNet-50 step {i + 1} loss {s['loss']} against "
                 f"the CPU's {s['cpu_loss']} (float64 {s['float64_loss']})")
    if not abs(steps[-1]["card_r"] - 1.0) <= DT_PROJ_TOL:
        fail(f"flagship ResNet-50 step {len(steps)}: the card's update "
             f"projected on the CPU's is {steps[-1]['card_r']}")
    if misses:
        fail(f"flagship ResNet-50 updates outside the gate: {misses}")
    if not (control_out["leaves_outside_gate"]
            or abs(control_out["r"] - 1.0) > DT_PROJ_TOL):
        fail(f"flagship ResNet-50 control passed the gate: {control_out}")
    if not f32_ok:
        fail("flagship ResNet-50 params, updater or BN state left float32")
    want = {fn.__name__: 0 for fn in kernels}
    want["softmax_cross_entropy"] = RES_CHECK_STEPS
    if launches != want:
        fail(f"flagship ResNet-50 check launches {launches} != {want}")
    return {"steps": steps, "control": control_out, "launches": launches,
            "state_float32": f32_ok}


def _profiled_family(net, x, y) -> tuple:
    """One profiled eager step: ``(wall ms, device µs, µs by family)``."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit([x], [y])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    busy = sum(us for _, _, us in device_events(prof))
    return ms, busy, device_us_by_family(prof, _dtype_family)


def dtype_resnet_bench(kernels) -> dict:
    """Full-depth ResNet-50 at 224x224, B = 128, under
    ``bfloat16_flagship`` beside float32 (the same init): peak memory of
    each, eager steps in turns, ``fit(epochs=4)`` through the K-step path,
    one profiled eager step of each by family, evaluate on 256 images and a
    2-row ``/v1/predict``."""
    flag = ComputationGraph(_policy_conf(resnet50(), FLAGSHIP),
                            device="cuda").init(seed=SEED)
    f32 = ComputationGraph(resnet50(), device="cuda").init(seed=SEED)
    flops = resnet_flops(flag.conf, RES_B)
    x, y = _res_batch(torch.Generator().manual_seed(SEED + 61), RES_B,
                      RES_SIZE, RES_CLASSES, "cuda")
    peak = {}
    for name, net in (("flagship", flag), ("float32", f32)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(RES_WARMUP):
            net.fit([x], [y])
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated()
    turns = {"flagship": [], "float32": []}
    # each network's launches over its own turns alone
    turn_launches = {k: {fn.__name__: 0 for fn in kernels} for k in turns}
    for name in ("flagship", "float32", "float32", "flagship"):
        net = flag if name == "flagship" else f32
        for fn in kernels:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DT_RES_TURN_STEPS):
            net.fit([x], [y])
        torch.cuda.synchronize()
        turns[name].append(1e3 * (time.perf_counter() - t0)
                           / DT_RES_TURN_STEPS)
        for fn in kernels:
            turn_launches[name][fn.__name__] += fn.launches
    eager_launches = turn_launches["flagship"]
    f32_launches = turn_launches["float32"]
    step_ms = {k: float(np.median(v)) for k, v in turns.items()}
    losses = {"flagship": flag.score_value, "float32": f32.score_value}
    # the K-step path: the first call captures the step (an eager warm-up
    # step, then the capture), the next are replays
    for fn in kernels:
        fn.launches = 0
    flag.fit([x], [y], epochs=DT_RES_EPOCHS)
    torch.cuda.synchronize()
    kstep_ms = []
    for _ in range(DT_RES_KSTEP_CALLS):
        t0 = time.perf_counter()
        flag.fit([x], [y], epochs=DT_RES_EPOCHS)
        torch.cuda.synchronize()
        kstep_ms.append(1e3 * (time.perf_counter() - t0) / DT_RES_EPOCHS)
    kstep_launches = {fn.__name__: fn.launches for fn in kernels}
    graphs = len(flag._step_graphs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flag.fit([x], [y], epochs=DT_RES_EPOCHS)
        torch.cuda.synchronize()
        kprof_ms = 1e3 * (time.perf_counter() - t0) / DT_RES_EPOCHS
    kbusy = sum(us for _, _, us in device_events(prof)) / DT_RES_EPOCHS
    kloss = flag.score_value
    fam = {}
    for name, net in (("flagship", flag), ("float32", f32)):
        ms, busy, by = _profiled_family(net, x, y)
        fam[name] = {"profiled_ms": ms, "device_us": busy,
                     "device_us_by_family": by,
                     "idle_share_unprofiled":
                         1.0 - busy / 1e3 / step_ms[name]}
    want = {fn.__name__: 0 for fn in kernels}
    want["softmax_cross_entropy"] = 2 * DT_RES_TURN_STEPS
    if eager_launches != want or f32_launches != want:
        fail(f"ResNet-50 dtype eager launches: flagship {eager_launches}, "
             f"float32 {f32_launches}, each != {want}")
    want["softmax_cross_entropy"] = DT_RES_EPOCHS * (1 + DT_RES_KSTEP_CALLS)
    if kstep_launches != want or graphs != 1:
        fail(f"flagship ResNet-50 K-step launches {kstep_launches} != {want}"
             f" or {graphs} captured graphs")
    if not (np.isfinite(list(losses.values())).all() and np.isfinite(kloss)):
        fail(f"ResNet-50 dtype losses not finite: {losses}, {kloss}")
    if not _all_float32(flag):
        fail("flagship ResNet-50 params, updater or BN state left float32")

    # evaluate, and /v1/predict held to the card's own output: a new network
    # with a batch's own statistics as its running statistics (see resnet)
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    ge = torch.Generator().manual_seed(SEED + 62)
    eval_sets = [DataSet(*(t.numpy() for t in _res_batch(
        ge, RES_B, RES_SIZE, RES_CLASSES, "cpu")))
        for _ in range(RES_EVAL // RES_B)]
    t0 = time.perf_counter()
    ev = flag.evaluate(eval_sets)
    eval_s = time.perf_counter() - t0
    served = ComputationGraph(flag.conf, device="cuda").init(seed=SEED + 1)
    served.load_state(batch_statistics(served, x))
    rows = eval_sets[0].features[:RES_SERVE_ROWS]
    srv = InferenceServer(device="cuda", max_batch=RES_SERVE_ROWS)
    srv.start()
    try:
        srv.register("resnet50_flagship", served)
        status, body = post(srv.port, "/v1/predict",
                            {"model": "resnet50_flagship",
                             "inputs": rows.tolist()})
    finally:
        srv.stop()
    if status != 200:
        fail(f"flagship ResNet-50 /v1/predict returned {status}: {body[:300]}")
    pred = np.asarray(json.loads(body)["predictions"], np.float64)
    own_t = served.output(rows)[0]
    own = own_t.float().cpu().double().numpy()
    # one bf16 ulp of each probability (the output is bf16)
    perr = float((np.abs(pred - own) / np.abs(own).clip(1e-30)).max())
    if own_t.dtype != torch.bfloat16 or pred.shape != (RES_SERVE_ROWS,
                                                        RES_CLASSES) \
            or not perr <= 2.0 ** -7 or ev.num_examples != RES_EVAL:
        fail(f"flagship ResNet-50 serving: output {own_t.dtype}, predict "
             f"{pred.shape}, relative error {perr}, evaluated "
             f"{ev.num_examples}")

    def share(ms):
        return flops / BF16_OPS_PER_S / (ms / 1e3)

    result = {
        "card": CARD, "batch": RES_B, "image_size": RES_SIZE,
        "step_tflop": flops / 1e12, "peak_memory_bytes": peak,
        "eager_step_ms": step_ms, "eager_turn_ms": turns,
        "samples_per_s": {k: RES_B / (v / 1e3) for k, v in step_ms.items()},
        "kstep_step_ms": kstep_ms,
        "kstep_samples_per_s": RES_B / (float(np.median(kstep_ms)) / 1e3),
        "kstep_profiled_step_ms": kprof_ms, "kstep_device_us": kbusy,
        "kstep_idle_share": 1.0 - kbusy / 1e3 / float(np.median(kstep_ms)),
        "bf16_peak_share": {
            "flagship_eager": share(step_ms["flagship"]),
            "flagship_kstep": share(float(np.median(kstep_ms))),
            "float32_eager": share(step_ms["float32"])},
        "by_family": fam, "losses": losses, "kstep_loss": kloss,
        "eager_launches": eager_launches,
        "float32_eager_launches": f32_launches,
        "kstep_launches": kstep_launches, "eval_s": eval_s,
        "predict_rel_err": perr}
    print(f"dtype resnet50 (224x224x3, B={RES_B}): eager step flagship "
          f"{step_ms['flagship']:.3f} ms, float32 {step_ms['float32']:.3f} "
          f"ms (turns {turns}); K-step flagship {kstep_ms} ms a step "
          f"(profiled {kprof_ms:.3f}, device {kbusy:.1f} us a step, idle "
          f"{result['kstep_idle_share']:.3f}); peak memory GiB "
          f"{ {k: round(v / 2**30, 2) for k, v in peak.items()} }; "
          f"{flops / 1e12:.4f} TFLOP a step, share of the bf16 dense peak "
          f"(989 TFLOP/s): {result['bf16_peak_share']}; evaluate 256 in "
          f"{eval_s:.3f}s; /v1/predict relative error {perr:.3e} [{CARD}]",
          flush=True)
    for name, f in fam.items():
        for k, us in sorted(f["device_us_by_family"].items(),
                            key=lambda kv: -kv[1]):
            print(f"  dtype resnet50 {name} step device time {k}: {us:.1f} "
                  f"us ({100 * us / f['device_us']:.1f}%)", flush=True)
    return result


def dtype_transformer(kernels) -> dict:
    """Full-width ``transformer_lm(256)`` under ``bfloat16_full``: 2 steps on
    the card against the CPU from the same weights (the losses within
    DT_LM_LOSS and the params within DT_LM_PARAMS of the CPU run's distance
    to its float32 run), a K-step ``fit``, ``/v1/predict`` (one bf16 ulp
    from ``PredictFn``) and int8 ``/v1/generate``; the flash kernels and
    int8_matmul see bf16 operands."""
    steps, V = 2, TRAIN_V
    conf = _policy_conf(transformer_lm(V), FULL_BF16)
    ids = np.random.default_rng(SEED + 63).integers(0, V, (TRAIN_B, TRAIN_T))
    x = np.eye(V, dtype=np.float32)[ids]
    cpu = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)
    cpu32 = MultiLayerNetwork(transformer_lm(V), device="cpu").init(seed=SEED)
    card = cpu.clone(device="cuda")
    losses, cpu_losses, f32_losses = [], [], []
    with DtypeSeen() as seen:
        for fn in kernels:
            fn.launches = 0
        for _ in range(steps):
            card.fit(x, x)
            losses.append(card.score_value)
        train_launches = {fn.__name__: fn.launches for fn in kernels}
        seen.only("torch.bfloat16", ("flash_fwd", "flash_bwd_dq",
                                     "flash_bwd_dkv"))
        train_seen = copy.deepcopy(seen.seen)
        for _ in range(steps):
            cpu.fit(x, x)
            cpu_losses.append(cpu.score_value)
            cpu32.fit(x, x)
            f32_losses.append(cpu32.score_value)
        seen.seen.clear()
        # the K-step path: dispatch_ksteps steps a group, one capture
        ks = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
        ks.dispatch_ksteps = KS_TRANSFORMER_K
        for fn in kernels:
            fn.launches = 0
        ks.fit(x, x, epochs=KS_TRANSFORMER_STEPS)
        torch.cuda.synchronize()
        ks_launches = {fn.__name__: fn.launches for fn in kernels}
        ks_loss = ks.score_value
        # serving: /v1/predict and int8 /v1/generate (bf16 x into int8_matmul)
        srv = InferenceServer(device="cuda", decode_kv="paged",
                              decode_page_size=16, decode_max_context=256,
                              decode_max_slots=8)
        srv.start()
        seen.seen.clear()
        try:
            srv.register("lm_bf16", card, quant="int8")
            rng = np.random.default_rng(SEED + 64)
            prompts = [rng.integers(0, V, size=16).tolist() for _ in range(4)]
            for fn in kernels:
                fn.launches = 0
            gens = [post(srv.port, "/v1/generate",
                         {"model": "lm_bf16", "prompt": p,
                          "max_new_tokens": 16}) for p in prompts]
            gen_launches = {fn.__name__: fn.launches for fn in kernels}
            # [2, 512] ids, as the serve phase's (a [2, 256] float row of
            # a 256-token vocabulary reads as one-hot rows, as in JAX)
            pids = rng.integers(0, V, size=(2, 512)).astype(np.float32)
            for fn in kernels:
                fn.launches = 0
            status, body = post(srv.port, "/v1/predict",
                                {"model": "lm_bf16", "inputs": pids.tolist()})
            predict_launches = {fn.__name__: fn.launches for fn in kernels}
        finally:
            srv.stop()
        serve_seen = copy.deepcopy(seen.seen)
        if status != 200 or any(c != 200 for c, _ in gens):
            fail(f"bfloat16_full serving: /v1/predict {status} "
                 f"{body[:400]}; /v1/generate {[t[:200] for _, t in gens]}")
        seen.only("torch.bfloat16", ("int8_matmul", "flash_fwd"))
    rel = [abs(a - b) for a, b in zip(losses, cpu_losses)]
    ref = [abs(a - b) for a, b in zip(cpu_losses, f32_losses)]
    d = _tree_dist(card.params_list, cpu.params_list)
    d_ref = _tree_dist(cpu.params_list, cpu32.params_list)
    pred = np.asarray(json.loads(body)["predictions"], np.float64) \
        if status == 200 else None
    own = PredictFn(card, quant="int8", device="cuda")(pids)
    # relative to each probability: one bf16 ulp (the output is bf16)
    own64 = own.float().cpu().double().numpy()
    perr = None if pred is None else float(
        (np.abs(pred - own64) / np.abs(own64).clip(1e-30)).max())
    toks = [[json.loads(l) for l in t.splitlines() if l.strip()][-1]
            .get("tokens") for _, t in gens]
    print(f"dtype transformer ({FULL_BF16}, B={TRAIN_B}, T={TRAIN_T}): card "
          f"losses {losses}, CPU {cpu_losses}, CPU float32 {f32_losses}; "
          f"params card-CPU {d:.4e}, CPU bf16-float32 {d_ref:.4e}; K-step "
          f"fit({KS_TRANSFORMER_STEPS}) at {KS_TRANSFORMER_K} loss {ks_loss}"
          f" launches {ks_launches}; train launches {train_launches}; "
          f"generate launches {gen_launches}, predict {predict_launches}, "
          f"predict relative error {perr} against PredictFn; operand dtypes "
          f"train {train_seen}, serve {serve_seen} [{CARD}]", flush=True)
    if not all(np.isfinite(losses)) or not max(rel) <= DT_LM_LOSS * max(ref) \
            or not d <= DT_LM_PARAMS * d_ref:
        fail(f"bfloat16_full transformer on the card disagrees with the CPU: "
             f"losses {max(rel)} against {DT_LM_LOSS} x {max(ref)}, params "
             f"{d} against {DT_LM_PARAMS} x {d_ref}")
    want = {"softmax_cross_entropy": steps, "flash_fwd": 4 * steps,
            "flash_bwd_dq": 4 * steps, "flash_bwd_dkv": 4 * steps,
            "int8_matmul": 0, "paged_gather": 0, "lstm_fwd": 0,
            "lstm_bwd": 0}
    want_ks = {k: v // steps * KS_TRANSFORMER_STEPS for k, v in want.items()}
    if train_launches != want or ks_launches != want_ks \
            or not np.isfinite(ks_loss):
        fail(f"bfloat16_full transformer launches {train_launches} != {want}"
             f" or K-step {ks_launches} != {want_ks}")
    if status != 200 or pred.shape != (2, 512, V) or not perr <= 2.0 ** -7 \
            or own.dtype != torch.bfloat16:
        fail(f"bfloat16_full /v1/predict: {status}, relative error {perr}, "
             f"output {own.dtype}")
    if any(c != 200 for c, _ in gens) or any(
            t is None or len(t) != 16 or not all(0 <= k < V for k in t)
            for t in toks) or gen_launches["int8_matmul"] <= 0 \
            or gen_launches["paged_gather"] <= 0:
        fail(f"bfloat16_full int8 /v1/generate: {[c for c, _ in gens]}, "
             f"launches {gen_launches}")
    return {"losses": losses, "cpu_losses": cpu_losses,
            "cpu_float32_losses": f32_losses, "params_card_cpu": d,
            "params_cpu_bf16_f32": d_ref, "train_launches": train_launches,
            "kstep_launches": ks_launches, "generate_launches": gen_launches,
            "predict_launches": predict_launches, "predict_rel_err": perr,
            "operand_dtypes_train": train_seen,
            "operand_dtypes_serve": serve_seen}


def dtype_rnn(kernels) -> dict:
    """Full-width ``char_rnn_lstm(64)`` under ``bfloat16``: TBPTT over 8
    chunks of [32, 50, 64] on the card against the CPU (the chunk losses
    within DT_RNN_LOSS and the params within DT_RNN_PARAMS of the CPU run's
    distance to its float32 run), decode (8 ``/v1/generate`` sessions) and a
    64-step ``/v1/stream`` against the CPU ``rnn_time_step`` of the same
    policy (DT_STREAM, DT_ENGAGED); the LSTM kernels see bf16 operands."""
    base = char_rnn_lstm(RNN_V, hidden=RNN_H, layers=2, tbptt_length=RNN_CHUNK,
                         learning_rate=RNN_LR)
    conf = _policy_conf(base, BF16)
    rng = np.random.default_rng(SEED + 65)
    batches = [_one_hot(rng.integers(0, RNN_V, size=(RNN_B, RNN_T)))
               for _ in range(RNN_BATCHES)]
    cpu = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)
    cpu32 = MultiLayerNetwork(base, device="cpu").init(seed=SEED)
    card = cpu.clone(device="cuda")
    losses, cpu_losses, f32_losses = [], [], []
    card.set_listeners(_LossLog(losses))
    cpu.set_listeners(_LossLog(cpu_losses))
    cpu32.set_listeners(_LossLog(f32_losses))
    with DtypeSeen() as seen:
        for fn in kernels:
            fn.launches = 0
        for xb in batches:
            card.fit(xb, xb)
        torch.cuda.synchronize()
        train_launches = {fn.__name__: fn.launches for fn in kernels}
        seen.only("torch.bfloat16", ("lstm_fwd", "lstm_bwd"))
        train_seen = copy.deepcopy(seen.seen)
        for xb in batches:
            cpu.fit(xb, xb)
            cpu32.fit(xb, xb)
        served = cpu.clone(device="cuda")
        served.set_listeners()
        srv = InferenceServer(device="cuda", decode_max_slots=RNN_DECODE_B)
        srv.start()
        seen.seen.clear()
        prompts = [rng.integers(0, RNN_V, size=16).tolist() for _ in range(8)]
        stream_ids = rng.integers(0, RNN_V, size=(1, RNN_STREAM_STEPS))
        try:
            srv.register("char_bf16", served)
            for fn in kernels:
                fn.launches = 0
            results = [None] * len(prompts)

            def gen(j):
                results[j] = post(srv.port, "/v1/generate",
                                  {"model": "char_bf16", "prompt": prompts[j],
                                   "max_new_tokens": 16})
            threads = [threading.Thread(target=gen, args=(j,))
                       for j in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            decode_launches = {fn.__name__: fn.launches for fn in kernels}
            for fn in kernels:
                fn.launches = 0
            code, text = post(srv.port, "/v1/stream",
                              {"model": "char_bf16", "session": "s",
                               "inputs": _one_hot(stream_ids).tolist()})
            stream_launches = {fn.__name__: fn.launches for fn in kernels}
        finally:
            srv.stop()
        serve_seen = copy.deepcopy(seen.seen)
        seen.only("torch.bfloat16", ("lstm_fwd",))
    if code != 200:
        fail(f"bfloat16 char_rnn /v1/stream returned {code}: {text[:300]}")
    lines = [json.loads(l) for l in text.splitlines() if l.strip()]
    outs = np.stack([np.asarray(l["output"], np.float32)[0]
                     for l in lines[:-1]])
    # the CPU references step one timestep a call, as the server streams
    ref_net = cpu.clone(device="cpu")
    ref32 = cpu32.clone(device="cpu")
    ref32.load_params(convert.to_numpy(cpu.params_list))
    oh = _one_hot(stream_ids)
    want_out, out32 = (np.concatenate([
        net.rnn_time_step(oh[:, t:t + 1]).numpy()[0]
        for t in range(RNN_STREAM_STEPS)]) for net in (ref_net, ref32))
    stream_err = float(np.abs(outs - want_out).max())
    stream_ref = float(np.abs(want_out - out32).max())
    stream_off32 = float(np.abs(outs - out32).max())
    rel = [abs(a - b) for a, b in zip(losses, cpu_losses)]
    ref = [abs(a - b) for a, b in zip(cpu_losses, f32_losses)]
    d = _tree_dist(card.params_list, cpu.params_list)
    d_ref = _tree_dist(cpu.params_list, cpu32.params_list)
    toks = [[json.loads(l) for l in t.splitlines() if l.strip()][-1]
            .get("tokens") for _, t in results]
    n_chunks = RNN_BATCHES * (RNN_T // RNN_CHUNK)
    print(f"dtype char_rnn ({BF16}): card chunk losses {losses}; CPU "
          f"{cpu_losses}; CPU float32 {f32_losses}; params card-CPU {d:.4e},"
          f" CPU bf16-float32 {d_ref:.4e}; /v1/stream {RNN_STREAM_STEPS} "
          f"steps max_abs_err {stream_err:.3e} against the CPU (its own "
          f"bf16-float32 distance {stream_ref:.3e}; the card's distance to "
          f"the CPU float32 stream {stream_off32:.3e}); launches train "
          f"{train_launches}, decode {decode_launches}, stream "
          f"{stream_launches}; operand dtypes train {train_seen}, serve "
          f"{serve_seen} [{CARD}]", flush=True)
    if len(losses) != n_chunks or not all(np.isfinite(losses)) \
            or not max(rel) <= DT_RNN_LOSS * max(ref) \
            or not d <= DT_RNN_PARAMS * d_ref:
        fail(f"bfloat16 char_rnn on the card disagrees with the CPU: losses "
             f"{max(rel)} against {DT_RNN_LOSS} x {max(ref)}, params {d} "
             f"against {DT_RNN_PARAMS} x {d_ref}")
    if not (stream_err <= DT_STREAM * stream_ref
            and stream_off32 >= DT_ENGAGED * stream_ref):
        fail(f"bfloat16 /v1/stream: {stream_err} from the CPU stream (limit "
             f"{DT_STREAM} x {stream_ref}), {stream_off32} from the CPU "
             f"float32 stream (floor {DT_ENGAGED} x {stream_ref})")
    want = {fn.__name__: 0 for fn in kernels}
    want.update(lstm_fwd=2 * n_chunks, lstm_bwd=2 * n_chunks,
                softmax_cross_entropy=n_chunks)
    want_s = {fn.__name__: 0 for fn in kernels}
    want_s["lstm_fwd"] = 2 * RNN_STREAM_STEPS
    if train_launches != want or stream_launches != want_s \
            or decode_launches["lstm_fwd"] <= 0:
        fail(f"bfloat16 char_rnn launches {train_launches} != {want}, "
             f"stream {stream_launches} != {want_s}, decode "
             f"{decode_launches}")
    if any(c != 200 for c, _ in results) or any(
            t is None or len(t) != 16 for t in toks):
        fail(f"bfloat16 char_rnn /v1/generate: {[c for c, _ in results]}")
    return {"losses": losses, "cpu_losses": cpu_losses,
            "cpu_float32_losses": f32_losses, "params_card_cpu": d,
            "params_cpu_bf16_f32": d_ref, "stream_max_abs_err": stream_err,
            "stream_cpu_bf16_f32": stream_ref,
            "stream_card_cpu_float32": stream_off32,
            "train_launches": train_launches,
            "decode_launches": decode_launches,
            "stream_launches": stream_launches,
            "operand_dtypes_train": train_seen,
            "operand_dtypes_serve": serve_seen}


def dtype_phase(kernels) -> dict:
    """The three paths of the dtype phase, in order."""
    return {"resnet50_check": dtype_resnet_check(kernels),
            "resnet50": dtype_resnet_bench(kernels),
            "transformer": dtype_transformer(kernels),
            "char_rnn": dtype_rnn(kernels)}


def lstm_work_bf16(T, B, F, H):
    """(bytes, operations) of lstm_fwd and of lstm_bwd with bf16 operands:
    as :func:`lstm_work`, every bf16 tensor at 2 bytes an element; the
    backward's dW, db, dpeep, dh0 and dc0 are float32."""
    K = F + H
    w = K * 4 * H + 4 * H + 3 * H
    fwd_b = 2 * (T * B * F + T * B + 4 * B * H + 2 * T * B * H + w)
    bwd_b = (2 * (T * B * (F + 3 * H) + T * B + 2 * B * H + w + T * B * F)
             + 4 * (w + 2 * B * H))
    _, fwd_o, _, bwd_o = lstm_work(T, B, F, H)
    return fwd_b, fwd_o, bwd_b, bwd_o


def check_bf16(rows: list, dev) -> None:
    """The kernels the bf16 policies put on a path, with bf16 operands at
    that path's shapes, each against its plain version on the same inputs:
    the flash kernels at the transformer's training shape (B 16, T 256, 4
    heads of 64, causal), ``int8_matmul`` at the decode step's widest matmul
    (M 8, K 256, N 1024) and the LSTM kernels at char_rnn's two TBPTT
    chunks. Bounds at bf16 bytes and the bf16 dense peak; the library calls
    in bf16 too (``scaled_dot_product_attention``, a bf16 matmul against the
    dequantized weights, cuDNN's LSTM)."""
    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    B, T, H, D = TRAIN_B, TRAIN_T, 4, 64
    q, k, v, do = (torch.randn(B, T, H, D, generator=g).to(dev).to(bf)
                   for _ in range(4))
    out, lse = flash_fwd(q, k, v, True)
    ro, rl = flash_fwd_plain(q, k, v, True)
    err = max(float((out.float() - ro.float()).abs().max()),
              float((lse - rl).abs().max()))
    pairs = B * H * T * (T + 1) / 2
    row_b, stats = 2 * B * T * H * D, 4 * B * H * T
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    shape = {"B": B, "T": T, "H": H, "D": D, "causal": True,
             "dtype": str(bf)}

    def fkernel():
        return flash_fwd(q, k, v, True)

    def flib():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def bf16_bound(nbytes, ops):
        return dict(zip(("bound_ms", "bound_by"),
                        bound(nbytes, ops, BF16_OPS_PER_S)))

    row = report(rows, "flash_fwd", shape, err, 2e-2,
                 time_ms(fkernel, iters=20),
                 time_ms(lambda: flash_fwd_plain(q, k, v, True), iters=20),
                 time_ms(flib, iters=20), 4 * row_b + stats, 4 * D * pairs,
                 {"card": CARD, **bf16_bound(4 * row_b + stats,
                                             4 * D * pairs)})
    DEVICE_TIMED.append((row, fkernel, flib))
    delta = bwd_delta(out, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, True)
    rq = flash_bwd_dq_plain(q, k, v, do, lse, delta, True)
    rk, rv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, True)
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()

    def blib():
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

    lib_ms = time_ms(blib, iters=20)
    for name, e, nbytes, ops, kernel, plain in (
            ("flash_bwd_dq", float((dq.float() - rq.float()).abs().max()),
             5 * row_b + 2 * stats, 6 * D * pairs,
             lambda: flash_bwd_dq(q, k, v, do, lse, delta, True),
             lambda: flash_bwd_dq_plain(q, k, v, do, lse, delta, True)),
            ("flash_bwd_dkv", max(float((dk.float() - rk.float()).abs().max()),
                                  float((dv.float() - rv.float()).abs().max())),
             6 * row_b + 2 * stats, 8 * D * pairs,
             lambda: flash_bwd_dkv(q, k, v, do, lse, delta, True),
             lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta, True))):
        row = report(rows, name, shape, e, 3.2e-2, time_ms(kernel, iters=20),
                     time_ms(plain, iters=20), lib_ms, nbytes, ops,
                     {"card": CARD, **bf16_bound(nbytes, ops)})
        DEVICE_TIMED.append((row, kernel, blib))

    M, K, N = 8, 256, 1024
    x = torch.randn(M, K, generator=g).to(dev).to(bf)
    leaf = quantize_per_channel((torch.randn(K, N, generator=g) * 0.05)
                                .to(dev))
    wd = dequantize_leaf(leaf).to(bf)
    err = float((int8_matmul(x, leaf.q, leaf.scale)
                 - int8_matmul_plain(x, leaf.q, leaf.scale)).abs().max())

    def ikernel():
        return int8_matmul(x, leaf.q, leaf.scale)

    def ilib():
        return torch.matmul(x, wd)

    nbytes, ops = 2 * M * K + K * N + 4 * N + 4 * M * N, 2 * M * K * N
    row = report(rows, "int8_matmul", {"M": M, "K": K, "N": N,
                                       "dtype": str(bf)}, err, 1e-4,
                 time_ms(ikernel),
                 time_ms(lambda: int8_matmul_plain(x, leaf.q, leaf.scale)),
                 time_ms(ilib), nbytes, ops,
                 {"card": CARD, **bf16_bound(nbytes, ops)})
    DEVICE_TIMED.append((row, ikernel, ilib))

    for F_ in (RNN_V, RNN_H):
        Tc, Bc, Hc = RNN_CHUNK, RNN_B, RNN_H
        a = {kk: None if t is None else t.to(bf) for kk, t in
             _lstm_args(dev, g, Tc, Bc, F_, Hc, True, F_ == RNN_H).items()}
        fo = lstm_ops.lstm_fwd(**a)
        fr = lstm_ops.lstm_fwd_plain(**a)
        # each bf16 output within one bf16 ulp of the plain version's plus
        # the float32 tolerance (2e-5)
        fexcess = max(float(((o.float() - r.float()).abs()
                             - 2.0 ** -7 * r.float().abs() - 2e-5).max())
                      for o, r in zip(fo, fr))
        ferr = max(float((o.float() - r.float()).abs().max())
                   for o, r in zip(fo, fr))
        ftol = 2e-5 + 2.0 ** -7 * max(float(r.float().abs().max())
                                      for r in fr)
        ys, cs = fr[0], fr[1]
        dys, dht, dct = (torch.randn(*s, generator=g).to(dev).to(bf)
                         for s in ((Tc, Bc, Hc), (Bc, Hc), (Bc, Hc)))
        ba = dict(x_t=a["x_t"], hprev=torch.cat([a["h0"][None], ys[:-1]]),
                  cprev=torch.cat([a["c0"][None], cs[:-1]]), wcat=a["wcat"],
                  b=a["b"], peep=a["peep"], dys=dys, dht=dht, dct=dct,
                  m_t=a["m_t"])
        bo = lstm_ops.lstm_bwd(**ba)
        br = lstm_ops.lstm_bwd_plain(**ba)
        # dx (bf16): one ulp beside the float32 bound; the float32 outputs:
        # 1e-4 of their largest entry plus 1e-5
        bexcess = max(float(((o.float() - r.float()).abs()
                             - (2.0 ** -7 * r.float().abs() if i == 0 else 0)
                             - (1e-5 + 1e-4 * float(r.float().abs().max())))
                            .max()) for i, (o, r) in enumerate(zip(bo, br)))
        berr = float((bo[0].float() - br[0].float()).abs().max())
        btol = 1e-5 + (2.0 ** -7 + 1e-4) * float(br[0].float().abs().max())
        if fexcess > 0 or bexcess > 0:
            fail(f"lstm bf16 T={Tc} F={F_}: an output past its bound "
                 f"(forward {fexcess}, backward {bexcess})")
        if bo[0].dtype != bf or any(t.dtype != torch.float32 for t in bo[1:]):
            fail(f"lstm_bwd bf16 output dtypes {[t.dtype for t in bo]}")
        fb, fops, bb, bops = lstm_work_bf16(Tc, Bc, F_, Hc)
        shape = {"T": Tc, "B": Bc, "F": F_, "H": Hc, "peephole": True,
                 "masked": F_ == RNN_H, "dtype": str(bf)}
        mod = torch.nn.LSTM(F_, Hc).to(dev).to(bf)
        xl = torch.randn(Tc, Bc, F_, device=dev, dtype=bf, requires_grad=True)
        h0 = torch.zeros(1, Bc, Hc, device=dev, dtype=bf)

        def lib_f():
            with torch.no_grad():
                return mod(xl, (h0, h0))

        def lib_fb():
            yl, _ = mod(xl, (h0, h0))
            return torch.autograd.grad(yl.float().sum(),
                                       [xl] + list(mod.parameters()))

        def fk(a=a):
            return lstm_ops.lstm_fwd(**a)

        def bk(ba=ba):
            return lstm_ops.lstm_bwd(**ba)

        row = report(rows, "lstm_fwd", shape, ferr, ftol,
                     time_ms(fk, iters=20),
                     time_ms(lambda: lstm_ops.lstm_fwd_plain(**a), iters=5),
                     time_ms(lib_f, iters=20), fb, fops,
                     {"card": CARD, **bf16_bound(fb, fops)})
        DEVICE_TIMED.append((row, fk, lib_f))
        row = report(rows, "lstm_bwd", shape, berr, btol,
                     time_ms(bk, iters=20),
                     time_ms(lambda: lstm_ops.lstm_bwd_plain(**ba), iters=5),
                     time_ms(lib_fb, iters=20), bb, bops,
                     {"card": CARD, **bf16_bound(bb, bops)})
        DEVICE_TIMED.append((row, bk, lib_fb))


#: the files phase: model zips written, restored and served. LeNet's early
#: stopping (B = 128, synthetic digits: epochs of FILES_ES_BATCHES batches,
#: 512 held-out digits, at most 4 epochs), ResNet-50's resume at 64x64,
#: B = 8, the transformer served from a file, LBFGS on LeNet
FILES_ES_BATCHES, FILES_ES_HELD, FILES_ES_EPOCHS = 20, 512, 4
FILES_SERVE_MAX_BATCH, FILES_PROBE = 32, 64
FILES_RES_SIZE, FILES_RES_B = 64, 8
FILES_LBFGS_ITERS = 10


def _tree_equal(a, b) -> bool:
    """Whether two trees of tensors (params, states or updater state) have
    the same leaves bitwise."""
    from deeplearning4j_tpu_torch.utils.pytree import leaves_with_paths
    la, lb = list(leaves_with_paths(a)), list(leaves_with_paths(b))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))


def files_lenet(kernels, tmp: str) -> dict:
    """(a) Early stopping of full-width LeNet with a file saver and three
    listeners, the best epoch's zip restored on the card and on the CPU,
    then loaded into a warming ``InferenceServer`` and served."""
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CheckpointListener, CollectScoresIterationListener,
        ScoreIterationListener)
    from deeplearning4j_tpu_torch.utils.model_serializer import guess_model

    net = MultiLayerNetwork(lenet_mnist(), device="cuda").init(seed=SEED)
    train = MnistDataSetIterator(LENET_B,
                                 num_examples=LENET_B * FILES_ES_BATCHES)
    held = MnistDataSetIterator(LENET_B, train=False, shuffle=False,
                                num_examples=FILES_ES_HELD)
    probe = held.features[:FILES_PROBE]
    ckpt_dir = os.path.join(tmp, "lenet_checkpoints")
    collect = CollectScoresIterationListener()
    net.set_listeners(ScoreIterationListener(5), collect,
                      CheckpointListener(ckpt_dir, every_n_iterations=10))
    outputs = {}

    class AtEpoch(es.EarlyStoppingListener):
        def on_epoch(self, epoch, score, config, model):
            outputs[epoch] = model.output(probe).cpu()

    saver = es.LocalFileModelSaver(os.path.join(tmp, "lenet_best"),
                                   device="cuda")
    cfg = (es.EarlyStoppingConfiguration.builder()
           .epoch_termination_conditions(
               es.MaxEpochsTerminationCondition(FILES_ES_EPOCHS),
               es.ScoreImprovementEpochTerminationCondition(2))
           .score_calculator(es.DataSetLossCalculator(held))
           .model_saver(saver).build())
    _zero(kernels)
    t0 = time.perf_counter()
    result = es.EarlyStoppingTrainer(cfg, net, train, AtEpoch()).fit()
    torch.cuda.synchronize()
    es_s = time.perf_counter() - t0
    launches = _launches(kernels)
    scored = len(result.score_vs_epoch)
    held_batches = FILES_ES_HELD // LENET_B
    print(f"files lenet: early stopping {result.termination_reason.value} "
          f"({result.termination_details}) after {result.total_epochs} "
          f"epochs, best epoch {result.best_model_epoch} score "
          f"{result.best_model_score:.6f}; held-out scores "
          f"{[round(result.score_vs_epoch[e], 6) for e in sorted(result.score_vs_epoch)]}"
          f"; {net.iteration} steps in {es_s:.3f}s; collected "
          f"{len(collect.scores)} scores; checkpoints "
          f"{sorted(os.listdir(ckpt_dir))}; launches {launches}", flush=True)
    if result.termination_reason is es.TerminationReason.ERROR:
        fail(f"early stopping ended in an error: {result.termination_details}")
    if result.best_model_epoch < 0 or not all(
            np.isfinite(list(result.score_vs_epoch.values()))):
        fail(f"early stopping kept no best model: {result}")
    if [i for i, _ in collect.scores] != list(range(1, net.iteration + 1)):
        fail("CollectScoresIterationListener missed iterations")
    # sm_xent: one launch a train step, and one a held-out batch of each
    # scored epoch (score() computes the same fused loss)
    want = {fn.__name__: 0 for fn in kernels}
    want["softmax_cross_entropy"] = net.iteration + scored * held_batches
    if launches != want:
        fail(f"early-stopping launch counts {launches} != expected {want}")
    if net.iteration != result.total_epochs * FILES_ES_BATCHES:
        fail(f"{net.iteration} steps for {result.total_epochs} epochs")

    # the best epoch's zip, on the card (the saver's device) and on the CPU
    best_path = os.path.join(saver.directory, saver.BEST)
    ref = outputs[result.best_model_epoch]
    t0 = time.perf_counter()
    best = saver.get_best_model()
    restore_s = time.perf_counter() - t0
    best_cpu = guess_model(best_path, device="cpu")
    card_err = float((best.output(probe).cpu() - ref).abs().max())
    cpu_err = float((best_cpu.output(probe) - ref).abs().max())
    print(f"files lenet: best zip {os.path.getsize(best_path) / 1e6:.3f} MB "
          f"restored on the card in {restore_s:.3f}s; output against the "
          f"in-memory network at epoch {result.best_model_epoch}: card "
          f"max_abs_err {card_err:.3e}, CPU {cpu_err:.3e} (tol 1e-4)",
          flush=True)
    if not (card_err <= 1e-4 and cpu_err <= 1e-4):
        fail(f"the best LeNet zip restores to other outputs: card {card_err}"
             f", CPU {cpu_err}")

    # load into a warming server, then /v1/predict of 64 rows as two
    # requests of max_batch rows
    srv = InferenceServer(device="cuda", warmup=True,
                          max_batch=FILES_SERVE_MAX_BATCH).start()
    try:
        t0 = time.perf_counter()
        mv = srv.load("lenet", best_path,
                      warmup_example=np.zeros((1, 784), np.float32))
        load_s = time.perf_counter() - t0
        warmup_s = srv.registry.last_warmup_s
        warmed = sorted(mv.predict_fn.warmed)
        answers = [None, None]

        def ask(j):
            rows = probe[j * FILES_SERVE_MAX_BATCH:
                         (j + 1) * FILES_SERVE_MAX_BATCH]
            answers[j] = post(srv.port, "/v1/predict",
                              {"model": "lenet", "inputs": rows.tolist()})

        threads = [threading.Thread(target=ask, args=(j,)) for j in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        srv.stop()
    for code, body in answers:
        if code != 200:
            fail(f"LeNet /v1/predict from the file returned {code}: "
                 f"{body[:300]}")
    pred = np.concatenate([np.asarray(json.loads(b)["predictions"],
                                      np.float32) for _, b in answers])
    perr = float(np.abs(pred - best_cpu.output(probe).numpy()).max())
    print(f"files lenet: load + warmup in {load_s:.3f}s (warmup "
          f"{warmup_s:.3f}s over buckets {warmed}); /v1/predict of "
          f"{FILES_PROBE} rows max_abs_err {perr:.3e} against the restored "
          f"CPU output (tol 1e-4)", flush=True)
    if warmed != [1, 2, 4, 8, 16, 32]:
        fail(f"warmup ran buckets {warmed}, not 1..32")
    if pred.shape != (FILES_PROBE, 10) or not perr <= 1e-4:
        fail(f"LeNet served from its file disagrees: {perr}")
    return {"launches": launches, "termination": result.termination_details,
            "epochs": result.total_epochs,
            "best_epoch": result.best_model_epoch,
            "scores": {str(k): v for k, v in result.score_vs_epoch.items()},
            "steps": net.iteration, "early_stopping_s": es_s,
            "restore_s": restore_s, "restore_card_err": card_err,
            "restore_cpu_err": cpu_err, "load_s": load_s,
            "warmup_s": warmup_s, "warmed": warmed, "predict_err": perr}


def files_resnet(kernels, tmp: str) -> dict:
    """(b) Full-depth ResNet-50 at 64x64: a zip with the updater state after
    2 steps, restored on the card, then 2 more steps from the file and from
    the original, bitwise equal with cuDNN deterministic; the zip served."""
    from deeplearning4j_tpu_torch.utils.model_serializer import (
        guess_model, write_model)

    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        g = torch.Generator().manual_seed(SEED + 71)
        batches = [_res_batch(g, FILES_RES_B, FILES_RES_SIZE, RES_CLASSES,
                              "cuda") for _ in range(4)]
        net = ComputationGraph(resnet50(n_classes=RES_CLASSES,
                                        image_size=FILES_RES_SIZE),
                               device="cuda").init(seed=SEED)
        _zero(kernels)
        for x, y in batches[:2]:
            net.fit([x], [y])
        path = os.path.join(tmp, "resnet50.zip")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write_model(net, path)
        write_s = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        back = guess_model(path, device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same_leaves = all(_tree_equal(a, b) for a, b in (
            (back.params_list, net.params_list),
            (back.state_list, net.state_list),
            (back.updater_state, net.updater_state)))
        x0 = batches[0][0]
        out_equal = torch.equal(back.output(x0)[0], net.output(x0)[0])
        losses, back_losses = [], []
        for x, y in batches[2:]:
            net.fit([x], [y])
            back.fit([x], [y])
            losses.append(net.score_value)
            back_losses.append(back.score_value)
        resumed = (losses == back_losses and back.iteration == net.iteration
                   and all(_tree_equal(a, b) for a, b in (
                       (back.params_list, net.params_list),
                       (back.state_list, net.state_list),
                       (back.updater_state, net.updater_state))))
        launches = _launches(kernels)
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = prev
    print(f"files resnet50: zip of {net.num_params()} params with momentum "
          f"{mb:.1f} MB written in {write_s:.3f}s, restored on the card in "
          f"{restore_s:.3f}s; leaves bitwise {same_leaves}; eval output "
          f"bitwise {out_equal}; 2 more steps from the file and from the "
          f"original: losses {back_losses} / {losses}, leaves bitwise "
          f"{resumed}; launches {launches}", flush=True)
    if not (same_leaves and out_equal and resumed):
        fail("ResNet-50 does not resume bitwise from its zip")
    want = {fn.__name__: 0 for fn in kernels}
    want["softmax_cross_entropy"] = 6  # 4 steps of net, 2 of back
    if launches != want:
        fail(f"ResNet-50 resume launch counts {launches} != expected {want}")
    # served from the file through registry.load, warmed with an NHWC row
    srv = InferenceServer(device="cuda", warmup=True, max_batch=2).start()
    try:
        mv = srv.load("resnet50", path, warmup_example=np.zeros(
            (1, FILES_RES_SIZE, FILES_RES_SIZE, 3), np.float32))
        rows = batches[3][0][:2].cpu().numpy()
        code, body = post(srv.port, "/v1/predict",
                          {"model": "resnet50", "inputs": rows.tolist()})
        warmed = sorted(mv.predict_fn.warmed)
    finally:
        srv.stop()
    if code != 200:
        fail(f"ResNet-50 /v1/predict from the file returned {code}: "
             f"{body[:300]}")
    pred = np.asarray(json.loads(body)["predictions"], np.float32)
    # held to the card's output of the served network (the zip's weights;
    # back has trained on since)
    perr = float(np.abs(pred - mv.net.output(rows)[0].cpu().numpy()).max())
    print(f"files resnet50: served from the zip (warmed buckets {warmed}); "
          f"/v1/predict of 2 rows max_abs_err {perr:.3e} against the card's "
          f"output of the zip's network (tol 1e-4)", flush=True)
    if warmed != [1, 2] or pred.shape != (2, RES_CLASSES) or not perr <= 1e-4:
        fail(f"ResNet-50 served from its file disagrees: {perr}, {warmed}")
    return {"launches": launches, "zip_mb": mb, "write_s": write_s,
            "restore_s": restore_s, "losses": losses, "predict_err": perr}


def _generate(port: int, model: str, prompts: list) -> list:
    results = [None] * len(prompts)

    def gen(j):
        results[j] = post(port, "/v1/generate",
                          {"model": model, "prompt": prompts[j],
                           "max_new_tokens": 32})

    threads = [threading.Thread(target=gen, args=(j,))
               for j in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tokens = []
    for code, text in results:
        if code != 200:
            fail(f"/v1/generate of {model} returned {code}: {text[:300]}")
        done = json.loads(text.splitlines()[-1])
        if not done.get("done") or len(done["tokens"]) != 32:
            fail(f"/v1/generate of {model} ended with {done}")
        tokens.append(done["tokens"])
    return tokens


def files_transformer(kernels, tmp: str) -> dict:
    """(c) Full-width transformer_lm(256): 2 train steps, a zip, then the
    phase-4 traffic (8 concurrent /v1/generate, one /v1/predict of [2, 512]
    ids) over the in-memory network and over the file, both int8."""
    from deeplearning4j_tpu_torch.utils.model_serializer import write_model

    V = 256
    net = MultiLayerNetwork(transformer_lm(V), device="cuda").init(seed=SEED)
    rng = np.random.default_rng(SEED + 81)
    for _ in range(2):
        x = np.eye(V, dtype=np.float32)[rng.integers(0, V, (TRAIN_B, TRAIN_T))]
        net.fit(x, x)
    path = os.path.join(tmp, "transformer.zip")
    write_model(net, path)
    prompts = [rng.integers(0, V, size=int(rng.integers(16, 65))).tolist()
               for _ in range(8)]
    ids = rng.integers(0, V, size=(2, 512)).astype(np.float32)
    srv = InferenceServer(device="cuda", decode_kv="paged",
                          decode_page_size=16, decode_max_context=512,
                          decode_max_slots=16).start()
    runs = {}
    try:
        srv.register("memory", net, quant="int8")
        srv.load("file", path, quant="int8")
        for name in ("memory", "file"):
            _zero(kernels)
            t0 = time.perf_counter()
            tokens = _generate(srv.port, name, prompts)
            code, body = post(srv.port, "/v1/predict",
                              {"model": name, "inputs": ids.tolist()})
            seconds = time.perf_counter() - t0
            if code != 200:
                fail(f"/v1/predict of {name} returned {code}: {body[:300]}")
            steps = srv.status()["decode"][f"{name}@v1"]["steps"]
            runs[name] = {"tokens": tokens, "launches": _launches(kernels),
                          "steps": steps, "seconds": seconds,
                          "predict": np.asarray(json.loads(body)[
                              "predictions"], np.float32)}
    finally:
        srv.stop()
    same = runs["memory"]["tokens"] == runs["file"]["tokens"]
    perr = float(np.abs(runs["memory"]["predict"]
                        - runs["file"]["predict"]).max())
    for name, run in runs.items():
        print(f"files transformer ({name}): 8 x /v1/generate + /v1/predict "
              f"in {run['seconds']:.3f}s, {run['steps']} decode steps, "
              f"launches {run['launches']}", flush=True)
    print(f"files transformer: greedy tokens identical {same}; /v1/predict "
          f"memory vs file max_abs_err {perr:.3e}", flush=True)
    if not same:
        fail("the transformer served from its file generates other tokens")
    if not perr <= 1e-6:
        fail(f"the transformer served from its file predicts otherwise: {perr}")
    for name, run in runs.items():
        want = {fn.__name__: 0 for fn in kernels}
        want.update({"int8_matmul": 17 * run["steps"],
                     "paged_gather": 8 * run["steps"], "flash_fwd": 4})
        if run["launches"] != want:
            fail(f"transformer ({name}) launch counts {run['launches']} != "
                 f"expected {want}")
    return {"launches": {n: r["launches"] for n, r in runs.items()},
            "steps": {n: r["steps"] for n, r in runs.items()},
            "predict_err": perr}


def files_lbfgs(kernels) -> dict:
    """(d) Full-width LeNet with ``optimization_algo="lbfgs"`` and
    ``iterations=10`` on one batch of 128, on the card and on the CPU from
    the same init."""
    import dataclasses

    conf = lenet_mnist()
    conf.global_conf = dataclasses.replace(
        conf.global_conf, optimization_algo="lbfgs",
        iterations=FILES_LBFGS_ITERS)
    net = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    ref = net.clone(device="cpu")
    ds = next(iter(MnistDataSetIterator(LENET_B, num_examples=LENET_B)))
    s0 = net.score(ds.features, ds.labels)
    # cuDNN deterministic: the line search's accept/reject decisions carry
    # any difference on, and a nondeterministic weight-gradient algorithm
    # gave a card run 1.95e-4 from the CPU once where repeats read 5e-6 to
    # 8e-6 (PERF.md, PR 14); deterministic, the card run repeats bitwise
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    _zero(kernels)
    try:
        t0 = time.perf_counter()
        net.fit(ds.features, ds.labels)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = prev
    launches = _launches(kernels)
    t0 = time.perf_counter()
    ref.fit(ds.features, ds.labels)
    cpu_s = time.perf_counter() - t0
    rel = abs(net.score_value - ref.score_value) / abs(ref.score_value)
    print(f"files lbfgs: loss {s0:.6f} -> card {net.score_value:.6f}, CPU "
          f"{ref.score_value:.6f} (relative {rel:.3e}, tol 1e-4); iterations "
          f"card {net.iteration}, CPU {ref.iteration}; card "
          f"{card_s / max(net.iteration, 1) * 1e3:.2f} ms an iteration, CPU "
          f"{cpu_s / max(ref.iteration, 1) * 1e3:.2f}; sm_xent launches "
          f"{launches['softmax_cross_entropy']} for {net.iteration} "
          f"iterations; launches {launches}", flush=True)
    if not (np.isfinite(net.score_value) and net.score_value < s0):
        fail(f"LBFGS on the card did not lower the loss: {s0} -> "
             f"{net.score_value}")
    if not rel <= 1e-4:
        fail(f"LBFGS on the card ends {rel} from the CPU run")
    if not 0 < net.iteration <= FILES_LBFGS_ITERS:
        fail(f"LBFGS ran {net.iteration} iterations")
    if launches["softmax_cross_entropy"] < net.iteration or any(
            n for k, n in launches.items() if k != "softmax_cross_entropy"):
        fail(f"LBFGS launches {launches} for {net.iteration} iterations")
    return {"launches": launches, "iterations": net.iteration,
            "cpu_iterations": ref.iteration, "loss": net.score_value,
            "cpu_loss": ref.score_value, "card_s": card_s, "cpu_s": cpu_s}


def files_phase(kernels) -> dict:
    """The files phase: (a) to (d) above, in a temporary directory that is
    removed after."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dl4j-files-")
    try:
        out = {"lenet": files_lenet(kernels, tmp),
               "resnet50": files_resnet(kernels, tmp),
               "transformer": files_transformer(kernels, tmp),
               "lbfgs": files_lbfgs(kernels)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"files phase: {out['seconds']:.1f}s wall; {CARD}", flush=True)
    return out


# ---------------------------------------------------------------------------
# The A5 slice's paths: non-causal flash checks, SelfAttention, the MoE LM,
# the zoo, layerwise pretraining and the Iris drive.

#: bench_attention's geometry (bench.py:506-521): B 4, T 2048, 8 heads of 64;
#: its ragged edge (T not a multiple of any tile) and its masked batch (a
#: tail of 256 (b + 1) keys masked in row b)
SA_B, SA_T, SA_H, SA_D, SA_RAGGED_T, SA_MASK_TAIL = 4, 2048, 8, 64, 2001, 256
#: the SelfAttention network's width (8 heads of 64), its check length and
#: timed steps at SA_T
SA_W, SA_CHECK_T, SA_TIMED = 512, 512, 5
#: the moe phase: the JAX bench's "moe" (bench.py:260-266, :403-407):
#: moe_transformer_lm(256, width 256, 4 layers, 4 heads, 8 experts), T 256,
#: B 8, K-step groups of 4; 2 card steps against the CPU, 8 K-step steps
MOE_V, MOE_W, MOE_L, MOE_H, MOE_E = 256, 256, 4, 4, 8
MOE_B, MOE_T, MOE_K, MOE_STEPS, MOE_CHECK_STEPS = 8, 256, 4, 8, 2
#: a token whose top-2 router probabilities lie closer than this may route
#: to another expert on the card than on the CPU (counted, not failed)
MOE_TIE = 1e-5
#: the zoo phase: VGG-16 at the JAX bench's geometry (bench.py:248-253,
#: :1802: 224x224x3, 1000 classes, B 64); its card-vs-CPU check at 64x64,
#: B 4; AlexNet and GoogLeNet checked at 64x64, B 2 (tests/test_model_zoo.py)
#: and timed at 224x224, B 32
ZOO_SIZE, ZOO_CLASSES, VGG_B, VGG_WARMUP, VGG_TIMED = 224, 1000, 64, 2, 10
VGG_CHECK_SIZE, VGG_CHECK_B, VGG_CHECK_STEPS, ZOO_EVAL = 64, 4, 2, 128
ZOO_SMALL_SIZE, ZOO_SMALL_B, ZOO_OTHER_B, ZOO_OTHER_TIMED = 64, 2, 32, 3
#: the JAX configs' parameter counts (tests/test_torch_zoo.py holds the
#: port's equal to them)
ZOO_PARAMS = {"vgg16": 138357544, "alexnet": 62378344,
              "googlenet": 6998552}
#: the pretrain phase: DL4J's VaeMNISTAnomaly widths (784 -> 256, 256 -> 32,
#: Bernoulli), and an RBM / AutoEncoder / output stack, on 20 batches of 128
#: synthetic digits
PT_B, PT_BATCHES, PT_HEAD_STEPS = 128, 20, 5
#: a Bernoulli draw whose uniform lies this close to its probability may
#: fall the other way on the card (counted, not failed)
PT_TIE = 1e-6
#: the Iris drive's batch
IRIS_B = 30


def _noncausal_case(g, dev, T, masked):
    B, H, D = SA_B, SA_H, SA_D
    q, k, v, do = (torch.randn(B, T, H, D, generator=g).to(dev)
                   for _ in range(4))
    valid = [T] * B
    km = None
    if masked:
        valid = [T - SA_MASK_TAIL * (b + 1) for b in range(B)]
        km = torch.zeros(B, T)
        for b, n in enumerate(valid):
            km[b, :n] = 1.0
        km = km.to(dev)
    return q, k, v, do, km, valid


def check_flash_noncausal(rows, dev) -> None:
    """Kernels 1-3 without the causal mask, at bench_attention's geometry
    (B 4, T 2048, 8 heads of 64), at a ragged T = 2001 and with a key mask
    that zeroes the tail of every row: against the plain versions, bitwise
    the same from run to run, and timed beside SDPA (the same mask) and the
    bound of the pairs this input needs."""
    g = torch.Generator().manual_seed(SEED + 7)
    tol = 2e-5
    for T, masked in ((SA_T, False), (SA_RAGGED_T, False), (SA_T, True)):
        q, k, v, do, km, valid = _noncausal_case(g, dev, T, masked)
        B, H, D = SA_B, SA_H, SA_D
        out, lse = flash_fwd(q, k, v, False, key_mask=km)
        again = flash_fwd(q, k, v, False, key_mask=km)
        ro, rl = flash_fwd_plain(q, k, v, False, key_mask=km)
        delta = bwd_delta(out, do)
        grads = [flash_bwd_dq(q, k, v, do, lse, delta, False, km),
                 *flash_bwd_dkv(q, k, v, do, lse, delta, False, km)]
        twice = [flash_bwd_dq(q, k, v, do, lse, delta, False, km),
                 *flash_bwd_dkv(q, k, v, do, lse, delta, False, km)]
        plain = [flash_bwd_dq_plain(q, k, v, do, lse, delta, False, km),
                 *flash_bwd_dkv_plain(q, k, v, do, lse, delta, False, km)]
        torch.cuda.synchronize()
        shape = {"B": B, "T": T, "H": H, "D": D, "causal": False,
                 "masked": masked}
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])
                and all(torch.equal(a, b) for a, b in zip(grads, twice))):
            fail(f"flash {shape} differs from run to run")
        errs = {"flash_fwd": max(float((out - ro).abs().max()),
                                 float((lse - rl).abs().max())),
                "flash_bwd_dq": float((grads[0] - plain[0]).abs().max()),
                "flash_bwd_dkv": max(float((grads[1] - plain[1]).abs().max()),
                                     float((grads[2] - plain[2]).abs().max()))}
        qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_(True)
                      for a in (q, k, v))
        am = None if km is None else (km > 0)[:, None, None, :]
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
        dot = do.transpose(1, 2).contiguous()

        def lib_fwd(qt=qt, kt=kt, vt=vt, am=am):
            with torch.no_grad():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=am)

        def lib_bwd(ot=ot, qt=qt, kt=kt, vt=vt, dot=dot):
            return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                       retain_graph=True)

        lib_bwd_ms = time_ms(lib_bwd, iters=10)
        # the pairs this input needs: every query against its row's keys
        pairs = H * T * sum(valid)
        row = B * T * H * D * 4
        stats = B * H * T * 4
        mask_b = 0 if km is None else B * T * 4
        for name, nbytes, ops, kernel, plain_fn, lib, lib_ms in (
                ("flash_fwd", 4 * row + stats + mask_b, 4 * D * pairs,
                 lambda: flash_fwd(q, k, v, False, key_mask=km),
                 lambda: flash_fwd_plain(q, k, v, False, key_mask=km),
                 lib_fwd, None),
                ("flash_bwd_dq", 5 * row + 2 * stats + mask_b, 6 * D * pairs,
                 lambda: flash_bwd_dq(q, k, v, do, lse, delta, False, km),
                 lambda: flash_bwd_dq_plain(q, k, v, do, lse, delta, False,
                                            km), lib_bwd, lib_bwd_ms),
                ("flash_bwd_dkv", 6 * row + 2 * stats + mask_b, 8 * D * pairs,
                 lambda: flash_bwd_dkv(q, k, v, do, lse, delta, False, km),
                 lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta, False,
                                             km), lib_bwd, lib_bwd_ms)):
            f32_ms, f32_by = bound(nbytes, ops)
            tc_ms, tc_by = bound(nbytes, 3 * ops, TF32_OPS_PER_S)
            r = report(rows, name, shape, errs[name], tol,
                       time_ms(kernel, iters=10), time_ms(plain_fn, iters=5),
                       lib_ms if lib_ms is not None
                       else time_ms(lib, iters=10), nbytes, ops,
                       {"card": CARD, "bound_ms": tc_ms, "bound_by": tc_by,
                        "bound_f32_ms": f32_ms, "bound_f32_by": f32_by})
            DEVICE_TIMED.append((r, kernel, lib))
        del ro, rl, plain, ot


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _want(kernels, **counts) -> dict:
    want = {fn.__name__: 0 for fn in kernels}
    want.update(counts)
    return want


def _check_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        fail(f"{what}: launch counts {got} != expected {want}")


def sa_conf():
    """SelfAttentionLayer(n_out=512, n_heads=8) (non-causal by default),
    average pooling over time, a 10-way softmax output."""
    return (NeuralNetConfiguration.builder().seed(SEED).learning_rate(1e-3)
            .updater("adam").list()
            .layer(SelfAttentionLayer.conf(n_out=SA_W, n_heads=SA_H))
            .layer(GlobalPoolingLayer.conf(pooling_type="avg"))
            .layer(OutputLayer.conf(n_out=10, loss="mcxent",
                                    activation="softmax"))
            .set_input_type(InputType.recurrent(SA_W, SA_CHECK_T)).build())


def self_attention(kernels) -> dict:
    """The SelfAttention network on the card against the CPU at T = 512
    (output, 2 fit steps each from the CPU run's state, a ragged masked
    batch's fit step and score), then timed at B 4, T 2048."""
    g = torch.Generator().manual_seed(SEED + 8)
    B, T = SA_B, SA_CHECK_T
    x = torch.randn(B, T, SA_W, generator=g).numpy()
    y = F.one_hot(torch.arange(B) % 10, 10).float().numpy()
    mask = np.ones((B, T), np.float32)
    for b in range(1, B):
        mask[b, T - T // 4 * b - 1:] = 0.0  # ragged: 512, 383, 255, 127
    ref = MultiLayerNetwork(sa_conf(), device="cpu").init(seed=SEED)
    card = ref.clone(device="cuda")
    _zero(kernels)
    out_err = float((card.output(x).cpu() - ref.output(x)).abs().max())
    out_launches = _launches(kernels)
    _check_launches("SelfAttention output", out_launches,
                    _want(kernels, flash_fwd=1))
    losses, ref_losses, step_launches = [], [], []
    for s in range(3):
        fmask = mask if s == 2 else None
        if s:
            _from_cpu_state(card, ref)
        _zero(kernels)
        card.fit(x, y, fmask=fmask)
        torch.cuda.synchronize()
        step_launches.append(_launches(kernels))
        ref.fit(x, y, fmask=fmask)
        losses.append(card.score_value)
        ref_losses.append(ref.score_value)
        _check_launches(f"SelfAttention step {s}", step_launches[-1],
                        _want(kernels, flash_fwd=1, flash_bwd_dq=1,
                              flash_bwd_dkv=1, softmax_cross_entropy=1))
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    _from_cpu_state(card, ref)
    ds = DataSet(x, y, mask)
    masked_score = (card.score(dataset=ds), ref.score(dataset=ds))
    rel = [_rel(a, b) for a, b in zip(losses, ref_losses)]
    rel.append(_rel(*masked_score))
    print(f"self_attention (T={T}): output max_abs_err {out_err:.3e}; card "
          f"losses {losses} (the last masked); CPU {ref_losses}; masked "
          f"score {masked_score}; worst relative {max(rel):.3e} (tol 1e-4)",
          flush=True)
    if not (out_err <= 1e-4 and max(rel) <= 1e-4):
        fail("SelfAttention on the card disagrees with the CPU")
    # timed at bench_attention's geometry
    net = MultiLayerNetwork(sa_conf(), device="cuda").init(seed=SEED)
    xt = torch.randn(SA_B, SA_T, SA_W, generator=g).to("cuda")
    yt = torch.from_numpy(y).to("cuda")
    for _ in range(2):
        net.fit(xt, yt)
    torch.cuda.synchronize()
    _zero(kernels)
    t0 = time.perf_counter()
    for _ in range(SA_TIMED):
        net.fit(xt, yt)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / SA_TIMED
    timed_launches = _launches(kernels)
    n = SA_TIMED
    _check_launches("SelfAttention timed steps", timed_launches,
                    _want(kernels, flash_fwd=n, flash_bwd_dq=n,
                          flash_bwd_dkv=n, softmax_cross_entropy=n))
    print(f"self_attention step (B={SA_B}, T={SA_T}, {SA_H} heads of "
          f"{SA_D}, non-causal): {step_ms:.3f} ms wall, "
          f"{SA_B * SA_T / (step_ms / 1e3):.0f} tokens/s [{CARD}]", flush=True)
    return {"output_max_abs_err": out_err, "losses": losses,
            "cpu_losses": ref_losses, "masked_score": list(masked_score),
            "worst_rel": max(rel), "output_launches": out_launches,
            "step_launches": step_launches, "step_ms": step_ms,
            "timed_launches": timed_launches,
            "masked_launches": step_launches[2],
            "unmasked_launches": {k_: out_launches[k_] + step_launches[0][k_]
                                  + step_launches[1][k_]
                                  + timed_launches[k_]
                                  for k_ in out_launches},
            "launches": {k_: out_launches[k_] + sum(s[k_] for s in
                                                   step_launches)
                         for k_ in out_launches}}


def moe_conf():
    return moe_transformer_lm(MOE_V, width=MOE_W, n_layers=MOE_L,
                              n_heads=MOE_H, n_experts=MOE_E, max_len=MOE_T)


@torch.no_grad()
def moe_routes(net, x) -> list:
    """Each MoE block's routing of ``x``'s tokens in the eval forward:
    ``(expert [S], gap between the top two router probabilities [S])``."""
    h = net._to_device(x)
    out = []
    for layer, p, st in zip(net.layers, net.params_list, net.state_list):
        if layer.has_loss():
            break
        if isinstance(layer, MoETransformerBlock):
            eidx, _, probs = layer.route(p, layer.ffn_tokens(p, h)[1])
            top = probs.topk(2, dim=-1).values
            out.append((eidx.cpu(), (top[:, 0] - top[:, 1]).cpu()))
        h = layer.apply_with_state(p, st, h)[0]
    return out


def _route_agreement(card_routes, cpu_routes) -> list:
    """Per layer: tokens, near-ties (CPU gap <= MOE_TIE), tokens routed
    elsewhere on the card among the near-ties and among the rest."""
    out = []
    for (ce, _), (re_, gap) in zip(card_routes, cpu_routes):
        tie = gap <= MOE_TIE
        flip = ce != re_
        out.append({"tokens": int(ce.numel()), "near_ties": int(tie.sum()),
                    "flips_near_ties": int((flip & tie).sum()),
                    "flips": int((flip & ~tie).sum()),
                    "experts_used": int(torch.unique(ce).numel())})
    return out


def _moe_family(kernel: str, chain: list) -> str:
    """A MoE LM step's device kernel by family: ``sm_xent``, the flash
    kernels, copies, the updater (its profiler range), the expert einsums
    (every batched product of the step: ``aten::bmm`` and its backward),
    the attention and head projections (the other products), and the rest
    (layer norm, softmax, router, elementwise, reductions)."""
    low = kernel.lower()
    if "sm_xent" in low:
        return "sm_xent"
    if "flash" in low:
        return "flash"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(UPDATER_LABEL in c for c in chain):
        return "updater"
    if any("bmm" in c.lower() for c in chain):
        return "expert einsums"
    if "gemm" in low or any(c in ("aten::mm", "aten::addmm") or
                            "MmBackward" in c for c in chain):
        return "attention and head projections"
    return "elementwise, norms, router, reductions"


def moe(kernels) -> dict:
    """The slice's main path: full-width moe_transformer_lm at the JAX
    bench's geometry."""
    conf = moe_conf()
    rng = np.random.default_rng(SEED + 21)
    x = np.eye(MOE_V, dtype=np.float32)[rng.integers(0, MOE_V,
                                                     (MOE_B, MOE_T))]
    # (a) 2 fit steps on the card, each from the CPU run's state: the
    # routing first, then the loss (with the balance term) and launches
    ref = MultiLayerNetwork(conf, device="cpu").init(seed=SEED)
    card = ref.clone(device="cuda")
    losses, ref_losses, routing, step_launches = [], [], [], []
    for s in range(MOE_CHECK_STEPS):
        if s:
            _from_cpu_state(card, ref)
        routing.append(_route_agreement(moe_routes(card, x),
                                        moe_routes(ref, x)))
        _zero(kernels)
        card.fit(x, x)
        torch.cuda.synchronize()
        step_launches.append(_launches(kernels))
        ref.fit(x, x)
        losses.append(card.score_value)
        ref_losses.append(ref.score_value)
    rel = [_rel(a, b) for a, b in zip(losses, ref_losses)]
    print(f"moe: card losses {losses}; CPU {ref_losses}; worst relative "
          f"{max(rel):.3e} (tol 1e-4); routing by step and layer {routing}",
          flush=True)
    for s, layers in enumerate(routing):
        if any(r["flips"] for r in layers):
            fail(f"moe step {s}: a token routed to another expert on the "
                 f"card than on the CPU with its top-2 gap above {MOE_TIE}: "
                 f"{layers}")
    if not max(rel) <= 1e-4 or not all(np.isfinite(losses)):
        fail(f"moe losses on the card {losses} disagree with the CPU "
             f"{ref_losses}")
    for got in step_launches:
        _check_launches("moe step", got, _want(
            kernels, flash_fwd=MOE_L, flash_bwd_dq=MOE_L,
            flash_bwd_dkv=MOE_L, softmax_cross_entropy=1))
    del ref
    # (b) the K-step dispatch against eager single steps from one init
    k = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    k.dispatch_ksteps = MOE_K
    e = k.clone()
    e.dispatch_ksteps = 1
    logs, counts = {}, {}
    for name, net in (("kstep", k), ("eager", e)):
        logs[name] = []
        net.set_listeners(_LossLog(logs[name]))
        _zero(kernels)
        net.fit(x, x, epochs=MOE_STEPS)
        torch.cuda.synchronize()
        counts[name] = _launches(kernels)
        net.set_listeners()
    check = _compare("moe", logs["kstep"], logs["eager"],
                     [(k.params_list, e.params_list),
                      (k.state_list, e.state_list)])
    n = MOE_STEPS
    graphs = _graph_counts(k, counts["kstep"])
    want = _want(kernels, softmax_cross_entropy=n, flash_fwd=MOE_L * n,
                 flash_bwd_dq=MOE_L * n, flash_bwd_dkv=MOE_L * n)
    if counts["kstep"] != want or counts["eager"] != want \
            or graphs["replays"] != n - 1:
        fail(f"moe K-step launches {counts} or replays {graphs} wrong")
    timing = _timed_pair(f"moe (B = {MOE_B}, T = {MOE_T}, fit(epochs={n}))",
                         lambda: e.fit(x, x, epochs=n),
                         lambda: k.fit(x, x, epochs=n), n)
    _footprint(timing, graphs)
    # (c) one profiled eager step by family
    prof, prof_ms = profiled(lambda: e.fit(x, x))
    by_family = device_us_by_family(prof, _moe_family)
    busy_us = sum(by_family.values())
    if busy_us <= 0:
        fail("the profiler saw no device time in the moe step")
    wall = {w: timing[w]["wall_ms_per_step"] for w in ("eager", "kstep")}
    perf = {f"{w}_{m}": v for w, ms in wall.items() for m, v in (
        ("ms_per_step", ms), ("samples_per_s", MOE_B / (ms / 1e3)),
        ("tokens_per_s", MOE_B * MOE_T / (ms / 1e3)))}
    print(f"moe step (B={MOE_B}, T={MOE_T}): eager {wall['eager']:.3f} ms, "
          f"K-step {wall['kstep']:.3f} ms a step ({perf['eager_tokens_per_s']:.0f}"
          f" / {perf['kstep_tokens_per_s']:.0f} tokens/s); profiled eager step"
          f" {prof_ms:.3f} ms, device {busy_us:.1f} us, idle share "
          f"{1 - busy_us / 1e3 / wall['eager']:.3f} of the unprofiled step "
          f"[{CARD}]", flush=True)
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  moe step device time {fam}: {us:.1f} us "
              f"({100 * us / busy_us:.1f}%)", flush=True)
    # (d) /v1/predict of [2, 256] tokens, float32 and int8, against the
    # CPU forward of the same served leaves. One-hot rows: float ids of
    # shape [2, T] read as a one-hot [B, V] batch when T equals the
    # vocabulary, as in the JAX package's embedding
    cpu_twin = e.clone(device="cpu")
    ids = np.eye(MOE_V, dtype=np.float32)[
        rng.integers(0, MOE_V, size=(2, MOE_T))]
    srv = InferenceServer(device="cuda")
    srv.start()
    served = {}
    try:
        srv.register("moe", e)
        srv.register("moe_int8", e, quant="int8")
        for model, quant in (("moe", None), ("moe_int8", "int8")):
            _zero(kernels)
            status, body = post(srv.port, "/v1/predict",
                                {"model": model, "inputs": ids.tolist()})
            got = _launches(kernels)
            if status != 200:
                fail(f"moe /v1/predict ({model}) returned {status}: "
                     f"{body[:500]}")
            pred = np.asarray(json.loads(body)["predictions"], np.float32)
            want_p = PredictFn(cpu_twin, quant=quant, device="cpu")(ids)
            err = float(np.abs(pred - want_p.numpy()).max())
            served[model] = {"max_abs_err": err, "launches": got}
            _check_launches(f"moe /v1/predict ({model})", got,
                            _want(kernels, flash_fwd=MOE_L))
    finally:
        srv.stop()
    # (e) the JAX-written lm_golden.zip restored on the card
    from deeplearning4j_tpu_torch.utils.model_serializer import guess_model
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
    gnet = guess_model(os.path.join(golden, "lm_golden.zip"))
    exp = np.load(os.path.join(golden, "lm_golden_expected.npz"))
    golden_err = float(np.abs(gnet.output(exp["lm_in"]).cpu().numpy()
                              - exp["lm_out"]).max())
    print(f"moe /v1/predict [2, {MOE_T}] against the CPU: {served}; "
          f"lm_golden.zip on the card: max_abs_err {golden_err:.3e} "
          f"(tol 1e-4)", flush=True)
    if not (all(v["max_abs_err"] <= 1e-4 for v in served.values())
            and golden_err <= 1e-4):
        fail("moe serving or lm_golden.zip disagrees with the reference")
    return {"card": CARD, "losses": losses, "cpu_losses": ref_losses,
            "worst_rel": max(rel), "routing": routing,
            "step_launches": step_launches,
            "launches": {k_: sum(s[k_] for s in step_launches)
                         for k_ in step_launches[0]},
            "kstep": {**check, **graphs}, "eager_launches": counts["eager"],
            "timing": timing, **perf, "profiled_step_ms": prof_ms,
            "device_us_total": busy_us, "device_us_by_family": by_family,
            "idle_share_eager": 1 - busy_us / 1e3 / wall["eager"],
            "peak_memory_bytes": timing["eager"]["peak_memory_bytes"],
            "predict": served,
            "predict_launches": served["moe"]["launches"],
            "golden_max_abs_err": golden_err}


def list_flops(conf, batch: int) -> float:
    """:func:`resnet_flops` for a list network."""
    from deeplearning4j_tpu_torch.nn.conf.serde import layer_class
    itype = conf.input_type
    total = 0.0
    for i, lc in enumerate(conf.layers):
        pp = conf.preprocessor(i)
        if pp is not None:
            itype = pp.output_type(itype)
        itype = layer_class(lc.type).output_type(lc.fields, itype)
        total += _step_flops(lc.type, lc.fields, itype, i == 0)
    return total * batch


def _zoo_net(name: str, device, **kw):
    conf = {"vgg16": vgg16, "alexnet": alexnet,
            "googlenet": googlenet}[name](n_classes=ZOO_CLASSES, **kw)
    cls = ComputationGraph if name == "googlenet" else MultiLayerNetwork
    return cls(conf, device=device)


def _fit(net, x, y):
    if isinstance(net, ComputationGraph):
        net.fit([x], [y])
    else:
        net.fit(x, y)


def _out(net, x):
    o = net.output(x)
    return (o[0] if isinstance(o, list) else o).cpu()


def zoo_check(name, kernels, size, batch, steps) -> dict:
    """Card against CPU from the same weights (dropout at retain 1.0, as
    the two RNGs differ): the eval output, then ``steps`` fit steps each
    from the CPU run's state, one sm_xent launch a step."""
    ref = _zoo_net(name, "cpu", image_size=size, dropout=1.0).init(seed=SEED)
    card = ref.clone(device="cuda")
    g = torch.Generator().manual_seed(SEED + 31)
    x, y = _res_batch(g, batch, size, ZOO_CLASSES, "cpu")
    out_err = float((_out(card, x) - _out(ref, x)).abs().max())
    losses, ref_losses = [], []
    launches = _want(kernels)
    for s in range(steps):
        if s:
            _from_cpu_state(card, ref)
        _zero(kernels)
        _fit(card, x.cuda(), y.cuda())
        torch.cuda.synchronize()
        got = _launches(kernels)
        _check_launches(f"{name} step", got,
                        _want(kernels, softmax_cross_entropy=1))
        launches = {k_: launches[k_] + got[k_] for k_ in got}
        _fit(ref, x, y)
        losses.append(card.score_value)
        ref_losses.append(ref.score_value)
    rel = [_rel(a, b) for a, b in zip(losses, ref_losses)]
    print(f"{name} ({size}x{size}, B={batch}) card vs CPU: output "
          f"max_abs_err {out_err:.3e}, losses {losses} / {ref_losses}, worst "
          f"relative {max(rel):.3e} (tol 1e-4)", flush=True)
    if not (out_err <= 1e-4 and max(rel) <= 1e-4):
        fail(f"{name} on the card disagrees with the CPU")
    return {"output_max_abs_err": out_err, "losses": losses,
            "cpu_losses": ref_losses, "worst_rel": max(rel),
            "launches": launches}


def _tree_map(fn, t):
    if isinstance(t, dict):
        return {k: _tree_map(fn, v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree_map(fn, v) for v in t]
    return fn(t)


def _snapshot(net) -> tuple:
    """A device copy of the network's params, layer states, updater state
    and iteration, for :func:`_restore`. The copies are detached: a clone
    of a param would keep the param's gradient accumulator alive, made on
    this stream, and a later CUDA graph capture of the step would then
    wait on this stream."""
    return (_tree_map(lambda t: t.detach().clone(), (
        net.params_list, net.state_list, net.updater_state)), net.iteration)


@torch.no_grad()
def _restore(net, snap) -> None:
    """Copy a :func:`_snapshot` back into the network, in place."""
    trees, net.iteration = snap

    def copy(dst, src):
        if isinstance(dst, torch.Tensor):
            dst.copy_(src)
        else:
            for k in (dst if isinstance(dst, dict) else range(len(dst))):
                copy(dst[k], src[k])

    copy([net.params_list, net.state_list, net.updater_state], trees)


def profiled(fn) -> tuple:
    """``fn`` run once under ``torch.profiler``: ``(prof, wall ms)``. A
    session that saw no device time is run again, up to three times."""
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        if any(us for _, _, us in device_events(prof)):
            break
    return prof, ms


def zoo_bench(name, kernels, batch, warmup, timed, profiled_step) -> dict:
    """Full width at 224x224 with the config's own dropout: warm-up and
    timed steps (wall ms, samples/s, peak memory, one sm_xent launch a
    step), and with ``profiled_step`` one profiled step by family and the
    share of the float32 peak. At the config's rate (0.01, Nesterov 0.9) a
    new He-initialized VGG-16 diverges on these random labels within a few
    steps (its loss reads 730 after the second step at 64x64), so every
    step starts from the initial state, restored on the device (its copies
    are timed apart and included in the step's time), and a step whose loss
    is not finite fails the phase."""
    net = _zoo_net(name, "cuda", image_size=ZOO_SIZE).init(seed=SEED)
    if net.num_params() != ZOO_PARAMS[name]:
        fail(f"{name}: {net.num_params()} params, the JAX config has "
             f"{ZOO_PARAMS[name]}")
    conf = net.conf
    flops = (resnet_flops(conf, batch) if isinstance(net, ComputationGraph)
             else list_flops(conf, batch))
    x, y = _res_batch(torch.Generator().manual_seed(SEED + 32), batch,
                      ZOO_SIZE, ZOO_CLASSES, "cuda")
    init = _snapshot(net)
    restore_ms = time_ms(lambda: _restore(net, init), iters=10, warmup=2)

    def step():
        _restore(net, init)
        _fit(net, x, y)
        return net._score  # the device scalar: read after the window

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(timed)]
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / timed
    launches = _launches(kernels)
    losses = [float(v) for v in losses]
    _check_launches(f"{name} timed steps", launches,
                    _want(kernels, softmax_cross_entropy=warmup + timed))
    if not all(np.isfinite(losses)):
        fail(f"{name}: a step's loss is not finite: {losses}")
    out = {"card": CARD, "batch": batch, "params": net.num_params(),
           "losses": losses, "restore_ms": restore_ms,
           "step_ms": step_ms, "samples_per_s": batch / (step_ms / 1e3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "step_tflop": flops / 1e12,
           "f32_peak_share": flops / F32_OPS_PER_S / (step_ms / 1e3)}
    if profiled_step:
        prof, out["profiled_step_ms"] = profiled(step)
        fam = device_us_by_family(prof, _resnet_family)
        busy = sum(fam.values())
        if busy <= 0:
            fail(f"the profiler saw no device time in the {name} step")
        out.update(device_us_by_family=fam, device_us_total=busy,
                   idle_share=1 - busy / 1e3 / step_ms,
                   f32_peak_share_of_device_time=flops / F32_OPS_PER_S
                   / (max(busy, 1e-9) / 1e6))
    print(f"{name} step ({ZOO_SIZE}x{ZOO_SIZE}x3, B={batch}): {step_ms:.3f} ms wall, "
          f"{out['samples_per_s']:.1f} samples/s, {flops / 1e12:.3f} TFLOP, "
          f"{100 * out['f32_peak_share']:.1f}% of the float32 peak; peak "
          f"memory {out['peak_memory_bytes'] / 2**30:.2f} GiB; "
          f"{out['params']} params; restore {restore_ms:.3f} ms a step "
          f"(included); losses {losses[0]:.4f} .. {losses[-1]:.4f} [{CARD}]"
          + (f"; device {out['device_us_total']:.1f} us, idle share "
             f"{out['idle_share']:.3f}" if profiled_step else ""), flush=True)
    for f_, us in sorted(out.get("device_us_by_family", {}).items(),
                         key=lambda kv: -kv[1]):
        print(f"  {name} step device time {f_}: {us:.1f} us "
              f"({100 * us / out['device_us_total']:.1f}%)", flush=True)
    out["net"] = net
    return out


def zoo(kernels) -> dict:
    """VGG-16 at the JAX bench's geometry, AlexNet and GoogLeNet at 224x224,
    B 32, each held to the CPU at a small size first."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    res = {"vgg16": {"check": zoo_check("vgg16", kernels, VGG_CHECK_SIZE,
                                        VGG_CHECK_B, VGG_CHECK_STEPS)}}
    bench = zoo_bench("vgg16", kernels, VGG_B, VGG_WARMUP, VGG_TIMED, True)
    # the timed network (one step from its initial state) evaluated and
    # served
    net = bench.pop("net")
    ge = torch.Generator().manual_seed(SEED + 33)
    sets = [DataSet(*(t.numpy() for t in _res_batch(
        ge, VGG_B, ZOO_SIZE, ZOO_CLASSES, "cpu")))
        for _ in range(ZOO_EVAL // VGG_B)]
    _zero(kernels)
    t0 = time.perf_counter()
    ev = net.evaluate(sets)
    torch.cuda.synchronize()
    bench["eval_s"] = time.perf_counter() - t0
    if ev.num_examples != ZOO_EVAL or any(_launches(kernels).values()):
        fail(f"vgg16 evaluate saw {ev.num_examples} images")
    rows = sets[0].features[:2]
    srv = InferenceServer(device="cuda", max_batch=2)
    srv.start()
    try:
        srv.register("vgg16", net)
        status, body = post(srv.port, "/v1/predict",
                            {"model": "vgg16", "inputs": rows.tolist()})
    finally:
        srv.stop()
    if status != 200:
        fail(f"vgg16 /v1/predict returned {status}: {body[:500]}")
    pred = np.asarray(json.loads(body)["predictions"], np.float32)
    bench["predict_max_abs_err"] = float(np.abs(
        pred - _out(net, rows).numpy()).max())
    print(f"vgg16 evaluate on {ev.num_examples} images in "
          f"{bench['eval_s']:.3f}s; /v1/predict of 2 rows against the card's"
          f" output: max_abs_err {bench['predict_max_abs_err']:.3e} (tol "
          f"1e-4)", flush=True)
    if not bench["predict_max_abs_err"] <= 1e-4:
        fail("vgg16 /v1/predict disagrees with the card's output")
    res["vgg16"].update(bench)
    del net
    for name in ("alexnet", "googlenet"):
        res[name] = {"check": zoo_check(name, kernels, ZOO_SMALL_SIZE,
                                        ZOO_SMALL_B, 1)}
        b = zoo_bench(name, kernels, ZOO_OTHER_B, 1, ZOO_OTHER_TIMED, False)
        b.pop("net")
        res[name].update(b)
    torch.cuda.empty_cache()
    return res


def pt_vae_graph():
    """A VariationalAutoencoder vertex at DL4J's VaeMNISTAnomaly widths and
    a 10-way head."""
    return (NeuralNetConfiguration.builder().seed(SEED).learning_rate(1e-3)
            .updater("adam").graph_builder().add_inputs("in")
            .add_layer("vae", VariationalAutoencoder.conf(
                n_in=784, n_out=32, encoder_layer_sizes=(256, 256),
                decoder_layer_sizes=(256, 256), activation="leakyrelu",
                reconstruction_distribution="bernoulli"), "in")
            .add_layer("out", OutputLayer.conf(n_in=32, n_out=10,
                                               loss="mcxent",
                                               activation="softmax"), "vae")
            .set_outputs("out").build())


def pt_stack():
    """RBM(784 -> 500, CD-1), AutoEncoder(500 -> 250, corruption 0.3), a
    10-way output, with layerwise pretraining before the supervised epoch."""
    return (NeuralNetConfiguration.builder().seed(SEED).learning_rate(0.05)
            .list()
            .layer(RBM.conf(n_in=784, n_out=500, k=1))
            .layer(AutoEncoder.conf(n_out=250, corruption_level=0.3))
            .layer(OutputLayer.conf(n_out=10, loss="mcxent",
                                    activation="softmax"))
            .pretrain(True)
            .set_input_type(InputType.feed_forward(784)).build())


def pretrain_phase(kernels) -> dict:
    """Layerwise pretraining on the card: a VAE graph vertex through
    ``pretrain_layer`` against the CPU, then the head's fit steps; an
    RBM / AutoEncoder stack's first CD update against the CPU, then
    ``fit_iterator`` (pretraining, then the supervised epoch)."""
    batches = list(MnistDataSetIterator(PT_B, num_examples=PT_B * PT_BATCHES))
    # (a) the VAE vertex's pretraining step on each batch, on the card from
    # the CPU run's state, both given the same normals (drawn once, on the
    # CPU, from one seeded generator) through the step's ``noise``
    ref = ComputationGraph(pt_vae_graph(), device="cpu").init(seed=SEED)
    card = ref.clone(device="cuda")
    step_r = make_graph_pretrain_step(ref, "vae")
    step_c = make_graph_pretrain_step(card, "vae")
    ge = torch.Generator().manual_seed(SEED + 40)
    eps = [torch.randn(PT_B, 32, generator=ge) for _ in batches]
    losses, ref_losses = [], []
    _zero(kernels)
    for ds, e in zip(batches, eps):
        _from_cpu_state(card, ref)
        xs = [torch.from_numpy(ds.features)]
        card.updater_state["vae"], loss = step_c(
            card.params_list, card.state_list, card.updater_state["vae"],
            [xs[0].cuda()], None, card.iteration, noise=[e.cuda()])
        losses.append(float(loss))
        ref.updater_state["vae"], loss = step_r(
            ref.params_list, ref.state_list, ref.updater_state["vae"], xs,
            None, ref.iteration, noise=[e])
        ref_losses.append(float(loss))
    check_launches = _launches(kernels)
    rel = [_rel(a, b) for a, b in zip(losses, ref_losses)]
    print(f"pretrain VAE vertex step ({PT_BATCHES} batches of {PT_B}, the "
          f"CPU's normals): card losses {losses[0]:.4f} .. {losses[-1]:.4f};"
          f" worst relative {max(rel):.3e} against the CPU (tol 1e-4)",
          flush=True)
    if not max(rel) <= 1e-4:
        fail("the VAE pretraining step on the card disagrees with the CPU")
    _check_launches("VAE pretraining check", check_launches, _want(kernels))
    del ref
    # then the entry point on the card alone, its normals drawn there: only
    # the vertex moves, the iteration stays
    card = ComputationGraph(pt_vae_graph(), device="cuda").init(seed=SEED)
    head0 = copy.deepcopy(convert.to_numpy(card.params_list["out"]))
    pre = []
    _zero(kernels)
    for ds in batches:
        card.pretrain_layer("vae", [ds])
        pre.append(card.score_value)
    pre_launches = _launches(kernels)
    head_same = all(np.array_equal(head0[k], v) for k, v in
                    convert.to_numpy(card.params_list["out"]).items())
    print(f"pretrain VAE vertex pretrain_layer on the card: losses "
          f"{pre[0]:.4f} .. {pre[-1]:.4f}; head unchanged {head_same}; "
          f"iteration {card.iteration}", flush=True)
    if not (head_same and card.iteration == 0 and np.isfinite(pre).all()
            and pre[-1] < pre[0]):
        fail("the VAE's pretrain_layer on the card moved the head or the "
             "iteration, or did not lower its loss")
    _check_launches("VAE pretraining", pre_launches, _want(kernels))
    _zero(kernels)
    for ds in batches[:PT_HEAD_STEPS]:
        card.fit(ds)
    torch.cuda.synchronize()
    head_launches = _launches(kernels)
    _check_launches("VAE graph fit", head_launches,
                    _want(kernels, softmax_cross_entropy=PT_HEAD_STEPS))
    vae = {"losses": losses, "cpu_losses": ref_losses, "worst_rel": max(rel),
           "pretrain_layer_losses": pre, "head_unchanged": head_same,
           "fit_launches": head_launches, "fit_score": card.score_value}
    del card
    # (b) the RBM's first CD update: the chain's uniforms drawn once, on
    # the CPU, and given to both devices
    ref = MultiLayerNetwork(pt_stack(), device="cpu").init(seed=SEED)
    card = ref.clone(device="cuda")
    x = torch.from_numpy(batches[0].features)
    rbm_r, rbm_c = ref.layers[0], card.layers[0]
    gu = torch.Generator().manual_seed(SEED + 41)
    u = [torch.rand(s, generator=gu) for s in rbm_r.noise_shapes(PT_B)]
    chain_r = rbm_r.gibbs_chain(ref.params_list[0], x, noise=u)
    chain_c = rbm_c.gibbs_chain(card.params_list[0], x.cuda(),
                                noise=[t.cuda() for t in u])
    flips = near = bad = 0
    compared = 0
    for (ur, pr, sr), (_, _, sc) in zip(chain_r[3], chain_c[3]):
        diff = sr != sc.cpu()
        tie = (ur - pr).abs() < PT_TIE
        flips += int(diff.sum())
        near += int(tie.sum())
        bad += int((diff & ~tie).sum())
        compared += 1
        if diff.any():
            break  # later draws follow other probabilities
    upd_err = None
    if flips == 0:
        names = ("W", "b", "vb")
        gr = torch.autograd.grad(rbm_r.pretrain_loss(
            ref.params_list[0], x, noise=u),
            [ref.params_list[0][n] for n in names])
        gc = torch.autograd.grad(rbm_c.pretrain_loss(
            card.params_list[0], x.cuda(), noise=[t.cuda() for t in u]),
            [card.params_list[0][n] for n in names])
        upd_err = max(float((a.cpu() - b).abs().max())
                      / max(float(b.abs().max()), 1e-12)
                      for a, b in zip(gc, gr))
    print(f"pretrain RBM first CD update: {flips} Bernoulli samples differ "
          f"from the CPU's ({near} uniforms within {PT_TIE} of their "
          f"probability; {bad} differ elsewhere) over {compared} draws; "
          f"update relative error {upd_err} (tol 1e-5)", flush=True)
    if bad or (upd_err is not None and not upd_err <= 1e-5):
        fail("the RBM's CD update on the card disagrees with the CPU")
    # (c) fit_iterator: the layerwise pretraining, then the supervised epoch
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator)
    before = copy.deepcopy(convert.to_numpy(card.params_list))
    _zero(kernels)
    t0 = time.perf_counter()
    card.fit_iterator(ListDataSetIterator(batches))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = _launches(kernels)
    moved = [any(not np.array_equal(before[i][k], v) for k, v in
                 convert.to_numpy(p).items())
             for i, p in enumerate(card.params_list)]
    print(f"pretrain stack fit_iterator ({PT_BATCHES} batches): "
          f"{fit_s:.3f}s, iteration {card.iteration}, loss "
          f"{card.score_value:.4f}, layers moved {moved}, launches "
          f"{fit_launches}", flush=True)
    _check_launches("pretrain stack fit_iterator", fit_launches,
                    _want(kernels, softmax_cross_entropy=PT_BATCHES))
    if not (all(moved) and card.iteration == PT_BATCHES
            and np.isfinite(card.score_value)):
        fail("the pretrain-then-fit stack did not train every layer")
    return {"vae": vae, "rbm_flips": flips, "rbm_near_ties": near,
            "rbm_update_rel_err": upd_err, "stack_fit_s": fit_s,
            "stack_launches": fit_launches, "stack_score": card.score_value,
            "launches": {k_: head_launches[k_] + fit_launches[k_]
                         for k_ in fit_launches}}


def iris(kernels) -> dict:
    """The SKILL.md library drive on the card: Iris, a 4 -> 16 -> 3 dense
    network, Adam at 0.1, 20 epochs of 5 batches of 30."""
    it = IrisDataSetIterator(batch=IRIS_B)
    conf = (NeuralNetConfiguration.builder().seed(1).learning_rate(0.1)
            .updater("adam").list()
            .layer(DenseLayer.conf(n_in=4, n_out=16, activation="relu"))
            .layer(OutputLayer.conf(n_in=16, n_out=3, loss="mcxent",
                                    activation="softmax")).build())
    net = MultiLayerNetwork(conf, device="cuda").init()
    _zero(kernels)
    net.fit_iterator(it, epochs=20)
    torch.cuda.synchronize()
    launches = _launches(kernels)
    acc = net.evaluate(it).accuracy()
    print(f"iris: accuracy {acc:.4f} after 20 epochs (must be > 0.9); "
          f"launches {launches}", flush=True)
    _check_launches("iris", launches, _want(kernels,
                                            softmax_cross_entropy=100))
    if not acc > 0.9:
        fail(f"iris accuracy {acc} <= 0.9")
    return {"accuracy": acc, "launches": launches}


# ------------------------------------------------------------------ A6
#: the spec phase: the serve phase's target and traffic, and the JAX bench's
#: draft (bench.py:1011-1012): half the target's width, one block of 2 heads
SPEC_V, SPEC_DRAFT_WIDTH, SPEC_TOKENS, SPEC_SLOTS, SPEC_NEW = 256, 128, 3, 8, 32
#: the replicas phase: 32 /v1/predict requests from 8 threads, each of one
#: row of 255 ids (a float row of 256 = V would read as one one-hot token in
#: both packages); a rolling hot swap starts after the 12th answer, and the
#: last 8 requests wait for it to end, so both versions answer
REPLICA_REQUESTS, REPLICA_THREADS, REPLICA_T, REPLICA_SWAP_AT = 32, 8, 255, 12
#: the replicas' widest dispatch: 4 rows of 8 threads over 2 replicas
REPLICA_B = 4
#: each replica admits 16 requests; the autoscaler's scale-out sees 24
#: queued over 2 replicas (a pending fraction of 0.75 > its queue_high 0.5)
#: and its scale-in 4 on the third (0.083 < its queue_low 0.1)
REPLICA_MAX_QUEUE, REPLICA_PRESSURE, REPLICA_DRAIN = 16, 24, 4
#: GPU clock cycles of the spin that holds the stream while requests queue
#: behind it (about 1 s at the H100's 1.98 GHz)
REPLICA_HOLD_CYCLES = 2_000_000_000


def serve_prompts() -> list:
    """The serve phase's 8 prompts (16 to 64 tokens), drawn again."""
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, SPEC_V, size=int(rng.integers(16, 65))).tolist()
            for _ in range(8)]


def argmax_gap(ref_pf, prompt, toks) -> float:
    """The worst gap between the CPU full-sequence forward's best
    probability and the served token's, over the served tokens."""
    probs = ref_pf(np.asarray([prompt + toks], np.float32)).numpy()[0]
    return max(float(probs[len(prompt) - 1 + t].max()
                     - probs[len(prompt) - 1 + t][tok])
               for t, tok in enumerate(toks))


def spec_phase(kernels) -> dict:
    """Speculative decoding on the paged int8 engine: (a) 8 concurrent
    /v1/generate requests through a server whose target links a draft, each
    token the CPU oracle's argmax; (c) exact launches a verify round; (b)
    run_spec_ab at a fixed capacity of 8, spec tokens equal to plain tokens;
    (d) a draft holding the target's own weights, both float32 on dense KV,
    acceptance exactly 1.0."""
    from deeplearning4j_tpu_torch.keras_server.decode import DecodeEngine
    from deeplearning4j_tpu_torch.keras_server.loadgen import run_spec_ab
    conf = transformer_lm(SPEC_V)
    net = MultiLayerNetwork(conf, device="cuda").init(seed=SEED)
    ref_pf = PredictFn(MultiLayerNetwork(conf, device="cpu").init(seed=SEED),
                       quant="int8", device="cpu")
    draft = MultiLayerNetwork(
        transformer_lm(SPEC_V, width=SPEC_DRAFT_WIDTH, n_layers=1, n_heads=2,
                       max_len=512), device="cuda").init(seed=SEED + 16)
    prompts = serve_prompts()
    srv = InferenceServer(device="cuda", decode_kv="paged",
                          decode_page_size=16, decode_max_context=512,
                          decode_max_slots=16, decode_spec_tokens=SPEC_TOKENS)
    srv.start()
    try:
        srv.register("lm", net, quant="int8")
        srv.register("draft", draft)
        srv.registry.link_draft("lm", "draft")
        _zero(kernels)
        t0 = time.perf_counter()
        tokens = _generate(srv.port, "lm", prompts)
        gen_s = time.perf_counter() - t0
        launches = _launches(kernels)
        dec = srv.status()["decode"]["lm@v1+draft@v1"]
    finally:
        srv.stop()
    rounds = dec["steps"]
    print(f"spec: 8 x /v1/generate in {gen_s:.3f}s: {rounds} verify rounds, "
          f"{dec['draft_steps']} draft steps, {dec['tokens']} tokens, "
          f"acceptance {dec['spec_acceptance']:.4f} "
          f"({dec['spec_accepted']}/{dec['spec_proposed']}); launches "
          f"{launches}", flush=True)
    # (c) each verify round runs the plain step's ops T = 4 times: 17 int8
    # products and 8 page gathers a position; the draft launches nothing
    T = SPEC_TOKENS + 1
    _check_launches("spec /v1/generate", launches, _want(
        kernels, int8_matmul=17 * T * rounds, paged_gather=8 * T * rounds))
    # the pump counts each draft forward it runs: gamma of them a round
    if dec["draft_steps"] != SPEC_TOKENS * rounds:
        fail(f"spec: {dec['draft_steps']} draft steps in {rounds} rounds, "
             f"not {SPEC_TOKENS} a round")
    # (a) the served tokens against the CPU full-sequence oracle
    gap = max(argmax_gap(ref_pf, p, t) for p, t in zip(prompts, tokens))
    print(f"spec /v1/generate vs CPU full-sequence oracle: worst argmax gap "
          f"{gap:.3e} (tol 1e-4)", flush=True)
    if not gap <= 1e-4:
        fail(f"spec /v1/generate tokens are not the reference argmax: {gap}")
    # (b) plain against spec on the engines, one fixed capacity for both
    ab = run_spec_ab(net, draft, slots=SPEC_SLOTS, max_context=512,
                     spec_tokens=SPEC_TOKENS, quant="int8", kv="paged",
                     page_size=16, prompts=prompts,
                     budgets=[SPEC_NEW] * len(prompts), device="cuda")
    g, s = ab["greedy"], ab["spec"]
    print(f"run_spec_ab at capacity {SPEC_SLOTS}: plain {g['tokens_per_sec']} "
          f"tokens/s ({g['steps']} steps), spec {s['tokens_per_sec']} "
          f"tokens/s ({s['steps']} rounds), ratio "
          f"{ab['tokens_per_sec_ratio']}, acceptance {ab['acceptance']}, "
          f"bitwise {ab['bitwise_equal']}", flush=True)
    if not ab["bitwise_equal"]:
        fail("run_spec_ab: spec tokens differ from plain tokens")
    want_plain = {"int8_matmul": 17 * g["steps"], "paged_gather": 8 * g["steps"]}
    want_spec = {"int8_matmul": 17 * T * s["steps"],
                 "paged_gather": 8 * T * s["steps"]}
    if g["kernel_launches"] != want_plain or s["kernel_launches"] != want_spec:
        fail(f"run_spec_ab launches {g['kernel_launches']} / "
             f"{s['kernel_launches']} != {want_plain} / {want_spec}")
    # (d) the target's own weights as the draft, both float32, dense KV
    self_ab = run_spec_ab(net, net, slots=SPEC_SLOTS, max_context=512,
                          spec_tokens=SPEC_TOKENS, prompts=prompts,
                          budgets=[SPEC_NEW] * len(prompts), device="cuda")
    print(f"self-draft float32 dense: acceptance {self_ab['acceptance']} "
          f"({self_ab['proposed']} proposed), tokens/s plain "
          f"{self_ab['greedy']['tokens_per_sec']} spec "
          f"{self_ab['spec']['tokens_per_sec']} (ratio "
          f"{self_ab['tokens_per_sec_ratio']}), bitwise "
          f"{self_ab['bitwise_equal']}", flush=True)
    if self_ab["spec_stats"]["spec_accepted"] != \
            self_ab["spec_stats"]["spec_proposed"] \
            or not self_ab["bitwise_equal"]:
        fail(f"a self-draft's acceptance is {self_ab['acceptance']}, not 1.0")
    return {"launches": launches, "generate_s": gen_s, "rounds": rounds,
            "acceptance": dec["spec_acceptance"], "worst_argmax_gap": gap,
            "generate_stats": dec, "ab": ab, "self_draft_ab": self_ab}


def replicas_phase(kernels) -> dict:
    """/v1/predict through two replicas of the int8 transformer on the one
    card, a rolling hot swap mid-traffic; then one autoscaler tick sequence
    on an injected clock: one scale-out, one drained scale-in."""
    from deeplearning4j_tpu_torch.keras_server import Autoscaler
    conf = transformer_lm(SPEC_V)
    nets = {v: MultiLayerNetwork(conf, device="cuda").init(seed=SEED + i)
            for i, v in enumerate(("v1", "v2"))}
    refs = {v: PredictFn(MultiLayerNetwork(conf, device="cpu").init(
        seed=SEED + i), quant="int8", device="cpu")
        for i, v in enumerate(("v1", "v2"))}
    rng = np.random.default_rng(SEED + 32)
    ids = rng.integers(0, SPEC_V, size=(REPLICA_REQUESTS, 1, REPLICA_T)) \
        .astype(np.float32)
    srv = InferenceServer(replicas=2, device="cuda",
                          max_queue=REPLICA_MAX_QUEUE)
    srv.start()
    answers = [None] * REPLICA_REQUESTS
    walls = [None] * REPLICA_REQUESTS
    done = threading.Semaphore(0)
    swapped = threading.Event()
    try:
        srv.register("lm", nets["v1"], quant="int8", version="v1")
        scraped = scrape_metrics(srv.port)
        _zero(kernels)

        def client(w):
            for j in range(w, REPLICA_REQUESTS, REPLICA_THREADS):
                if j >= REPLICA_REQUESTS - REPLICA_THREADS:
                    swapped.wait(600)
                t0 = time.perf_counter()
                answers[j] = post(srv.port, "/v1/predict",
                                  {"model": "lm", "inputs": ids[j].tolist()})
                walls[j] = time.perf_counter() - t0
                done.release()

        threads = [threading.Thread(target=client, args=(w,), daemon=True)
                   for w in range(REPLICA_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for _ in range(REPLICA_SWAP_AT):
            if not done.acquire(timeout=600):
                fail("replicas: no answer within 600 s")
        t_swap = time.perf_counter()
        try:
            srv.register("lm", nets["v2"], quant="int8", version="v2")
        finally:
            swapped.set()
        swap_s = time.perf_counter() - t_swap
        for t in threads:
            t.join()
        total_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _launches(kernels)
        st = srv.status()
        dispatches = st["queue"]["dispatches"]
        metrics = replicas_metrics_check(srv.port, scraped, st)
        # one autoscaler sequence on a fake clock, as the server builds it
        # (no SLO engine: queue pressure is its one signal). A spin on the
        # stream the dispatchers launch on holds their forwards, so the
        # requests stay queued while the autoscaler reads the queues
        clock = [1000.0]
        rs = srv.replica_set

        def pending_fraction():
            return sum(r.queue_depth() / REPLICA_MAX_QUEUE
                       for r in rs.replicas) / rs.n_replicas

        asc = Autoscaler(rs, min_replicas=2, max_replicas=3, cooldown_s=5.0,
                         headroom_ticks=1, clock=lambda: clock[0])
        torch.cuda._sleep(REPLICA_HOLD_CYCLES)
        futs = [rs.submit("lm", ids[j % REPLICA_REQUESTS])
                for j in range(REPLICA_PRESSURE)]
        qfrac_out = pending_fraction()
        t_out = time.perf_counter()
        out = asc.tick()
        out_s = time.perf_counter() - t_out
        pressed = [f.result(timeout=120) for f in futs]
        added = max(rs.replicas, key=lambda r: r.index)
        torch.cuda._sleep(REPLICA_HOLD_CYCLES)
        futs = [added.batcher.submit("lm", ids[j])
                for j in range(REPLICA_DRAIN)]
        qfrac_in = pending_fraction()
        clock[0] += 6.0
        back = asc.tick()
        drained = [f.result(timeout=120) for f in futs]
        scaler = asc.status()
    finally:
        srv.stop()
    errs, by_replica, by_version = [], {}, {}
    for j, (code, text) in enumerate(answers):
        if code != 200:
            fail(f"replicas: request {j} answered {code}: {text[:300]}")
        body = json.loads(text)
        v = body["version"]
        by_replica[body["replica"]] = by_replica.get(body["replica"], 0) + 1
        by_version[v] = by_version.get(v, 0) + 1
        errs.append(float(np.abs(np.asarray(body["predictions"], np.float32)
                                 - refs[v](ids[j]).numpy()).max()))
    drained_err = max(float(np.abs(np.asarray(r["predictions"])
                                   - refs[r["version"]](ids[j]).numpy())
                            .max()) for j, r in enumerate(drained))
    pressed_err = max(float(np.abs(
        np.asarray(r["predictions"])
        - refs[r["version"]](ids[j % REPLICA_REQUESTS]).numpy()).max())
        for j, r in enumerate(pressed))
    ms = sorted(1e3 * w for w in walls)
    print(f"replicas: {REPLICA_REQUESTS} x /v1/predict [1,{REPLICA_T}] from "
          f"{REPLICA_THREADS} threads in {total_s:.3f}s; wall ms p50 "
          f"{ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}; rolling swap "
          f"{swap_s:.3f}s; by replica {by_replica}, by version {by_version}; "
          f"{dispatches} dispatches; worst error {max(errs):.3e} (tol 1e-4); "
          f"launches {launches}", flush=True)
    print(f"autoscaler: {out} at queue fraction {qfrac_out:.3f} "
          f"({REPLICA_PRESSURE} queued), then {back} at {qfrac_in:.3f}; "
          f"scale-out {out_s:.3f}s of wall time (a replica pinning the "
          f"catalog behind the held stream); {len(pressed)} queued answers, worst error "
          f"{pressed_err:.3e}; drained answers {len(drained)} from replica "
          f"{drained[0]['replica']}, worst error {drained_err:.3e}",
          flush=True)
    if not max(errs) <= 1e-4 or not drained_err <= 1e-4 \
            or not pressed_err <= 1e-4:
        fail(f"replica answers disagree with the CPU: {max(errs)}, "
             f"{pressed_err}, {drained_err}")
    if set(by_replica) != {0, 1} or set(by_version) != {"v1", "v2"}:
        fail(f"replicas: by replica {by_replica}, by version {by_version}")
    _check_launches("replicas /v1/predict", launches,
                    _want(kernels, flash_fwd=4 * dispatches))
    if (out, back) != ("out", "in") or \
            [(e["direction"], e["reason"]) for e in scaler["events"]] != \
            [("out", "queue-depth"), ("in", "headroom")] or \
            {r["replica"] for r in drained} != {added.index}:
        fail(f"autoscaler ticks gave {out}, {back} at queue fractions "
             f"{qfrac_out}, {qfrac_in}: {scaler['events']}")
    return {"launches": launches, "dispatches": dispatches,
            "total_s": total_s, "wall_ms": ms, "swap_s": swap_s,
            "by_replica": by_replica, "by_version": by_version,
            "max_abs_err": max(errs), "scale_out_s": out_s,
            "queue_fraction_out": qfrac_out, "queue_fraction_in": qfrac_in,
            "autoscaler": scaler, "metrics": metrics}


def replicas_metrics_check(port: int, before: dict, st: dict) -> dict:
    """``GET /metrics`` after the replicas phase's predicts and rolling
    swap: requests, batches and routed requests by replica moved by what
    was sent and by what ``/serve/status`` counts; the swap moved each
    replica's active-version series."""
    after = scrape_metrics(port)
    reps = st["replicas"]["replicas"]
    got = {
        "requests": request_count_delta(port, before, "/v1/predict",
                                        REPLICA_REQUESTS),
        "admitted": metric_delta(after, before, "dl4j_serve_requests_total",
                                 model="lm"),
        "batches": metric_delta(after, before, "dl4j_serve_batches_total",
                                model="lm"),
        "routed": {r["replica"]: metric_delta(
            after, before, "dl4j_serve_replica_routed_total",
            replica=r["replica"]) for r in reps},
        "hot_swaps": metric_delta(after, before, "dl4j_serve_hot_swaps_total",
                                  model="lm"),
        "fleet": after.get(("dl4j_serve_fleet_size", ())),
        "active_v2": sorted(dict(lab)["replica"] for (n, lab), v
                            in after.items()
                            if n == "dl4j_serve_replica_active_version"
                            and dict(lab).get("model") == "lm"
                            and dict(lab).get("version") == "v2" and v == 1)}
    want = {"requests": REPLICA_REQUESTS, "admitted": REPLICA_REQUESTS,
            "batches": st["queue"]["dispatches"],
            "routed": {r["replica"]: r["routed"] for r in reps},
            "hot_swaps": len(reps), "fleet": len(reps),
            "active_v2": sorted(str(r["replica"]) for r in reps)}
    print(f"replicas /metrics: {got}", flush=True)
    if got != want or sum(got["routed"].values()) != REPLICA_REQUESTS:
        fail(f"replicas /metrics {got} != {want}")
    return got


def multi_input_phase(kernels) -> dict:
    """A two-input, two-output ComputationGraph through make_predict_fn and
    the micro-batcher on the card, against its own card ``output``."""
    from deeplearning4j_tpu_torch.keras_server import (
        MicroBatcher, ModelRegistry)
    from deeplearning4j_tpu_torch.nn.conf.vertices import MergeVertex
    from deeplearning4j_tpu_torch.nn.inference import make_predict_fn
    conf = (NeuralNetConfiguration.builder().seed(SEED).graph_builder()
            .add_inputs("a", "b")
            .add_layer("da", DenseLayer.conf(n_in=4, n_out=6,
                                             activation="tanh"), "a")
            .add_layer("db", DenseLayer.conf(n_in=3, n_out=6,
                                             activation="tanh"), "b")
            .add_vertex("merged", MergeVertex(), "da", "db")
            .add_layer("out", OutputLayer.conf(n_in=12, n_out=2, loss="mse",
                                               activation="identity"),
                       "merged")
            .add_layer("out2", OutputLayer.conf(n_in=12, n_out=3,
                                                loss="mcxent",
                                                activation="softmax"),
                       "merged")
            .set_outputs("out", "out2").build())
    net = ComputationGraph(conf, device="cuda").init()
    rng = np.random.default_rng(SEED)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(3, 3)).astype(np.float32)
    want = [o.cpu().numpy() for o in net.output(a, b)]
    pf = make_predict_fn(net, device="cuda")
    err = max(float(np.abs(o.cpu().numpy() - w).max())
              for o, w in zip(pf(a, b), want))
    registry = ModelRegistry()
    registry.register("g", net, device="cuda")
    batcher = MicroBatcher(registry, max_batch=8, max_latency_s=0.002)
    try:
        futs = [batcher.submit("g", [a[i:i + 1], b[i:i + 1]])
                for i in range(3)]
        for i, f in enumerate(futs):
            for p, w in zip(f.result(timeout=60)["predictions"], want):
                err = max(err, float(np.abs(np.asarray(p) - w[i:i + 1])
                                     .max()))
    finally:
        batcher.close()
    print(f"multi_input: 2 inputs, 2 outputs through PredictFn "
          f"(n_inputs {pf.n_inputs}) and the batcher: max_abs_err "
          f"{err:.3e} (tol 1e-6)", flush=True)
    if pf.n_inputs != 2 or not err <= 1e-6:
        fail(f"multi_input: n_inputs {pf.n_inputs}, error {err}")
    return {"max_abs_err": err, "n_inputs": pf.n_inputs}


#: the parallel phase (A7: ParallelWrapper over torch.distributed on one
#: card): transformer_lm(256) at the training shape (B 16, T 256, Adam at
#: 3e-4, seed 1234); sync DP as 4 single steps then one K-step group of 8;
#: zero3, local SGD at frequency 2 (4 steps), Ulysses and ring (2 steps
#: each); ResNet-50 at 224x224, B 128, 2 steps
PAR_SINGLE, PAR_K, PAR_STEPS, PAR_LOCAL_FREQ = 4, 8, 2, 2
#: sync DP (the collectives of a group of one are identities): losses and
#: params within this of fit, relative
PAR_TOL = 1e-5
#: the other modes reorder sums (zero3's per-leaf blocks, ring's plain
#: attention in place of the flash kernels), which Adam amplifies where a
#: gradient entry is near 0: losses within PAR_TOL relative, and
#: ||wrapper - fit|| / ||fit - init|| of the params within this
PAR_SHARE_TOL = 1e-3
#: ResNet-50 under DP (batch norm's group path), cuDNN deterministic
PAR_RES_STEPS, PAR_RES_TOL = 2, 1e-4
#: two gloo ranks on the one card against one rank on the same batches
PAR_GLOO_STEPS, PAR_GLOO_TOL = 3, 1e-4
#: the modes two gloo ranks run on the card and hold against one rank: gloo
#: (torch 2.11 on the chip machine) ran all_reduce, all_gather(_into_tensor),
#: reduce_scatter_tensor, all_to_all_single and broadcast on CUDA tensors
#: and failed batch_isend_irecv (ring's K/V pass) in this PR's first chip
#: call; local SGD is another algorithm than one rank's fit
PAR_GLOO_MODES = ("dp", "zero3", "ulysses", "pipeline", "dp_tp", "expert")
#: A7.5, A7.6 and A7.9: PipelineTrainer's microbatches (B 16 gives 4 rows
#: a microbatch), the expert-parallel capacity factors (8: nothing drops;
#: 2.0: the default) on the MoE LM at its bench geometry (B 8, T 256, 8
#: experts), and a dp_tp rank's heads on {data: 1, model: 2}
PAR_PIPE_M = 4
PAR_EP_ROOMY, PAR_EP_DEFAULT = 8.0, 2.0
PAR_TP_HEADS = 2
#: the default-capacity step is held against the same step on the CPU. The
#: MoE LM's gradient is not a continuous function of its inputs: an expert's
#: hidden unit whose pre-activation lies within rounding of 0 takes ReLU's
#: other slope on the card than on the CPU, which moves that expert's W1
#: and b1 gradient by one token's rank-1 term, and every gradient upstream
#: of it. So the leaves no ReLU slope reaches (the last block's W2, b2 and
#: Wg and the output layer: their gradients are continuous given the same
#: routing) are held to this fixed limit, and the whole gradient within
#: PAR_EP_MULT of the dense path's own card-to-CPU distance on the same
#: rows (the whole batch) from the same state
PAR_EP_SMOOTH_TOL = 1e-5
PAR_EP_MULT = 2.0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _par_batches(n: int, seed: int) -> list:
    """``n`` one-hot id batches ``[B, T, V]`` with y = x (the train
    phase's inputs), host numpy."""
    g = np.random.default_rng(seed)
    return [np.eye(TRAIN_V, dtype=np.float32)[
        g.integers(0, TRAIN_V, size=(TRAIN_B, TRAIN_T))] for _ in range(n)]


def _par_net(device="cuda"):
    return MultiLayerNetwork(transformer_lm(TRAIN_V), device=device).init(
        seed=SEED)


def _moe_batches(n: int, seed: int) -> list:
    """``n`` one-hot id batches of the MoE LM ``[B, T, V]``, host numpy."""
    g = np.random.default_rng(seed)
    return [np.eye(MOE_V, dtype=np.float32)[
        g.integers(0, MOE_V, size=(MOE_B, MOE_T))] for _ in range(n)]


def _moe_net(device="cuda"):
    return MultiLayerNetwork(moe_conf(), device=device).init(seed=SEED)


def _flat_params(net) -> torch.Tensor:
    return net.params().detach().double()


def _par_iter(xs):
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    return ListDataSetIterator([DataSet(x, x) for x in xs])


class _Losses:
    def __init__(self):
        self.values = []

    def iteration_done(self, model, iteration):
        self.values.append(float(model.score_value))


def _par_run(net, snap, fn, warm: int = 0) -> tuple:
    """``fn(net)`` from the snapshot: ``(losses, flat params, wall ms a
    step)``, the ms over the steps after the first (over the last ``warm``
    steps when given)."""
    _restore(net, snap)
    rec = _Losses()
    net.set_listeners(rec)
    stamps = []

    class Stamp:
        def iteration_done(self, model, iteration):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    net.add_listener(Stamp())
    torch.cuda.synchronize()
    fn(net)
    torch.cuda.synchronize()
    net.set_listeners()
    span = stamps[-warm - 1:] if warm else stamps
    ms = (1e3 * (span[-1] - span[0]) / (len(span) - 1) if len(span) > 1
          else float("nan"))
    return rec.values, _flat_params(net), ms


def _par_check(name, got, ref, init, share_tol=None) -> dict:
    """``got`` against ``ref`` (each ``(losses, params, ms)``): the losses'
    worst relative error, the params' relative error and their share of
    the distance moved."""
    gl, gp, _ = got
    rl, rp, _ = ref
    if len(gl) != len(rl) or not all(np.isfinite(gl)):
        fail(f"parallel {name}: losses {gl} against fit's {rl}")
    loss_rel = max(_rel(a, b) for a, b in zip(gl, rl))
    rel = float((gp - rp).norm() / rp.norm())
    share = float((gp - rp).norm() / max(float((rp - init).norm()), 1e-30))
    ok = loss_rel <= PAR_TOL and (rel <= PAR_TOL if share_tol is None
                                  else share <= share_tol)
    print(f"parallel {name}: losses {gl} (fit {rl}); loss rel err "
          f"{loss_rel:.3e}, params rel err {rel:.3e}, share of the distance "
          f"moved {share:.3e} (tol {PAR_TOL:.0e}"
          f"{'' if share_tol is None else f', share {share_tol:.0e}'}); "
          f"{got[2]:.3f} ms a step (fit {ref[2]:.3f})", flush=True)
    if not ok:
        fail(f"parallel {name}: the wrapper parts from fit")
    return {"losses": gl, "fit_losses": rl, "loss_rel_err": loss_rel,
            "params_rel_err": rel, "share": share, "ms": got[2],
            "fit_ms": ref[2]}


def _gloo_rank(rank: int, world: int, port: int, out: str) -> None:
    """One of two gloo ranks on the card: each mode of
    :data:`PAR_GLOO_MODES` on the phase's batches from the same init;
    writes each mode's losses, params and launches to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, build_mesh
    from deeplearning4j_tpu_torch.parallel.mesh import init_distributed
    _cuda.build()
    init_distributed(f"tcp://localhost:{port}", world, rank, device="cuda",
                     backend="gloo")
    from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
        PipelineTrainer)
    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, softmax_cross_entropy)
    xs = _par_batches(PAR_GLOO_STEPS, SEED + 7)
    got = {}
    for mode in PAR_GLOO_MODES:
        if mode == "expert":
            got[mode] = _gloo_expert(kernels)
            continue
        net = _par_net()
        rec = _Losses()
        net.set_listeners(rec)
        b = ParallelWrapper.builder(net).prefetch_buffer(0)
        if mode == "zero3":
            b = b.sharding("zero3")
        elif mode == "ulysses":
            b = b.mesh(build_mesh({"data": 1, "sp": world})).sequence_parallel(
                "sp", "ulysses")
        elif mode == "dp_tp":
            b = b.mesh(build_mesh({"data": 1, "model": world})).sharding(
                "dp_tp")
        if mode == "pipeline":
            trainer = PipelineTrainer(net, mesh=build_mesh({"stage": world}),
                                      n_microbatches=PAR_PIPE_M)
            trainer.prefetch_depth = 0
            fit = trainer.fit
        else:
            fit = b.build().fit
        stamps = []

        class Stamp:
            def iteration_done(self, model, iteration):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

        net.add_listener(Stamp())
        _zero(kernels)
        fit(_par_iter(xs))
        got[mode] = {"losses": rec.values, "params": net.params().cpu(),
                     "launches": _launches(kernels),
                     "ms": 1e3 * (stamps[-1] - stamps[0]) / (len(stamps) - 1)}
        if mode == "pipeline":
            got[mode]["stats"] = trainer.stats()
        del net
    torch.save(got, out)
    dist.destroy_process_group()


def _first_moments(net) -> dict:
    """Adam's first moment of every param, by ``"layer/name"``, flat, on
    the host."""
    return {f"{i}/{name}": slots["m"].detach().reshape(-1).cpu().double()
            for i, layer in enumerate(net.updater_state)
            for name, slots in sorted(layer.items())}


def _local_grad(net, x) -> dict:
    """The gradient of the network's training loss on ``x`` (its dense
    path, no update) by ``"layer/name"``, flat, on the host."""
    from deeplearning4j_tpu_torch.nn.multilayer import _grads, loss_fn
    h = net._to_device(x)
    loss, _ = loss_fn(net, net.params_list, h, h, None)
    return {f"{i}/{name}": t.detach().reshape(-1).double().cpu()
            for i, layer in enumerate(_grads(loss, net.params_list))
            for name, t in sorted(layer.items())}


def _smooth_leaves(net) -> list:
    """The ``"layer/name"`` keys of the MoE LM's leaves no expert's ReLU
    slope reaches in the backward: the output layer's and the last MoE
    block's W2, b2 and Wg."""
    last = len(net.layers) - 1
    return ([f"{last}/{k}" for k in net.params_list[last]]
            + [f"{last - 1}/{k}" for k in ("W2", "b2", "Wg")])


def _gap(a: dict, b: dict, keys=None) -> float:
    """``||a - b|| / ||b||`` over ``keys`` (every key when None)."""
    keys = list(b) if keys is None else keys
    d = torch.cat([a[k] - b[k] for k in keys])
    return float(d.norm() / torch.cat([b[k] for k in keys]).norm())


@torch.no_grad()
def _relu_flips(card, cpu, x) -> list:
    """Per MoE block: the routed tokens' expert pre-activations (``x``'s
    tokens through their own expert's W1 and b1, on each device from its
    own forward) whose sign differs between the card and the CPU."""
    out = []
    hs = [card._to_device(x), cpu._to_device(x)]
    for i, layer in enumerate(cpu.layers):
        if layer.has_loss():
            break
        if isinstance(layer, MoETransformerBlock):
            signs = []
            for net, h in zip((card, cpu), hs):
                p, blk = net.params_list[i], net.layers[i]
                tokens = blk.ffn_tokens(p, h)[1]
                eidx = blk.route(p, tokens)[0]
                pre = torch.zeros(tokens.shape[0], p["W1"].shape[-1],
                                  dtype=torch.float32, device=h.device)
                for e in range(blk.n_experts):
                    sel = eidx == e
                    pre[sel] = tokens[sel] @ p["W1"][e] + p["b1"][e]
                signs.append((pre > 0).cpu())
            out.append(int((signs[0] != signs[1]).sum()))
        hs = [n.layers[i].apply_with_state(n.params_list[i], n.state_list[i],
                                           h)[0]
              for n, h in zip((card, cpu), hs)]
    return out


def _gloo_expert(kernels) -> dict:
    """A gloo rank's expert-parallel steps on the MoE LM over ``data``: one
    at ``PAR_EP_ROOMY`` (held by the parent against one rank's fit), then
    one at ``PAR_EP_DEFAULT`` from there, run on the card and on a CPU
    clone through the same group (the reference of the same function: the
    capacity, and so the tokens dropped, depend on the rank's rows)."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel import moe as ep

    xs = _moe_batches(2, SEED + 9)
    net = _moe_net()
    rec = _Losses()
    net.set_listeners(rec)

    def step(n, cf, x):
        (ParallelWrapper.builder(n).prefetch_buffer(0)
         .expert_parallel("data", cf).build().fit(_par_iter([x])))

    out = {}
    for name, cf, x in (("roomy", PAR_EP_ROOMY, xs[0]),
                        ("default", PAR_EP_DEFAULT, xs[1])):
        if name == "default":
            cpu = net.clone(device="cpu")
            cpu_rec = _Losses()
            cpu.set_listeners(cpu_rec)
            before = net.params().cpu()
            m_before = _first_moments(net)
            # this rank's rows routed on the card and on the CPU: a token
            # near a tie may take another expert, and so another slot
            import torch.distributed as dist
            mine = np.array_split(x, dist.get_world_size())[dist.get_rank()]
            routing = _route_agreement(moe_routes(net, mine),
                                       moe_routes(cpu, mine))
            # the dense path's gradient on the rows the step averages (the
            # whole batch), card against CPU: the yardstick of the step's
            # own distance, whole and on the leaves no ReLU slope reaches,
            # and the ReLU slopes that differ
            g_card, g_cpu = _local_grad(net, x), _local_grad(cpu, x)
            smooth = _smooth_leaves(net)
            dense_gap = {"all": _gap(g_card, g_cpu),
                         "smooth": _gap(g_card, g_cpu, smooth),
                         "relu_flips": _relu_flips(net, cpu, x)}
        _zero(kernels)
        ep.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(net, cf, x)
        torch.cuda.synchronize()
        out[name] = {"ms": 1e3 * (time.perf_counter() - t0),
                     "launches": _launches(kernels),
                     "params": net.params().cpu(), "loss": rec.values[-1],
                     "tokens": ep.stats()}
    ep.reset_stats()
    step(cpu, PAR_EP_DEFAULT, xs[1])
    out["default"].update(before=before, cpu_params=cpu.params().detach(),
                          cpu_loss=cpu_rec.values[-1],
                          cpu_tokens=ep.stats(), routing=routing,
                          m_before=m_before, m=_first_moments(net),
                          cpu_m=_first_moments(cpu), dense_gap=dense_gap,
                          smooth=smooth)
    return out


def _check_gloo_expert(runs) -> dict:
    """The two gloo ranks' expert-parallel steps: the roomy one against one
    rank's fit on the same batch, the default one against the same step on
    the CPU; launches exact."""
    xs = _moe_batches(1, SEED + 9)
    one = _moe_net()
    rec = _Losses()
    one.set_listeners(rec)
    one.fit(xs[0], xs[0])
    ref = one.params().cpu().double()
    del one
    out = {"launches": [], "roomy": {}, "default": {}}
    for rank, r in enumerate(runs):
        roomy, dflt = r["roomy"], r["default"]
        rel = float((roomy["params"].double() - ref).norm() / ref.norm())
        loss_rel = _rel(roomy["loss"], rec.values[0])
        cpu = dflt["cpu_params"].double()
        moved = float((cpu - dflt["before"].double()).norm())
        share = float((dflt["params"].double() - cpu).norm()
                      / max(moved, 1e-30))
        cpu_rel = _rel(dflt["loss"], dflt["cpu_loss"])
        # the step's gradient, card against CPU: Adam's first moment is
        # 0.9 m + 0.1 g, so ||m - m_cpu|| / ||m_cpu - 0.9 m_before|| is the
        # gradient's relative distance, held within PAR_EP_SMOOTH_TOL on
        # the leaves no ReLU slope reaches and within PAR_EP_MULT of the
        # dense path's on the whole (see PAR_EP_SMOOTH_TOL). The params
        # after the update are not held by their own distance: Adam
        # divides each entry by its own scale, so an entry whose gradient
        # is within rounding of 0 moves by up to the rate either way
        m_cpu, m0 = dflt["cpu_m"], dflt["m_before"]
        g_cpu = {k: m_cpu[k] - 0.9 * m0[k] for k in m_cpu}
        d_m = {k: dflt["m"][k] - 0.9 * m0[k] for k in m_cpu}
        grad_rel = _gap(d_m, g_cpu)
        smooth_rel = _gap(d_m, g_cpu, dflt["smooth"])
        dense = dflt["dense_gap"]
        grad_tol = PAR_EP_MULT * dense["all"]
        # the moe phase's rule: a token may take another expert on the card
        # than on the CPU only at a near-tie (gap <= MOE_TIE), and `flips`
        # (away from a near tie) must be 0. Where a near-tie did flip, the
        # slots and drops after it differ and the step is another
        # function: the gradient and the drops are then not held
        flips = sum(layer["flips"] for layer in dflt["routing"])
        tie_flips = sum(layer["flips_near_ties"]
                        for layer in dflt["routing"])
        print(f"parallel gloo expert rank {rank}: capacity "
              f"{PAR_EP_ROOMY:g} loss {roomy['loss']} (one rank "
              f"{rec.values[0]}), loss rel err {loss_rel:.3e}, params rel err "
              f"{rel:.3e} (tol {PAR_GLOO_TOL:.0e}), {roomy['ms']:.3f} ms, "
              f"tokens {roomy['tokens']}; capacity {PAR_EP_DEFAULT:g} loss "
              f"{dflt['loss']} (CPU {dflt['cpu_loss']}), loss rel err "
              f"{cpu_rel:.3e} (tol {PAR_TOL:.0e}), gradient rel err on the "
              f"leaves no ReLU slope reaches {smooth_rel:.3e} (tol "
              f"{PAR_EP_SMOOTH_TOL:.0e}; the dense path's {dense['smooth']:.3e}"
              f"), whole {grad_rel:.3e} (tol {grad_tol:.3e}: "
              f"{PAR_EP_MULT:g} x the dense path's {dense['all']:.3e} on the "
              f"whole batch, ReLU slopes differing card vs CPU by block "
              f"{dense['relu_flips']}), params' share of the distance moved "
              f"{share:.3e}, {dflt['ms']:.3f} ms, tokens {dflt['tokens']} "
              f"(CPU {dflt['cpu_tokens']}); routing card vs CPU by layer "
              f"{dflt['routing']}; gradient and drops held: "
              f"{tie_flips == 0}", flush=True)
        held = tie_flips == 0
        if not (rel <= PAR_GLOO_TOL and loss_rel <= PAR_GLOO_TOL
                and cpu_rel <= PAR_TOL and flips == 0
                and (not held or (
                    smooth_rel <= PAR_EP_SMOOTH_TOL and grad_rel <= grad_tol
                    and dflt["tokens"]["dropped"]
                    == dflt["cpu_tokens"]["dropped"]))):
            fail(f"parallel gloo expert rank {rank}: parts from its "
                 "reference")
        if roomy["tokens"]["dropped"]:
            fail(f"parallel gloo expert rank {rank}: capacity "
                 f"{PAR_EP_ROOMY:g} dropped tokens {roomy['tokens']}")
        want = {"flash_fwd": 4, "flash_bwd_dq": 4, "flash_bwd_dkv": 4,
                "softmax_cross_entropy": 1}
        for name in ("roomy", "default"):
            _check_launches(f"parallel gloo expert rank {rank} {name}",
                            r[name]["launches"], want)
        out["launches"].append({k: roomy["launches"][k]
                                + dflt["launches"][k] for k in want})
        for name, d in (("roomy", {"loss": roomy["loss"],
                                   "one_rank_loss": rec.values[0],
                                   "params_rel_err": rel,
                                   "loss_rel_err": loss_rel}),
                        ("default", {"loss": dflt["loss"],
                                     "cpu_loss": dflt["cpu_loss"],
                                     "loss_rel_err": cpu_rel,
                                     "grad_rel_err": grad_rel,
                                     "smooth_grad_rel_err": smooth_rel,
                                     "dense_grad_rel_err": dense,
                                     "held": held,
                                     "share": share,
                                     "cpu_tokens": dflt["cpu_tokens"],
                                     "routing": dflt["routing"]})):
            out[name].setdefault("ranks", []).append(
                dict(d, ms=r[name]["ms"], tokens=r[name]["tokens"]))
    return out


def parallel_phase(kernels) -> dict:
    """A7 on the card: ``ParallelWrapper`` on an NCCL group of one (every
    mode, each held against ``fit`` from the same state, the K-step group
    with its NCCL collectives captured in the CUDA graph), then two gloo
    ranks on the one card against one rank."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, build_mesh
    from deeplearning4j_tpu_torch.parallel.mesh import init_distributed

    counted = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, softmax_cross_entropy)
    out = {"modes": {}, "launches": {}}
    init_distributed(f"tcp://localhost:{_free_port()}", 1, 0)
    try:
        net = _par_net()
        snap = _snapshot(net)
        init = _flat_params(net)
        xs = _par_batches(PAR_SINGLE + 2 * PAR_K, SEED + 1)

        def fit_dp(n):
            n.dispatch_ksteps = 8
            for x in xs[:PAR_SINGLE]:
                n.fit(x, x)
            n.fit_iterator(_par_iter(xs[PAR_SINGLE:PAR_SINGLE + PAR_K]),
                           ksteps=PAR_K)

        def pw(n, **knobs):
            b = ParallelWrapper.builder(n).prefetch_buffer(0)
            for k, v in knobs.items():
                b = getattr(b, k)(*v)
            return b.build()

        launches = {}

        def wrapper_dp(n):
            from deeplearning4j_tpu_torch.observability import (
                global_recorder, names, tree_nbytes)
            w = pw(n)
            sent = ("all_reduce", "grad")
            series0 = _series(names.COLLECTIVE_BYTES_TOTAL, op=sent[0],
                              site=sent[1])
            stats0 = w.stats()["collective_bytes_total"].get(sent, 0)
            mark = len(global_recorder().snapshot())
            n.dispatch_ksteps = 1
            _zero(counted)
            w.fit(_par_iter(xs[:PAR_SINGLE]))
            launches["parallel_dp"] = _launches(counted)
            n.dispatch_ksteps = PAR_K
            _zero(counted)
            w.fit(_par_iter(xs[PAR_SINGLE:PAR_SINGLE + PAR_K]))
            launches["parallel_ksteps"] = _launches(counted)
            out["dp_stats"] = {k: v for k, v in w.stats().items()
                               if isinstance(k, str) and
                               not isinstance(v, dict)}
            # the series against the wrapper's stats and what it sent: one
            # all-reduce of the float32 gradients a step
            moved = (PAR_SINGLE + PAR_K) * tree_nbytes(n.params_list)
            series = _series(names.COLLECTIVE_BYTES_TOTAL, op=sent[0],
                             site=sent[1]) - series0
            stats = w.stats()["collective_bytes_total"].get(sent, 0) - stats0
            paths = [e["path"] for e in global_recorder().snapshot()[mark:]
                     if e["kind"] == "step"]
            steps = (paths.count("ParallelWrapper.sync_step"),
                     paths.count("ParallelWrapper.sync_multistep"))
            print(f"parallel dp series: dl4j_collective_bytes_total"
                  f"{{op=all_reduce,site=grad}} +{series:g}, stats "
                  f"+{stats}, sent {moved}; step events (single, group) "
                  f"{steps}", flush=True)
            if not series == stats == moved or steps != (PAR_SINGLE, 1):
                fail("parallel: the collective series or the step events")
            out["series"] = {"collective_bytes": series, "events": steps}

        ref = _par_run(net, snap, fit_dp)
        got = _par_run(net, snap, wrapper_dp)
        out["modes"]["dp"] = _par_check("sync DP (4 single + 8 K-step)", got,
                                        ref, init)
        want = {"flash_fwd": 4 * PAR_SINGLE, "flash_bwd_dq": 4 * PAR_SINGLE,
                "flash_bwd_dkv": 4 * PAR_SINGLE,
                "softmax_cross_entropy": PAR_SINGLE}
        _check_launches("parallel dp", launches["parallel_dp"], want)
        _check_launches("parallel K-step", launches["parallel_ksteps"],
                        {k: v * PAR_K // PAR_SINGLE for k, v in want.items()})

        # the K-step path timed warm: one call of two groups of 8, the
        # second replaying the first's capture; its 8 steps timed
        def fit_k(n):
            n.fit_iterator(_par_iter(xs[PAR_SINGLE:]), ksteps=PAR_K)

        def wrapper_k(n):
            # staged ahead by the prefetcher, as fit_iterator stages
            n.dispatch_ksteps = PAR_K
            pw(n, prefetch_buffer=(2,)).fit(_par_iter(xs[PAR_SINGLE:]))

        tk_fit = _par_run(net, snap, fit_k, warm=PAR_K)
        tk_pw = _par_run(net, snap, wrapper_k, warm=PAR_K)
        out["modes"]["ksteps_warm"] = {"ms": tk_pw[2], "fit_ms": tk_fit[2]}
        print(f"parallel K-step, two groups of 8: {tk_pw[2]:.3f} ms a step "
              f"(fit {tk_fit[2]:.3f})", flush=True)

        def fit_n(k):
            def run(n):
                for x in xs[:k]:
                    n.fit(x, x)
            return run

        for name, knobs, n_steps, tol in (
                ("zero3", {"sharding": ("zero3",)}, PAR_STEPS,
                 PAR_SHARE_TOL),
                ("local_sgd", {"averaging_frequency": (PAR_LOCAL_FREQ,)},
                 2 * PAR_STEPS, None),
                ("ulysses", {"mesh": (build_mesh({"data": 1, "sp": 1}),),
                             "sequence_parallel": ("sp", "ulysses")},
                 PAR_STEPS, PAR_SHARE_TOL),
                ("ring", {"mesh": (build_mesh({"data": 1, "sp": 1}),),
                          "sequence_parallel": ("sp", "ring")},
                 PAR_STEPS, PAR_SHARE_TOL)):
            def wrapper_mode(n, knobs=knobs, n_steps=n_steps):
                n.dispatch_ksteps = 1
                _zero(counted)
                pw(n, **knobs).fit(_par_iter(xs[:n_steps]))
                launches[f"parallel_{name}"] = _launches(counted)

            ref = _par_run(net, snap, fit_n(n_steps))
            got = _par_run(net, snap, wrapper_mode)
            out["modes"][name] = _par_check(name, got, ref, init, tol)
            flash = 0 if name == "ring" else 4 * n_steps
            _check_launches(f"parallel {name}", launches[f"parallel_{name}"],
                            {"flash_fwd": flash, "flash_bwd_dq": flash,
                             "flash_bwd_dkv": flash,
                             "softmax_cross_entropy": n_steps})
        # A7.5: PipelineTrainer on stage: 1, the schedule's M ticks on one
        # rank (M microbatches through the 4 blocks a step)
        from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
            PipelineTrainer)

        def pipeline_mode(n):
            _zero(counted)
            trainer = PipelineTrainer(n, mesh=build_mesh({"stage": 1}),
                                      n_microbatches=PAR_PIPE_M)
            trainer.fit(_par_iter(xs[:PAR_STEPS]))
            launches["parallel_pipeline"] = _launches(counted)
            out["pipeline_stats"] = trainer.stats()
            st = out["pipeline_stats"]
            if st["route"] != "none" or st.get("handoffs", 0):
                fail(f"parallel pipeline: a group of one made handoffs "
                     f"{st}")

        ref = _par_run(net, snap, fit_n(PAR_STEPS))
        got = _par_run(net, snap, pipeline_mode)
        out["modes"]["pipeline"] = _par_check(
            f"pipeline (stage 1, {PAR_PIPE_M} microbatches)", got, ref, init,
            PAR_SHARE_TOL)
        flash = PAR_PIPE_M * 4 * PAR_STEPS
        _check_launches("parallel pipeline", launches["parallel_pipeline"],
                        {"flash_fwd": flash, "flash_bwd_dq": flash,
                         "flash_bwd_dkv": flash,
                         "softmax_cross_entropy": PAR_STEPS})
        out["launches"] = launches
        del net, snap
        torch.cuda.empty_cache()

        # A7.6: expert parallelism on data: 1, the MoE LM at its bench
        # geometry: the capacity packing and an all_to_all of one rank
        from deeplearning4j_tpu_torch.parallel import moe as ep
        mnet = _moe_net()
        msnap = _snapshot(mnet)
        minit = _flat_params(mnet)
        mxs = _moe_batches(PAR_STEPS, SEED + 11)

        def moe_fit(n):
            for x in mxs:
                n.fit(x, x)

        def moe_expert(n):
            n.dispatch_ksteps = 1
            _zero(counted)
            ep.reset_stats()
            pw(n, expert_parallel=("data", PAR_EP_ROOMY)).fit(_par_iter(mxs))
            launches["parallel_expert"] = _launches(counted)
            out["expert_tokens"] = ep.stats()

        mref = _par_run(mnet, msnap, moe_fit)
        mgot = _par_run(mnet, msnap, moe_expert)
        out["modes"]["expert"] = _par_check(
            f"expert parallelism (data 1, capacity {PAR_EP_ROOMY:g})", mgot,
            mref, minit, PAR_SHARE_TOL)
        if out["expert_tokens"]["dropped"]:
            fail(f"parallel expert: capacity {PAR_EP_ROOMY:g} dropped tokens "
                 f"{out['expert_tokens']}")
        _check_launches("parallel expert", launches["parallel_expert"],
                        {"flash_fwd": 4 * PAR_STEPS,
                         "flash_bwd_dq": 4 * PAR_STEPS,
                         "flash_bwd_dkv": 4 * PAR_STEPS,
                         "softmax_cross_entropy": PAR_STEPS})
        del mnet, msnap
        torch.cuda.empty_cache()

        # ResNet-50 at the bench's shape: batch norm's group path
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            res = ComputationGraph(resnet50(), device="cuda").init(seed=SEED)
            rsnap = _snapshot(res)
            rinit = _flat_params(res)
            g = torch.Generator().manual_seed(SEED)
            # host batches for both paths: each pays its copy to the card
            rb = [tuple(t.numpy() for t in _res_batch(
                g, RES_B, RES_SIZE, RES_CLASSES, "cpu"))
                for _ in range(PAR_RES_STEPS)]

            def res_fit(n):
                for x, y in rb:
                    n.fit([x], [y])

            def res_pw(n):
                from deeplearning4j_tpu_torch.nn.graph_network import (
                    MultiDataSet)
                n.dispatch_ksteps = 1
                _zero(counted)
                pw(n).fit([MultiDataSet([x], [y]) for x, y in rb])
                launches["parallel_resnet50"] = _launches(counted)

            rref = _par_run(res, rsnap, res_fit)
            rgot = _par_run(res, rsnap, res_pw)
            gl, rl = rgot[0], rref[0]
            loss_rel = max(_rel(a, b) for a, b in zip(gl, rl))
            prel = float((rgot[1] - rref[1]).norm() / rref[1].norm())
            print(f"parallel ResNet-50 224x224 B {RES_B}: losses {gl} (fit "
                  f"{rl}); loss rel err {loss_rel:.3e}, params rel err "
                  f"{prel:.3e} (tol {PAR_RES_TOL:.0e}); {rgot[2]:.3f} ms a "
                  f"step (fit {rref[2]:.3f}); launches "
                  f"{launches['parallel_resnet50']}", flush=True)
            if not (loss_rel <= PAR_RES_TOL and prel <= PAR_RES_TOL
                    and all(np.isfinite(gl))):
                fail("parallel ResNet-50: the wrapper parts from fit")
            _check_launches("parallel ResNet-50",
                            launches["parallel_resnet50"],
                            {"flash_fwd": 0, "flash_bwd_dq": 0,
                             "flash_bwd_dkv": 0,
                             "softmax_cross_entropy": PAR_RES_STEPS})
            out["modes"]["resnet50"] = {
                "losses": gl, "fit_losses": rl, "loss_rel_err": loss_rel,
                "params_rel_err": prel, "ms": rgot[2], "fit_ms": rref[2]}
            del res, rsnap, rb
        finally:
            torch.backends.cudnn.deterministic = prev
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (b) two gloo ranks on the one card, against one rank on the card
    import shutil
    import tempfile

    xs = _par_batches(PAR_GLOO_STEPS, SEED + 7)
    one = _par_net()
    snap = _snapshot(one)
    one_ms = _par_run(one, snap, lambda n: [n.fit(x, x) for x in xs])[2]
    rec = _Losses()
    _restore(one, snap)
    one.set_listeners(rec)
    for x in xs:
        one.fit(x, x)
    ref_params = one.params().cpu()
    del one, snap
    tmp = tempfile.mkdtemp(prefix="parallel_gloo_")
    files = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, 2, port, files[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        fail(f"parallel gloo: rank exit codes {[p.exitcode for p in procs]}")
    ranks = [torch.load(f) for f in files]
    shutil.rmtree(tmp)
    out["gloo"] = {}
    for mode in PAR_GLOO_MODES:
        runs = [r[mode] for r in ranks]
        if mode == "expert":
            out["gloo"][mode] = _check_gloo_expert(runs)
            continue
        rel = max(float((r["params"] - ref_params).double().norm()
                        / ref_params.double().norm()) for r in runs)
        loss_rel = max(_rel(a, b) for r in runs
                       for a, b in zip(r["losses"], rec.values))
        ms = max(r["ms"] for r in runs)
        print(f"parallel gloo {mode}, 2 ranks on the card: losses "
              f"{runs[0]['losses']} (one rank {rec.values}); loss rel err "
              f"{loss_rel:.3e}, params rel err {rel:.3e} (tol "
              f"{PAR_GLOO_TOL:.0e}); per-rank launches "
              f"{[r['launches'] for r in runs]}; {ms:.3f} ms a step after "
              f"the first (one rank {one_ms:.3f})", flush=True)
        if not (rel <= PAR_GLOO_TOL and loss_rel <= PAR_GLOO_TOL):
            fail(f"parallel gloo {mode}: two ranks part from one")
        for rank, r in enumerate(runs):
            # every mode runs the 4 blocks' attention a step on each rank
            # (dp_tp on 2 of the 4 heads), except the pipeline: M
            # microbatches through the rank's 2 blocks, the loss on the
            # last stage only
            flash, xent = 4 * PAR_GLOO_STEPS, PAR_GLOO_STEPS
            if mode == "pipeline":
                flash = PAR_PIPE_M * 4 // len(runs) * PAR_GLOO_STEPS
                xent = PAR_GLOO_STEPS if rank == len(runs) - 1 else 0
            _check_launches(f"parallel gloo {mode} rank {rank}",
                            r["launches"],
                            {"flash_fwd": flash, "flash_bwd_dq": flash,
                             "flash_bwd_dkv": flash,
                             "softmax_cross_entropy": xent})
        out["gloo"][mode] = {
            "losses": [r["losses"] for r in runs], "one_rank": rec.values,
            "params_rel_err": rel, "loss_rel_err": loss_rel,
            "launches": [r["launches"] for r in runs], "ms": ms,
            "one_rank_ms": one_ms}
        if mode == "pipeline":
            out["gloo"][mode]["stats"] = [r["stats"] for r in runs]
            print(f"parallel gloo pipeline stats {out['gloo'][mode]['stats']}",
                  flush=True)
            # gloo fails batch_isend_irecv on CUDA tensors: the handoffs
            # take all_to_all_single there
            if any(r["stats"]["route"] != "all_to_all" for r in runs):
                fail("parallel gloo pipeline: the handoffs did not take the "
                     "all_to_all route")
    print(f"parallel: {CARD}; ms a step by mode "
          f"{ {k: round(v['ms'], 3) for k, v in out['modes'].items()} } "
          f"beside fit's "
          f"{ {k: round(v['fit_ms'], 3) for k, v in out['modes'].items()} }",
          flush=True)
    return out


#: the param_server and elastic phases (A7.3, A7.4, A7.8's checkpoints):
#: the train phase's full-width transformer_lm(256) at B = 16, T = 256 on
#: batches made as the parallel phase makes them. One inproc worker at push
#: frequency 4 over 8 batches is held against fit at the JAX suite's
#: single-worker tolerance (tests/test_param_server.py)
PS_BATCHES, PS_FREQ, PS_RTOL, PS_ATOL = 8, 4, 2e-4, 2e-5
#: two workers (threads, then processes) at push frequency 2
PS_MANY_FREQ = 2
#: the elastic run: 16 batches over 2 shards, each worker sleeping this long
#: a step so that the chaos kill lands mid-shard
EL_BATCHES, EL_DELAY = 16, 0.25
_PS_COUNTED = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
               "softmax_cross_entropy")


def _ps_want(steps: int) -> dict:
    """Exact launches of ``steps`` train steps of transformer_lm(256): each
    of its 4 layers launches each flash kernel once, the loss sm_xent once."""
    return {"flash_fwd": 4 * steps, "flash_bwd_dq": 4 * steps,
            "flash_bwd_dkv": 4 * steps, "softmax_cross_entropy": steps}


def _ps_score(net, xs) -> float:
    return float(np.mean([net.score(x, x) for x in xs]))


def _worker_launches(stats: dict) -> dict:
    return {k: stats["launches"].get(k, 0) for k in _PS_COUNTED}


def _check_workers(what: str, stats: list, steps: int) -> dict:
    """Each worker process's own launches against its steps, all on the
    card; returns their sum."""
    if sum(s["steps"] for s in stats) != steps:
        fail(f"{what}: worker steps {[s['steps'] for s in stats]} != {steps}")
    total = dict.fromkeys(_PS_COUNTED, 0)
    for s in stats:
        if not s["device"].startswith("cuda"):
            fail(f"{what}: a worker trained on {s['device']}")
        _check_launches(f"{what} worker {s['worker_id']}",
                        _worker_launches(s), _ps_want(s["steps"]))
        for k in total:
            total[k] += s["launches"][k]
    return total


#: the elastic phase's series, by the trainer's stats key
_EL_SERIES = {"joins": "dl4j_elastic_joins_total",
              "handoffs": "dl4j_elastic_handoffs_total",
              "fenced": "dl4j_elastic_fenced_pushes_total"}


def _ps_series() -> dict:
    return {"pushes": _series("dl4j_ps_pushes_total", outcome="applied"),
            "rejected": _series("dl4j_ps_pushes_total", outcome="rejected"),
            "pulls": _series("dl4j_ps_pulls_total"),
            "worker_steps": _series("dl4j_ps_worker_steps_total"),
            "staleness": _series("dl4j_ps_staleness")}


def _family_sum(series: dict, name: str, **labels) -> float:
    """A family of a worker's reported series summed over the series whose
    labels include ``labels``."""
    return sum(s["value"] for s in series.get(name, [])
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def param_server_phase(kernels) -> dict:
    """A7.3 on the card: ``ParameterServerParallelWrapper`` with one inproc
    worker against ``fit`` (JAX's tolerance, exact launches, 2 pushes), two
    inproc workers, then two worker processes over tcp with bf16 deltas and
    two over shm, each reporting the launches of its own process."""
    from deeplearning4j_tpu_torch.parallel import ps_transport as pst
    from deeplearning4j_tpu_torch.parallel.param_server import (
        ParameterServerParallelWrapper as PSW)

    counted = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, softmax_cross_entropy)
    out = {"launches": {}}
    xs = _par_batches(PS_BATCHES, SEED + 11)
    net = _par_net()
    snap = _snapshot(net)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in xs:
        net.fit(x, x)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0) / PS_BATCHES
    ref = net.params().detach().clone()

    # (a) one inproc worker: each window lands at staleness 0, weight 1
    _restore(net, snap)
    w = PSW.builder(net).workers(1).push_frequency(PS_FREQ).build()
    _zero(counted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w.fit(_par_iter(xs))
    torch.cuda.synchronize()
    one_ms = 1e3 * (time.perf_counter() - t0) / PS_BATCHES
    out["launches"]["param_server_inproc"] = got_l = _launches(counted)
    got = net.params().detach()
    err = (got - ref).abs()
    ratio = float((err / (PS_ATOL + PS_RTOL * ref.abs())).max())
    print(f"param_server one inproc worker (push frequency {PS_FREQ}, "
          f"{PS_BATCHES} batches): max abs err {float(err.max()):.3e} "
          f"against fit, worst share of rtol {PS_RTOL:.0e} atol "
          f"{PS_ATOL:.0e} {ratio:.3f}; pushes {w.server.pushes}; "
          f"{one_ms:.3f} ms a step (fit {fit_ms:.3f}); launches {got_l}",
          flush=True)
    if ratio > 1.0 or w.server.pushes != 2 \
            or w.worker_stats[0]["steps"] != PS_BATCHES:
        fail("param_server: one worker parts from fit")
    _check_launches("param_server one worker", got_l, _ps_want(PS_BATCHES))
    out["one_worker"] = {"max_abs_err": float(err.max()), "tol_share": ratio,
                         "pushes": w.server.pushes, "ms": one_ms,
                         "fit_ms": fit_ms}

    # (b) two inproc workers: every step counted, version == pushes
    _restore(net, snap)
    s0 = _ps_score(net, xs[:2])
    w = PSW.builder(net).workers(2).push_frequency(PS_MANY_FREQ).build()
    series0 = _ps_series()
    _zero(counted)
    t0 = time.perf_counter()
    w.fit(_par_iter(xs))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / PS_BATCHES
    out["launches"]["param_server_inproc2"] = got_l = _launches(counted)
    s1 = _ps_score(net, xs[:2])
    srv = w.server.stats()
    got_series = {k: v - series0[k] for k, v in _ps_series().items()}
    want_series = {"pushes": srv["pushes"], "rejected": srv["rejected"],
                   "pulls": srv["pulls"], "worker_steps": PS_BATCHES,
                   "staleness": sum(srv["staleness"].values())}
    print(f"param_server two inproc workers' series {got_series} against "
          f"the server's stats and the steps run {want_series}; version "
          f"gauge {_series('dl4j_ps_version'):g}", flush=True)
    if {k: got_series[k] for k in want_series} != want_series \
            or _series("dl4j_ps_version") != srv["version"]:
        fail("param_server: the series disagree with the server's stats")
    print(f"param_server two inproc workers: steps "
          f"{[s['steps'] for s in w.worker_stats]}, server {srv}; score "
          f"{s0:.5f} -> {s1:.5f}; {ms:.3f} ms a step; launches {got_l}",
          flush=True)
    if (sum(s["steps"] for s in w.worker_stats) != PS_BATCHES
            or srv["version"] != srv["pushes"] or not s1 < s0):
        fail("param_server: two inproc workers")
    _check_launches("param_server two workers", got_l, _ps_want(PS_BATCHES))
    out["two_inproc"] = {"server": srv, "score": [s0, s1], "ms": ms}
    out["series"] = {"inproc": got_series}

    # (c) two worker processes on the card over tcp (bf16 deltas), then
    # over shm: each reports the launches of its own process
    for transport, codec in (("tcp", "bf16"), ("shm", "none")):
        _restore(net, snap)
        s0 = _ps_score(net, xs[:2])
        w = (PSW.builder(net).workers(2).push_frequency(PS_MANY_FREQ)
             .transport(transport).compression(codec).build())
        _zero(counted)
        t0 = time.perf_counter()
        w.fit(_par_iter(xs))
        wall = time.perf_counter() - t0
        here = _launches(counted)
        s1 = _ps_score(net, xs[:2])
        if any(here.values()):
            fail(f"param_server {transport}: the coordinator launched {here}")
        total = _check_workers(f"param_server {transport}",
                               w.worker_stats, PS_BATCHES)
        out["launches"][f"param_server_{transport}"] = total
        tstats = [s["transport"] for s in w.worker_stats]
        print(f"param_server two {transport} worker processes ({codec}): "
              f"steps {[s['steps'] for s in w.worker_stats]}, pushes "
              f"{[s['pushes'] for s in w.worker_stats]}, rebased "
              f"{[s['rebased'] for s in w.worker_stats]}; shard routes "
              f"{w.shard_routes}; transports {tstats}; score {s0:.5f} -> "
              f"{s1:.5f}; {wall:.1f}s wall with the workers' start; "
              f"launches {[_worker_launches(s) for s in w.worker_stats]}",
              flush=True)
        if not s1 < s0:
            fail(f"param_server {transport}: the loss did not fall")
        if transport == "shm" and not (
                w.shard_routes == ["shm", "shm"]
                and all(t["shm_active"] and t["shm_pushes"] == s["pushes"]
                        for t, s in zip(tstats, w.worker_stats))):
            fail("param_server shm: the shared-memory route was not taken")
        if pst.orphan_segments():
            fail(f"param_server {transport}: orphan segments "
                 f"{pst.orphan_segments()}")
        # each worker process's series against its transport's stats
        checks = []
        for ws in w.worker_stats:
            t, ser = ws["transport"], ws["series"]
            if transport == "tcp":
                got = _family_sum(ser, "dl4j_ps_wire_bytes_total", op="push")
                want = t["push_bytes"]
            else:
                got = _family_sum(ser, "dl4j_shm_bytes_total",
                                  direction="push")
                want = t["shm_push_bytes"]
            checks.append((got, want))
        print(f"param_server {transport} workers' series (got, stats): "
              f"{checks}", flush=True)
        if any(g != wnt or not g for g, wnt in checks):
            fail(f"param_server {transport}: the workers' series")
        out["series"][transport] = checks
        out[transport] = {"score": [s0, s1], "wall_s": wall,
                          "workers": w.worker_stats,
                          "shard_routes": w.shard_routes}
    out["traced_push"] = traced_tcp_push(net)
    del net, snap
    torch.cuda.empty_cache()
    return out


def traced_tcp_push(net) -> dict:
    """One traced push over the TCP transport: a worker's window span, its
    ``ps.push`` RPC span stamping ``traceparent`` into the frame header, and
    the frontend's ``ps.apply`` (on the frontend's own thread, which the
    header alone reaches) under the same trace id, parented on the RPC
    span."""
    from deeplearning4j_tpu_torch.observability import tracing as tr
    from deeplearning4j_tpu_torch.parallel import ps_transport as pst
    from deeplearning4j_tpu_torch.parallel.param_server import (
        ParameterServer)
    server = ParameterServer(net.params_list)
    frontend = pst.ParameterServerTcpFrontend(server).start()
    transport = pst.TcpTransport(("127.0.0.1", frontend.port))
    try:
        version, vec = transport.pull()
        with tr.trace_span("ps.push_window", worker="chip") as root:
            res = transport.push(np.zeros_like(vec), version)
    finally:
        transport.close()
        frontend.stop()
    deadline = time.perf_counter() + 10.0
    while True:
        rec = tr.global_trace_store().get(root.trace_id)
        names = {s["name"]: s for s in (rec or {}).get("spans", [])}
        if "ps.apply" in names or time.perf_counter() > deadline:
            break
        time.sleep(0.01)
    ok = ("ps.apply" in names and "ps.push" in names
          and names["ps.apply"]["trace_id"] == root.trace_id
          and names["ps.apply"]["parent_id"] == names["ps.push"]["span_id"]
          and names["ps.push"]["parent_id"] == root.span_id)
    print(f"param_server traced tcp push: accepted {res.accepted}; spans "
          f"{sorted(names)} under trace {root.trace_id}", flush=True)
    if not ok or not res.accepted:
        fail("param_server: ps.apply did not join the worker's trace")
    return {"trace_id": root.trace_id, "spans": sorted(names)}


def elastic_phase(kernels) -> dict:
    """A7.4 and A7.8's checkpoints on the card: an ``ElasticTrainer`` of two
    shm worker processes, one SIGKILLed after its group's first committed
    window; then a sharded checkpoint and an async one round trip."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.parallel import ps_transport as pst
    from deeplearning4j_tpu_torch.parallel.elastic import ElasticTrainer
    from deeplearning4j_tpu_torch.utils.sharded_checkpoint import (
        AsyncShardedSaver, restore_sharded, save_sharded)

    counted = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, softmax_cross_entropy)
    out = {}
    xs = _par_batches(EL_BATCHES, SEED + 13)
    net = _par_net()
    s0 = _ps_score(net, xs[:2])
    trainer = (ElasticTrainer.builder(net).workers(2).push_frequency(2)
               .transport("shm").lease_timeout(30.0).respawn(True)
               .worker_delays(EL_DELAY, EL_DELAY).fit_timeout(300.0).build())
    killed = {}

    def assassin():
        deadline = time.monotonic() + 240.0
        while time.monotonic() < deadline:
            at = trainer.committed_offset(0)
            if at >= 1:  # the first window of shard 0 committed
                killed["committed"] = at
                killed["ok"] = trainer.chaos_kill(0)
                return
            time.sleep(0.005)

    th = threading.Thread(target=assassin, daemon=True)
    el0 = {k: _series(name) for k, name in _EL_SERIES.items()}
    _zero(counted)
    th.start()
    t0 = time.perf_counter()
    trainer.fit(_par_iter(xs))
    wall = time.perf_counter() - t0
    th.join(10)
    s1 = _ps_score(net, xs[:2])
    commits = trainer.shard_commits
    st = trainer.stats
    orphans = pst.orphan_segments()
    print(f"elastic: killed shard 0 at committed offset "
          f"{killed.get('committed')} ({killed.get('ok')}); shard commits "
          f"{commits}; stats {st}; worker steps "
          f"{[(s['shard'], s['steps']) for s in trainer.worker_stats]}; "
          f"score {s0:.5f} -> {s1:.5f}; orphan segments {orphans}; "
          f"{wall:.1f}s wall", flush=True)
    if not killed.get("ok") or trainer.handoffs < 1:
        fail("elastic: the chaos kill did not hand a shard off")
    if any(c["committed"] < c["fin"] for c in commits):
        fail(f"elastic: a shard lost samples: {commits}")
    if orphans or pst.segment_stats()["owned"]:
        fail(f"elastic: segments left: {orphans}, {pst.segment_stats()}")
    if st["joins"] != 2 + trainer.handoffs or not s1 < s0:
        fail("elastic: joins or loss")
    series = {k: _series(name) - el0[k] for k, name in _EL_SERIES.items()}
    print(f"elastic series {series} against the trainer's stats (joins "
          f"{st['joins']}, handoffs {trainer.handoffs}, fenced "
          f"{st['fenced']})", flush=True)
    if (series["joins"] != st["joins"] or series["handoffs"]
            != trainer.handoffs or series["fenced"] != st["fenced"]):
        fail("elastic: the series disagree with the trainer's stats")
    steps = sum(s["steps"] for s in trainer.worker_stats)
    launches = _check_workers("elastic", trainer.worker_stats, steps)
    out["run"] = {"killed_at": killed.get("committed"), "commits": commits,
                  "stats": st, "score": [s0, s1], "wall_s": wall,
                  "workers": trainer.worker_stats, "launches": launches,
                  "series": series}

    # sharded checkpoints on the card: a fit step fills Adam's state first
    net.fit(xs[0], xs[0])
    tmp = tempfile.mkdtemp(prefix="elastic_ck_")
    try:
        t0 = time.perf_counter()
        d = save_sharded(os.path.join(tmp, "sync"), net, step=1)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = restore_sharded(d, device="cuda")
        restore_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(
            _tensors_of([back.params_list, back.state_list,
                         back.updater_state]),
            _tensors_of([net.params_list, net.state_list,
                         net.updater_state])))
        if not same or back.iteration != net.iteration \
                or back.device.type != "cuda":
            fail("elastic: the sharded checkpoint did not round trip")
        del back
        saver = AsyncShardedSaver()
        t0 = time.perf_counter()
        d2 = saver.save(os.path.join(tmp, "async"), net, step=2)
        async_return_s = time.perf_counter() - t0
        early = os.path.exists(os.path.join(d2, "meta.json"))
        snap = _snapshot(net)
        net.fit(xs[1], xs[1])  # trains on while the write is in flight
        saver.wait()
        committed = os.path.exists(os.path.join(d2, "meta.json"))
        back = restore_sharded(d2, device="cuda")
        same_async = all(torch.equal(a, b) for a, b in zip(
            _tensors_of([back.params_list, back.updater_state]),
            _tensors_of([snap[0][0], snap[0][2]])))
        print(f"elastic sharded checkpoint on the card: save {save_s:.2f}s, "
              f"restore {restore_s:.2f}s, bitwise {same}; async save "
              f"returned in {async_return_s:.3f}s, sidecar before wait "
              f"{early}, after {committed}, the save-time state bitwise "
              f"{same_async}", flush=True)
        if early or not committed or not same_async:
            fail("elastic: the async sharded checkpoint's commit order")
        out["checkpoint"] = {"save_s": save_s, "restore_s": restore_s,
                             "async_return_s": async_return_s}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del net
    torch.cuda.empty_cache()
    return out


#: A7.8's second half: the served model's pins on a device mesh of four
#: slots on the one card, the batch sizes held, the replicas' requests
#: (two rows of SH_T ids, one dispatch each at max_batch 2), the steps of
#: the fits on two gloo ranks
SH_AXES = {"data": 2, "model": 2}
SH_SIZES = (1, 2, 3, 4, 8)
SH_T, SH_REQUESTS, SH_THREADS, SH_SWAP_AT = 128, 32, 4, 12
SH_STEPS = 2
#: a sharded pin computes each row as the whole pin does: the flash
#: forward's key splits follow the head dim and T alone, and every
#: float32 dense product of a pin runs through ops/fixed_matmul.py, whose
#: answer for a row does not depend on the row count (cuBLAS's does, C3).
#: So the sharded pin is held bitwise against the whole pin at every batch
#: size, float32 and int8, as the JAX package holds its sharded pin
#: the fits from a restore against one rank's fit from the whole restore
#: (PR 19's dp_tp bound)
SH_FIT_TOL = 1e-4
SH_VIEW_MODES = ("dp_tp", "zero3", "pipeline")


def _sh_devices(n: int) -> list:
    return ["cuda:0"] * n


#: the dense products of one forward of transformer_lm(256): Wqkv, Wo,
#: W1, W2 in each of 4 blocks, and the head
SH_PIN_PRODUCTS = 4 * 4 + 1


def _pin_products(route: str):
    """The pins' products through fixed_matmul (``"fixed"``, as the port
    runs them) or, for the before-and-after timing alone, through cuBLAS
    (``"cublas"``)."""
    import contextlib
    from deeplearning4j_tpu_torch.nn import inference
    if route == "fixed":
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def cublas():
        keep = inference.row_invariant_matmuls
        inference.row_invariant_matmuls = contextlib.nullcontext
        try:
            yield
        finally:
            inference.row_invariant_matmuls = keep
    return cublas()


def _sh_hold(pf, ref, ids) -> dict:
    """The sharded pin's output on ``ids`` against the whole pin's, which
    must be bitwise; the distance is kept for the record when not."""
    got, want = pf(ids), ref(ids)
    same = bool(torch.equal(got, want))
    return {"bitwise": same, "rel_err": 0.0 if same else _norm_rel(got, want),
            "ok": same}


def _norm_rel(got, want) -> float:
    d = (got.double() - want.double()).norm()
    return float(d / want.double().norm())


def _sh_pins(kernels) -> dict:
    """(a) the served transformer pinned dp_tp on the device mesh, float32
    and int8, against the whole pin at each batch size."""
    from deeplearning4j_tpu_torch.nn.inference import make_predict_fn
    from deeplearning4j_tpu_torch.parallel import build_mesh, partition
    V = 256
    net = MultiLayerNetwork(transformer_lm(V), device="cuda").init(seed=SEED)
    mesh = build_mesh(SH_AXES, devices=_sh_devices(4))
    rng = np.random.default_rng(SEED + 41)
    out = {"sizes": {}, "launches": 0, "fixed_matmul_launches": 0}
    for quant in (None, "int8"):
        label = quant or "float32"
        ref = make_predict_fn(net, device="cuda", quant=quant)
        pf = make_predict_fn(net, sharding="dp_tp", mesh=mesh, quant=quant)
        per = pf.per_device_param_bytes
        math = partition.per_device_bytes(pf.params_snapshot(),
                                          pf.param_specs, mesh)
        held = pf.slot_param_bytes()
        print(f"sharded (a) {label}: per-device param bytes {per} (partition "
              f"math {math}, each slot's tensors {held}; whole "
              f"{pf.param_bytes})", flush=True)
        gauge = _series("dl4j_sharded_param_bytes_per_device",
                        rule_set="dp_tp")
        print(f"sharded (a) {label}: dl4j_sharded_param_bytes_per_device"
              f"{{rule_set=dp_tp}} {gauge:g}", flush=True)
        if not (per == math == gauge and held == [per] * mesh.size
                and per < pf.param_bytes):
            fail(f"sharded (a) {label}: per-device bytes disagree")
        for B in SH_SIZES:
            ids = rng.integers(0, V, size=(B, 512)).astype(np.float32)
            _zero(kernels)
            fixed_matmul.launches = 0
            got = pf(ids)
            torch.cuda.synchronize()
            n, n_mm = flash_fwd.launches, fixed_matmul.launches
            # 4 attention forwards for each data slot that runs rows: both
            # when the data axis divides B, the first alone otherwise; and
            # each slot's dense products: 4 a block and the head's
            slots = SH_AXES["data"] if B % SH_AXES["data"] == 0 else 1
            want, want_mm = 4 * slots, SH_PIN_PRODUCTS * slots
            if got.shape != (B, 512, V) or not torch.isfinite(got).all():
                fail(f"sharded (a) {label} B={B}: shape {tuple(got.shape)}")
            if n != want or n_mm != want_mm or any(
                    fn.launches for fn in kernels if fn is not flash_fwd):
                fail(f"sharded (a) {label} B={B}: flash_fwd launched {n}, "
                     f"want {want}; fixed_matmul {n_mm}, want {want_mm}")
            out["launches"] += n
            out["fixed_matmul_launches"] += n_mm
            held_to = _sh_hold(pf, ref, ids)
            print(f"sharded (a) {label} B={B}: {n} flash_fwd launches "
                  f"(want {want}), {n_mm} fixed_matmul (want {want_mm}); "
                  f"against the whole pin {held_to}", flush=True)
            if not held_to["ok"]:
                fail(f"sharded (a) {label} B={B}: {held_to}")
            out["sizes"][f"{label}_{B}"] = held_to
        ids = rng.integers(0, V, size=(8, 512)).astype(np.float32)
        walls = {}
        # in turns: the pins' products through fixed_matmul, and through
        # cuBLAS as before C3's repair (the harness swaps the pin's
        # context for a no-op; the port has no such switch)
        for route in ("fixed", "cublas", "cublas", "fixed"):
            for name, fn in (("sharded", pf), ("whole", ref)):
                with _pin_products(route):
                    fn(ids)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(10):
                        fn(ids)
                    torch.cuda.synchronize()
                walls.setdefault(f"{name}_{route}", []).append(
                    1e3 * (time.perf_counter() - t0) / 10)
        walls = {k: float(np.mean(v)) for k, v in walls.items()}
        print(f"sharded (a) {label}: predict [8, 512] wall ms, products "
              f"through fixed_matmul: sharded {walls['sharded_fixed']:.3f}, "
              f"whole {walls['whole_fixed']:.3f}; through cuBLAS: sharded "
              f"{walls['sharded_cublas']:.3f}, whole "
              f"{walls['whole_cublas']:.3f} [{CARD}]", flush=True)
        out[label] = {"per_device_param_bytes": per,
                      "param_bytes": pf.param_bytes, "wall_ms": walls}
    del net
    return out


def _sh_replicas(kernels) -> dict:
    """(b) two sharded replicas over HTTP, a rolling swap in flight."""
    from deeplearning4j_tpu_torch.nn.inference import make_predict_fn
    from deeplearning4j_tpu_torch.parallel import build_mesh
    V = 256
    nets = {v: MultiLayerNetwork(transformer_lm(V), device="cuda").init(
        seed=SEED + i) for i, v in enumerate(("v1", "v2"))}
    mesh = build_mesh(SH_AXES, devices=_sh_devices(4))
    pins = {v: make_predict_fn(n, sharding="dp_tp", mesh=mesh)
            for v, n in nets.items()}
    whole = {v: make_predict_fn(n, device="cuda") for v, n in nets.items()}
    rng = np.random.default_rng(SEED + 43)
    ids = rng.integers(0, V, size=(SH_REQUESTS, 2, SH_T)).astype(np.float32)
    srv = InferenceServer(replicas=2, sharding="dp_tp", device="cuda",
                          replica_devices=_sh_devices(8), max_batch=2)
    srv.start()
    answers = [None] * SH_REQUESTS
    done = threading.Semaphore(0)
    # the last round of requests goes out once the rolling swap has
    # returned, so v2 answers whatever the swap's length; the rounds before
    # it run while the swap is in flight
    swapped = threading.Event()
    try:
        srv.register("lm", nets["v1"], version="v1")
        _zero(kernels)

        def client(w):
            for j in range(w, SH_REQUESTS, SH_THREADS):
                if j >= SH_REQUESTS - SH_THREADS:
                    swapped.wait(600)
                answers[j] = post(srv.port, "/v1/predict",
                                  {"model": "lm", "inputs": ids[j].tolist()})
                done.release()

        threads = [threading.Thread(target=client, args=(w,), daemon=True)
                   for w in range(SH_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for _ in range(SH_SWAP_AT):
            if not done.acquire(timeout=600):
                fail("sharded (b): requests stalled")
        try:
            srv.register("lm", nets["v2"], version="v2")
        finally:
            swapped.set()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = flash_fwd.launches
        st = srv.status()
    finally:
        srv.stop()
    versions, worst = [], 0.0
    for j, ans in enumerate(answers):
        if ans is None or ans[0] != 200:
            fail(f"sharded (b): request {j} answered {ans and ans[0]}")
        body = json.loads(ans[1])
        v = body["version"]
        versions.append(v)
        got = torch.tensor(np.asarray(body["predictions"], np.float32))
        # the answer is the sharded pin's, and the whole pin's, bitwise
        if not torch.equal(got, pins[v](ids[j]).cpu()):
            fail(f"sharded (b): request {j} is not the sharded pin's answer")
        worst = max(worst, _norm_rel(got, whole[v](ids[j]).cpu()))
    reps = st["replicas"]["replicas"]
    print(f"sharded (b): {SH_REQUESTS} requests in {wall:.2f}s, versions "
          f"{ {v: versions.count(v) for v in ('v1', 'v2')} }, worst rel err "
          f"against the whole pin {worst:.3e} (bitwise wanted); "
          f"flash_fwd {launches} (want {8 * SH_REQUESTS}); replicas "
          f"{[(r['slots'], r['mesh'], r['devices'], r['active'], r['routed']) for r in reps]}",
          flush=True)
    if worst != 0.0 or "v2" not in versions or versions[-1] != "v2":
        fail("sharded (b): answers or the swap")
    if launches != 8 * SH_REQUESTS:
        fail(f"sharded (b): flash_fwd launched {launches}")
    for r in reps:
        if (r["mesh"] != SH_AXES or len(r["slots"]) != 4
                or r["sharding"] != "dp_tp" or r["active"] != {"lm": "v2"}
                or not r["routed"]):
            fail(f"sharded (b): replica status {r}")
    del nets, pins, whole
    return {"launches": launches, "wall_s": wall, "rel_err": worst,
            "versions": versions, "replicas": reps}


def _sh_launches(kernels) -> dict:
    return {fn.__name__: fn.launches for fn in kernels}


def _sh_rank(rank: int, world: int, port: int, out: str, tmp: str) -> None:
    """One of two gloo ranks on the card: (c) a restore onto the dp_tp
    sharding and fits from it, (d) the three fits with listeners that read
    a whole view, each beside the same fit without them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.optimize.listeners import (
        CheckpointListener, ParamAndGradientIterationListener)
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, build_mesh, partition)
    from deeplearning4j_tpu_torch.parallel.mesh import init_distributed
    from deeplearning4j_tpu_torch.parallel.pipeline_trainer import (
        PipelineTrainer)
    from deeplearning4j_tpu_torch.utils.model_serializer import (
        restore_multi_layer_network)
    from deeplearning4j_tpu_torch.utils.sharded_checkpoint import (
        restore_sharded)
    _cuda.build()
    init_distributed(f"tcp://localhost:{port}", world, rank, device="cuda",
                     backend="gloo")
    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, softmax_cross_entropy)
    xs = _par_batches(SH_STEPS + 1, SEED + 45)
    tp_mesh = build_mesh({"data": 1, "model": world})
    got = {}

    def wrapper_fit(net, mesh, knobs):
        b = ParallelWrapper.builder(net).prefetch_buffer(0).mesh(mesh)
        for k, v in knobs:
            b = getattr(b, k)(*v)
        return b.build()

    # (c): a sharded checkpoint of the train-shape model after one dp_tp
    # step (its blocks on disk), restored onto the dp_tp specs
    ck = os.path.join(tmp, "ck")
    net = _par_net()
    net.set_listeners(CheckpointListener(ck, every_n_iterations=1,
                                         every_n_epochs=None, sharded=True))
    wrapper_fit(net, tp_mesh, [("sharding", ("dp_tp",))]).fit(
        _par_iter(xs[:1]))
    ck = CheckpointListener.last_checkpoint(ck)
    whole = restore_sharded(ck, device="cuda")
    net = _par_net()
    specs = partition.match_partition_rules(
        partition.rules_for("dp_tp"), net.params_list, mesh=tp_mesh,
        conf=net.conf)
    t0 = time.perf_counter()
    restore_sharded(ck, net, shardings=specs, mesh=tp_mesh)
    restore_s = time.perf_counter() - t0
    held = net._held_sharding
    n_blocks, held_bytes = len(held.blocks), held.held_bytes()
    blocks_ok = True
    for (layer, name, slot), (block, splits) in held.blocks.items():
        t = (whole.params_list[layer][name] if slot is None
             else whole.updater_state[layer][name][slot])
        (d, _axes), = splits
        want = t.detach().chunk(world, dim=d)[rank]
        blocks_ok &= torch.equal(block, want)
    x = torch.tensor(xs[SH_STEPS], device="cuda")
    _zero(kernels)
    out_sharded = net.output(x)
    restore_launches = _sh_launches(kernels)
    out_ok = torch.equal(out_sharded, whole.output(x))
    _zero(kernels)
    wrapper_fit(net, tp_mesh, [("sharding", ("dp_tp",))]).fit(
        _par_iter(xs[1:1 + SH_STEPS]))
    fit_launches = _sh_launches(kernels)
    for x1 in xs[1:1 + SH_STEPS]:
        whole.fit(x1, x1)
    whole_bytes = sum(t.numel() * t.element_size()
                      for t in _tensors_of(whole.params_list))
    ref = whole.params().double()
    rel = float((net.params().double() - ref).norm() / ref.norm())
    got["restore"] = {
        "blocks": n_blocks, "blocks_ok": bool(blocks_ok),
        "reads": dict(held.reads), "output_ok": bool(out_ok),
        "restore_s": restore_s, "output_launches": restore_launches,
        "fit_launches": fit_launches, "fit_rel_err": rel,
        "held_bytes": held_bytes, "whole_bytes": whole_bytes,
        "settled": net._held_sharding is None}
    del net, whole

    # (d): each fit twice from one init, without and with the listeners
    # that read whole state; rank 0 writes the zips
    for mode in SH_VIEW_MODES:
        runs = {}
        for listen in (False, True):
            net = _par_net()
            d = os.path.join(tmp, f"view_{mode}")
            log = ParamAndGradientIterationListener(
                print_mean_magnitudes=False)
            if listen:
                net.set_listeners(CheckpointListener(
                    d, every_n_iterations=SH_STEPS, every_n_epochs=None),
                    log)
            if mode == "pipeline":
                fit = PipelineTrainer(net, mesh=build_mesh({"stage": world}),
                                      n_microbatches=PAR_PIPE_M)
                fit.prefetch_depth = 0
            elif mode == "zero3":
                fit = wrapper_fit(net, build_mesh({"data": world}),
                                  [("sharding", ("zero3",))])
            else:
                fit = wrapper_fit(net, tp_mesh, [("sharding", ("dp_tp",))])
            _zero(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit.fit(_par_iter(xs[:SH_STEPS]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = fit.stats()
            run = {"launches": _sh_launches(kernels), "wall_s": wall,
                   "views": st["whole_views"],
                   "view_bytes": st["whole_view_bytes"],
                   "rows": len(log.rows),
                   "params": net.params().cpu()}
            if listen and rank == 0:
                back = restore_multi_layer_network(
                    os.path.join(d, f"checkpoint_iter_{SH_STEPS}.zip"),
                    device="cuda")
                same = all(torch.equal(a, b) for a, b in zip(
                    _tensors_of([back.params_list, back.updater_state]),
                    _tensors_of([net.params_list, net.updater_state])))
                run["zip_bitwise"] = bool(same)
            runs["listen" if listen else "plain"] = run
            del net
        got[mode] = runs
    torch.save(got, out)
    dist.destroy_process_group()


def sharded_phase(kernels) -> dict:
    """A7.8's second half on the card: (a) sharded pins on a device mesh,
    (b) sharded replicas over HTTP through a rolling swap, then on two gloo
    ranks sharing the card (c) a restore onto the dp_tp sharding and (d)
    whole views for the listeners that read them."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    counted = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, softmax_cross_entropy)
    out = {"pins": _sh_pins(counted), "replicas": _sh_replicas(counted)}
    tmp = tempfile.mkdtemp(prefix="sharded_")
    files = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
    port = _free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_sh_rank, args=(r, 2, port, files[r], tmp))
             for r in range(2)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode != 0 for p in procs):
            fail(f"sharded gloo: rank exit codes "
                 f"{[p.exitcode for p in procs]}")
        ranks = [torch.load(f) for f in files]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rs = [r["restore"] for r in ranks]
    fit_want = {"flash_fwd": 4 * SH_STEPS, "flash_bwd_dq": 4 * SH_STEPS,
                "flash_bwd_dkv": 4 * SH_STEPS,
                "softmax_cross_entropy": SH_STEPS}
    out_want = {"flash_fwd": 4, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                "softmax_cross_entropy": 0}
    print(f"sharded (c): restore onto dp_tp {{data: 1, model: 2}}: blocks "
          f"{[r['blocks'] for r in rs]} bitwise {[r['blocks_ok'] for r in rs]}"
          f", reads {[r['reads'] for r in rs]}, param bytes held "
          f"{[r['held_bytes'] for r in rs]} of {rs[0]['whole_bytes']}, "
          f"{[round(r['restore_s'], 3) for r in rs]} s; output bitwise a "
          f"whole restore's {[r['output_ok'] for r in rs]}, launches "
          f"{[r['output_launches'] for r in rs]}; {SH_STEPS} dp_tp steps "
          f"from it against one rank's fit from the whole restore: rel err "
          f"{[f'{r['fit_rel_err']:.3e}' for r in rs]} (tol "
          f"{SH_FIT_TOL:.0e}), launches {[r['fit_launches'] for r in rs]}",
          flush=True)
    for r in rs:
        if not (r["blocks_ok"] and r["output_ok"] and r["blocks"] > 0
                and r["reads"]["own_blocks"] > 0 and r["settled"]
                and r["held_bytes"] < r["whole_bytes"]
                and r["fit_rel_err"] <= SH_FIT_TOL):
            fail(f"sharded (c): {r}")
        if r["output_launches"] != out_want or r["fit_launches"] != fit_want:
            fail(f"sharded (c): launches {r['output_launches']}, "
                 f"{r['fit_launches']}")
    out["restore"] = [{k: v for k, v in r.items()} for r in rs]
    out["views"] = {}
    for mode in SH_VIEW_MODES:
        runs = [r[mode] for r in ranks]
        for r in runs:
            if r["listen"]["launches"] != r["plain"]["launches"]:
                fail(f"sharded (d) {mode}: launches with the listeners "
                     f"{r['listen']['launches']} against "
                     f"{r['plain']['launches']}")
            if not torch.equal(r["listen"]["params"], r["plain"]["params"]):
                fail(f"sharded (d) {mode}: the listeners moved the fit")
            if r["listen"]["views"] != SH_STEPS:
                fail(f"sharded (d) {mode}: {r['listen']['views']} views")
        if not runs[0]["listen"].get("zip_bitwise") \
                or runs[0]["listen"]["rows"] != SH_STEPS \
                or runs[1]["listen"]["rows"] != 0:
            fail(f"sharded (d) {mode}: the zip or the param log")
        print(f"sharded (d) {mode}: last zip restored bitwise the state the "
              f"fit leaves; whole views {[r['listen']['views'] for r in runs]}"
              f" of {[r['listen']['view_bytes'] for r in runs]} bytes; "
              f"launches with listeners {[r['listen']['launches'] for r in runs]}"
              f" = without; fit wall s {[round(r['listen']['wall_s'], 3) for r in runs]}"
              f" (without {[round(r['plain']['wall_s'], 3) for r in runs]})",
              flush=True)
        out["views"][mode] = [{k: v for k, v in r["listen"].items()
                               if k != "params"} | {
            "plain_wall_s": r["plain"]["wall_s"]} for r in runs]
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- A8 and C3
#: C3: the flash forward's key splits at D = 64, timed at the sharded
#: pins' predict shape, the serve phase's, the whole pin's [8, 512], the
#: training shape and the pipeline's microbatch (B, T, H, D): shapes on
#: both sides of the batch at each T the plan chooses on
C3_SHAPES = {"predict": (4, 512, 4, 64), "serve": (2, 512, 4, 64),
             "whole8": (8, 512, 4, 64),
             "train": (TRAIN_B, TRAIN_T, 4, 64),
             "microbatch": (TRAIN_B // PAR_PIPE_M, TRAIN_T, 4, 64)}
#: C3: every dense product of a transformer_lm(256) pin (K, N), held at
#: these row counts (M = B * T: 4,096 is the whole pin's [8, 512], 2,048 a
#: data slot's share of it, 1,024 the serve phase's [2, 512])
C3_PRODUCTS = {"Wqkv": (256, 768), "Wo": (256, 256), "W1": (256, 1024),
               "W2": (1024, 256), "head": (256, 256)}
C3_ROWS = (1, 2, 3, 5, 8, 64, 255, 512, 1000, 1024, 2048, 4096)
C3_TIMED_ROWS = (4096, 2048, 1024)
#: fixed_matmul against its plain version (cuBLAS in float32, TF32 off) on
#: outputs of unit scale (w scaled by 1/sqrt(K)): the two sum in other
#: orders, K = 1,024 terms at most
FIXED_MM_TOL = 2e-5
#: the keras phase: BASELINE config 5's VGG-16 at full width (the
#: keras.applications layout of Keras 1.2, Theano dim ordering), fine-tuned
#: at B = 32 for 4 steps; its softmax output against the CPU at B = 2, the
#: largest difference over the largest output (probabilities from 4e-8 to
#: 0.11 on the H100: an absolute 1e-4 would pass a drift of percents in
#: most of them; read 4.3e-6)
KERAS_VGG_B, KERAS_VGG_STEPS, KERAS_VGG_CHECK_B = 32, 4, 2
KERAS_VGG_REL_TOL = 1e-5
#: the fine-tune's learning rate, set on every layer of the imported
#: configuration (as DL4J's FineTuneConfiguration sets it): the import's
#: default of 0.1 diverges from this random init (losses 8.9, 336, 1.9e19,
#: NaN on the H100)
KERAS_VGG_LR = 1e-3
KERAS_VGG_PARAMS = 138_357_544
#: the gateway's character LSTM at char_rnn's widths: two LSTM(200) over
#: T = 50 one-hot characters of 64, 8 minibatch files of B = 32
KERAS_RNN_V, KERAS_RNN_H, KERAS_RNN_T, KERAS_RNN_B = 64, 200, 50, 32
KERAS_RNN_BATCHES = 8
#: card against CPU of the imported LSTM's softmax output (the serve
#: phase's 1e-5 for char_rnn's rnn_time_step)
KERAS_RNN_TOL = 1e-5
#: the native phase: MNIST-sized IDX files, LeNet-5 fed by the native
#: loader at the JAX bench's B = 128; an Iris-shaped CSV of 200 batches of
#: 1,024 rows into the Iris MLP; broker frames of a LeNet batch
NATIVE_MNIST_N, NATIVE_B = 60_000, 128
NATIVE_CSV_ROWS, NATIVE_CSV_B = 204_800, 1024
NATIVE_FRAMES, NATIVE_FRAME_SHAPE = 32, (128, 784)


def check_fixed_matmul(rows: list, dev) -> None:
    """fixed_matmul (csrc/fixed_matmul.cu) against its plain version at
    each product of a pin, at the whole pin's, a data slot's and the serve
    phase's row counts; timed against the cuBLAS call (the plain version
    on the card is that call). The kernel runs its products as three TF32
    passes on the tensor cores: its bound is that work at the TF32 peak,
    with the float32 bound (the same product on the CUDA cores) beside it."""
    g = torch.Generator().manual_seed(SEED + 53)
    for name, (K, N) in C3_PRODUCTS.items():
        w = (torch.randn(K, N, generator=g) / K ** 0.5).to(dev)
        for M in C3_TIMED_ROWS:
            x = torch.randn(M, K, generator=g).to(dev)
            got = fixed_matmul(x, w)
            err = float((got - fixed_matmul_plain(x, w)).abs().max())
            ms = time_ms(lambda: fixed_matmul(x, w))
            lib_ms = time_ms(lambda: torch.matmul(x, w))
            nbytes, ops = 4 * (M * K + K * N + M * N), 2 * M * N * K
            f32_ms, f32_by = bound(nbytes, ops)
            row = report(rows, "fixed_matmul",
                         {"M": M, "K": K, "N": N, "product": name}, err,
                         FIXED_MM_TOL, ms, lib_ms, lib_ms, nbytes, 3 * ops,
                         {"card": CARD, "bound_f32_ms": f32_ms,
                          "bound_f32_by": f32_by},
                         ops_per_s=TF32_OPS_PER_S)
            if M in C3_TIMED_ROWS[:2]:  # the whole pin's rows; a data slot's
                DEVICE_TIMED.append((row,
                                     lambda x=x, w=w: fixed_matmul(x, w),
                                     lambda x=x, w=w: torch.matmul(x, w)))


def c3_products() -> dict:
    """C3's cuBLAS half: for every dense product of a pin, float32 and on
    the int8 route's dequantized weight, whether a row comes out with the
    same float32 bits at every row count, under fixed_matmul (which must)
    and under cuBLAS (recorded)."""
    g = torch.Generator().manual_seed(SEED + 52)
    out = {}
    top = max(C3_ROWS)
    for name, (K, N) in C3_PRODUCTS.items():
        w32 = torch.randn(K, N, generator=g) / K ** 0.5
        x = torch.randn(top, K, generator=g).cuda()
        for route in ("float32", "int8"):
            w = (w32 if route == "float32"
                 else dequantize_leaf(quantize_per_channel(w32))).cuda()
            res = {}
            for lib, fn in (("fixed_matmul", fixed_matmul),
                            ("cublas", torch.matmul)):
                whole = fn(x, w)
                res[lib] = {M: bool(torch.equal(fn(x[:M], w), whole[:M]))
                            for M in C3_ROWS}
            out[f"{name}_{route}"] = res
            print(f"c3 [M, {K}] @ [{K}, {N}] ({name}, {route}): rows "
                  f"bitwise those of M = {top}: fixed_matmul at every M "
                  f"{all(res['fixed_matmul'].values())}; cuBLAS "
                  f"{ {M: v for M, v in res['cublas'].items() if not v} or 'at every M'} "
                  f"off", flush=True)
            if not all(res["fixed_matmul"].values()):
                fail(f"c3: fixed_matmul {name} ({route}) changes a row "
                     f"with M: {res['fixed_matmul']}")
    fixed_matmul.launches = 0
    return out


def c3_phase() -> dict:
    """C3: the flash forward with 2 and with 4 key splits at D = 64 (both
    instantiated in csrc/flash_fwd.cu), timed in turns at each shape, the
    outputs of each held against the plain version, beside the count the
    plan chooses there; then the pins' dense products across row counts
    (:func:`c3_products`)."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    keep = dict(fa.FWD_SPLITS)
    g = torch.Generator().manual_seed(SEED + 51)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"flash": {}, "cublas": {}}
    try:
        for name, (B, T, H, D) in C3_SHAPES.items():
            in_use = keep[64][T >= fa.FWD_LONG_TQ]
            q, k, v = (torch.randn(B, T, H, D, generator=g).cuda()
                       for _ in range(3))
            ref = flash_fwd_plain(q, k, v, True)[0]
            times, walls, errs = {2: [], 4: []}, {2: [], 4: []}, {}
            for splits in (2, 4, 4, 2):
                fa.FWD_SPLITS[64] = (splits, splits)
                fa.flash_plan.cache_clear()
                walls[splits].append(time_ms(
                    lambda: flash_fwd(q, k, v, True), iters=100))
                times[splits].append(device_ms(
                    lambda: flash_fwd(q, k, v, True))[0])
                errs[splits] = float((flash_fwd(q, k, v, True)[0] - ref)
                                     .abs().max())
            res = {s: {"device_ms": float(np.mean(t)), "runs_device_ms": t,
                       "wall_ms": walls[s], "max_abs_err": errs[s]}
                   for s, t in times.items()}
            out["flash"][name] = {"splits_in_use": in_use, **res}
            print(f"c3 flash_fwd {name} B={B} T={T} H={H} D={D}: device ms "
                  f"2 splits {res[2]['device_ms']:.5f} {times[2]}, 4 splits "
                  f"{res[4]['device_ms']:.5f} {times[4]}; CUDA-event ms "
                  f"2: {walls[2]}, 4: {walls[4]} (in use: {in_use}; "
                  f"errors {errs}) [{CARD}]", flush=True)
            if max(errs.values()) > 2e-5:
                fail(f"c3 flash_fwd {name}: a split count disagrees {errs}")
    finally:
        fa.FWD_SPLITS.clear()
        fa.FWD_SPLITS.update(keep)
        fa.flash_plan.cache_clear()
    for name, (B, T, H, D) in C3_SHAPES.items():
        got = fa.flash_plan("fwd", D, B * H, T, sms).splits
        if got != out["flash"][name]["splits_in_use"]:
            fail(f"c3: the plan at {name} takes {got} splits")
    flash_fwd.launches = 0
    out["products"] = c3_products()
    return out


def _vgg_keras_layers() -> list:
    """The Keras-1.2 ``keras.applications.VGG16`` layers as a Sequential
    model (Theano ordering): ``(class, config, weight shapes)``."""
    layers, c_in = [], 3
    blocks = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
    for b, (width, convs) in enumerate(blocks, 1):
        for c in range(1, convs + 1):
            cfg = {"name": f"block{b}_conv{c}", "nb_filter": width,
                   "nb_row": 3, "nb_col": 3, "activation": "relu",
                   "border_mode": "same", "subsample": [1, 1],
                   "dim_ordering": "th"}
            if not layers:
                cfg["batch_input_shape"] = [None, 3, 224, 224]
            layers.append(("Convolution2D", cfg,
                           [(width, c_in, 3, 3), (width,)]))
            c_in = width
        layers.append(("MaxPooling2D", {
            "name": f"block{b}_pool", "pool_size": [2, 2],
            "strides": [2, 2], "dim_ordering": "th"}, []))
    layers.append(("Flatten", {"name": "flatten"}, []))
    for name, n_in, n_out, act in (("fc1", 25088, 4096, "relu"),
                                   ("fc2", 4096, 4096, "relu"),
                                   ("predictions", 4096, 1000, "softmax")):
        layers.append(("Dense", {"name": name, "output_dim": n_out,
                                 "activation": act},
                       [(n_in, n_out), (n_out,)]))
    return layers


def write_keras_archive(path: str, layers: list, weights: dict,
                        loss: str = "categorical_crossentropy") -> None:
    """A Keras-1 archive in its layout: ``model_config`` and
    ``training_config`` on the root, ``model_weights`` with
    ``layer_names`` and each layer's ``weight_names``, written by the
    port's own HDF5 writer (each array streamed to the file)."""
    from deeplearning4j_tpu_torch.modelimport.hdf5 import H5File
    mc = {"class_name": "Sequential",
          "config": [{"class_name": c, "config": cfg} for c, cfg, _ in layers]}
    with H5File(path, "w") as f:
        f.write_attr("/", "model_config", json.dumps(mc))
        f.write_attr("/", "training_config", json.dumps({"loss": loss}))
        f.create_group("/model_weights")
        f.write_attr("/model_weights", "layer_names",
                     [cfg["name"] for _, cfg, _ in layers])
        for _, cfg, _shapes in layers:
            name = cfg["name"]
            f.create_group(f"/model_weights/{name}")
            ws = weights.get(name, [])
            f.write_attr(f"/model_weights/{name}", "weight_names",
                         [wn for wn, _ in ws])
            for wn, arr in ws:
                f.write_dataset(f"/model_weights/{name}/{wn}", arr)


def _vgg_weights(layers: list) -> dict:
    """He-scaled normal kernels and zero biases from a seed; the
    classifier's kernel at 0.01 so the fine-tune starts near uniform."""
    rng = np.random.default_rng(SEED + 61)
    out = {}
    for _, cfg, shapes in layers:
        if not shapes:
            continue
        name, (wshape, bshape) = cfg["name"], shapes
        fan_in = int(np.prod(wshape[1:])) if len(wshape) == 4 else wshape[0]
        std = 0.01 if name == "predictions" else float(np.sqrt(2.0 / fan_in))
        w = rng.standard_normal(wshape, dtype=np.float32)
        w *= np.float32(std)
        out[name] = [(f"{name}_W", w), (f"{name}_b",
                                        np.zeros(bshape, np.float32))]
    return out


def _imported_equal(net, layers, weights) -> int:
    """Every param of the imported network bitwise the archive's array
    after the documented layout change (TH kernels to HWIO); returns the
    parameter count. Each Keras layer but Flatten is a layer of the
    network (Flatten is the preprocessor the builder infers)."""
    n = 0
    kept = [(cls, cfg) for cls, cfg, _ in layers if cls != "Flatten"]
    if len(kept) != len(net.params_list):
        fail(f"keras (a): {len(net.params_list)} layers for {len(kept)}")
    for (cls, cfg), params in zip(kept, net.params_list):
        if cfg["name"] not in weights:
            if params:
                fail(f"keras (a): {cfg['name']} has params {sorted(params)}")
            continue
        (_, w), (_, b) = weights[cfg["name"]]
        want = np.transpose(w, (2, 3, 1, 0)) if cls == "Convolution2D" else w
        for key, arr in (("W", want), ("b", b)):
            got = params[key].detach().cpu().numpy()
            if got.shape != arr.shape or got.tobytes() != arr.tobytes():
                fail(f"keras (a) {cfg['name']}/{key} differs from the "
                     "archive")
            n += arr.size
    return n


def _pin_out(mv, x: np.ndarray) -> torch.Tensor:
    out = mv.predict_fn(x)
    return out.cpu() if torch.is_tensor(out) else torch.as_tensor(out)


def _keras_vgg(kernels, tmp: str) -> dict:
    """(a) and (b): the full-width VGG-16 archive written, read, imported
    on the card and the CPU, served from the file, then fine-tuned."""
    from deeplearning4j_tpu_torch.keras_server.registry import ModelRegistry
    from deeplearning4j_tpu_torch.modelimport.hdf5 import H5File
    from deeplearning4j_tpu_torch.modelimport.keras_import import (
        KerasModelImport)
    layers = _vgg_keras_layers()
    weights = _vgg_weights(layers)
    path = os.path.join(tmp, "vgg16_keras1.h5")
    t0 = time.perf_counter()
    write_keras_archive(path, layers, weights)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    with H5File(path) as f:
        read = {(n, wn): f.read_dataset(f"/model_weights/{n}/{wn}")
                for n, ws in weights.items() for wn, _ in ws}
    read_s = time.perf_counter() - t0
    if any(read[(n, wn)].tobytes() != arr.tobytes()
           for n, ws in weights.items() for wn, arr in ws):
        fail("keras (a): an array read back differs from the one written")
    del read
    t0 = time.perf_counter()
    net = KerasModelImport.import_keras_sequential_model_and_weights(
        path, device="cuda")
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = KerasModelImport.import_keras_sequential_model_and_weights(
        path, device="cpu")
    cpu_import_s = time.perf_counter() - t0
    n_params = _imported_equal(net, layers, weights)
    if n_params != KERAS_VGG_PARAMS or net.num_params() != KERAS_VGG_PARAMS:
        fail(f"keras (a): {n_params} / {net.num_params()} params, want "
             f"{KERAS_VGG_PARAMS}")
    print(f"keras (a) VGG-16 archive: {size} bytes, {n_params} float32 "
          f"params; write {write_s:.2f}s, read {read_s:.2f}s, import on the "
          f"card {import_s:.2f}s (CPU {cpu_import_s:.2f}s); every param "
          "bitwise the archive's (TH kernels as HWIO)", flush=True)
    g = torch.Generator().manual_seed(SEED + 62)
    xc, _ = _res_batch(g, KERAS_VGG_CHECK_B, 224, 1000, "cpu")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        card_out = _out(net, xc.cuda())
        cpu_out = _out(cpu, xc)
        out_err = float((card_out - cpu_out).abs().max())
        out_scale = float(cpu_out.abs().max())
        out_rel = out_err / out_scale
        print(f"keras (a) forward B={KERAS_VGG_CHECK_B}: card vs CPU "
              f"max_abs_err {out_err:.3e} over max|out| {out_scale:.3e}: "
              f"{out_rel:.3e} (tol {KERAS_VGG_REL_TOL:.0e}); smallest "
              f"output {float(cpu_out.min()):.3e}", flush=True)
        if not out_rel <= KERAS_VGG_REL_TOL:
            fail(f"keras (a): the imported VGG-16's card output is "
                 f"{out_err} from the CPU's ({out_rel} of its largest)")
        del cpu
        # (b) the same file through load_model_file and a registry pin,
        # before the fine-tune moves the network
        t0 = time.perf_counter()
        mv = ModelRegistry().load("vgg16_keras", path, device="cuda")
        load_s = time.perf_counter() - t0
        # a pin's dense products are fixed_matmul's (C3): the network's
        # forward with the same products
        from deeplearning4j_tpu_torch.ops.fixed_matmul import (
            row_invariant_matmuls)
        with row_invariant_matmuls():
            pin_want = _out(net, xc.cuda())
        pin_equal = bool(torch.equal(_pin_out(mv, xc.numpy()), pin_want))
    finally:
        torch.backends.cudnn.deterministic = prev
    print(f"keras (b) load_model_file + registry pin in {load_s:.2f}s: "
          f"output bitwise the imported network's (its dense products "
          f"through fixed_matmul, as a pin's): {pin_equal}", flush=True)
    if not pin_equal:
        fail("keras (b): the served pin's output is not net.output's")
    del mv
    # the fine-tune configuration: the imported one at KERAS_VGG_LR, the
    # imported weights loaded into it
    conf = json.loads(net.conf.to_json())
    for lc in conf["layers"]:
        lc["learning_rate"] = lc["bias_learning_rate"] = KERAS_VGG_LR
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    tuned = MultiLayerNetwork(MultiLayerConfiguration.from_dict(conf),
                              device="cuda")
    tuned.load_params(convert.to_numpy(net.params_list))
    del net
    net = tuned
    x, y = _res_batch(g, KERAS_VGG_B, 224, 1000, "cuda")
    losses, step_ms = [], []
    _zero(kernels)
    for _ in range(KERAS_VGG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(net.score_value)
    launches = _launches(kernels)
    print(f"keras (a) fine-tune {KERAS_VGG_STEPS} steps at B={KERAS_VGG_B}, "
          f"224x224, SGD at {KERAS_VGG_LR}: losses {losses}, step ms "
          f"{step_ms}, launches {launches}", flush=True)
    _check_launches("keras (a) fine-tune", launches,
                    _want(kernels, softmax_cross_entropy=KERAS_VGG_STEPS))
    if not all(np.isfinite(losses)):
        fail(f"keras (a): a fine-tune loss is not finite: {losses}")
    os.remove(path)
    del net
    torch.cuda.empty_cache()
    return {"bytes": size, "params": n_params, "write_s": write_s,
            "read_s": read_s, "import_s": import_s,
            "cpu_import_s": cpu_import_s, "output_max_abs_err": out_err,
            "output_max": out_scale, "output_rel_err": out_rel,
            "pin_bitwise": pin_equal, "load_s": load_s, "losses": losses,
            "step_ms": step_ms, "launches": launches}


def _rnn_keras_layers(inner: str) -> list:
    """Two Keras-1 ``LSTM(200, return_sequences=True)`` over one-hot
    characters, then ``TimeDistributedDense(64, softmax)``."""
    V, H, T = KERAS_RNN_V, KERAS_RNN_H, KERAS_RNN_T
    gates = [(f"{w}_{g}", shape) for g in "icfo"
             for w, shape in (("W", None), ("U", (H, H)), ("b", (H,)))]
    out = []
    for i, n_in in ((1, V), (2, H)):
        cfg = {"name": f"lstm_{i}", "output_dim": H, "activation": "tanh",
               "inner_activation": inner, "return_sequences": True}
        if i == 1:
            cfg["batch_input_shape"] = [None, T, V]
        out.append(("LSTM", cfg, [(n, s or (n_in, H)) for n, s in gates]))
    out.append(("TimeDistributedDense", {"name": "td_1", "output_dim": V,
                                         "activation": "softmax"},
                [("W", (H, V)), ("b", (V,))]))
    return out


def _rnn_weights(layers: list) -> dict:
    rng = np.random.default_rng(SEED + 63)
    return {cfg["name"]: [(f"{cfg['name']}_{n}",
                           (0.1 * rng.standard_normal(s)).astype(np.float32))
                          for n, s in shapes]
            for _, cfg, shapes in layers}


def _char_batches(rng, n: int) -> tuple:
    """``n`` batches of one-hot characters ``[B, T, V]`` and their next
    characters as labels."""
    ids = rng.integers(0, KERAS_RNN_V, size=(n, KERAS_RNN_B, KERAS_RNN_T + 1))
    eye = np.eye(KERAS_RNN_V, dtype=np.float32)
    return eye[ids[..., :-1]], eye[ids[..., 1:]]


def _keras_gateway(kernels, tmp: str) -> dict:
    """(c) the gateway: a token-guarded Server on loopback, ``call``s to fit,
    evaluate and predict the sigmoid-gated character LSTM over HDF5
    minibatch directories; (d) the hard_sigmoid archive."""
    from deeplearning4j_tpu_torch.modelimport.hdf5 import H5File
    from deeplearning4j_tpu_torch.modelimport.keras_import import (
        KerasModelImport)
    rng = np.random.default_rng(SEED + 64)
    xs, ys = _char_batches(rng, KERAS_RNN_BATCHES)
    dirs = {}
    for kind, arrs in (("x", xs), ("y", ys)):
        d = dirs[kind] = os.path.join(tmp, f"lstm_{kind}")
        os.makedirs(d)
        for i, a in enumerate(arrs):
            with H5File(os.path.join(d, f"{i}.h5"), "w") as f:
                f.write_dataset("/data", a)
    out = {}
    for inner in ("sigmoid", "hard_sigmoid"):
        layers = _rnn_keras_layers(inner)
        path = os.path.join(tmp, f"char_lstm_{inner}.h5")
        write_keras_archive(path, layers, _rnn_weights(layers))
        card = KerasModelImport.import_keras_sequential_model_and_weights(
            path, device="cuda")
        cpu = KerasModelImport.import_keras_sequential_model_and_weights(
            path, device="cpu")
        _zero(kernels)
        got = _out(card, torch.from_numpy(xs[0]).cuda())
        fwd_launches = _launches(kernels)
        err = float((got - _out(cpu, torch.from_numpy(xs[0]))).abs().max())
        gated = inner == "sigmoid"
        want_fwd = _want(kernels, lstm_fwd=2 if gated else 0)
        print(f"keras ({'c' if gated else 'd'}) {inner} LSTM archive: output "
              f"card vs CPU max_abs_err {err:.3e} (tol {KERAS_RNN_TOL:.0e}); "
              f"launches {fwd_launches}", flush=True)
        _check_launches(f"keras {inner} output", fwd_launches, want_fwd)
        if not err <= KERAS_RNN_TOL:
            fail(f"keras {inner}: the imported LSTM's card output is {err} "
                 "from the CPU's")
        res = {"output_max_abs_err": err, "output_launches": fwd_launches}
        if gated:
            res.update(_gateway_calls(kernels, path, dirs, xs))
        else:
            _zero(kernels)
            card.fit(xs[0], ys[0])
            torch.cuda.synchronize()
            res["fit_launches"] = _launches(kernels)
            print(f"keras (d) hard_sigmoid: one fit step, loss "
                  f"{card.score_value}, launches {res['fit_launches']}",
                  flush=True)
            _check_launches("keras (d) fit", res["fit_launches"],
                            _want(kernels, softmax_cross_entropy=1))
        out[inner] = res
        del card, cpu
    return out


def _gateway_calls(kernels, path: str, dirs: dict, xs) -> dict:
    from deeplearning4j_tpu_torch.keras_server import Server, call
    token = "chip-smoke-" + os.urandom(8).hex()
    srv = Server(host="127.0.0.1", auth_token=token, device="cuda").start()
    res = {}
    n = KERAS_RNN_BATCHES
    try:
        try:
            call("127.0.0.1", srv.port, "predict", model_file_path=path,
                 features=[])
            fail("keras (c): the gateway answered without its token")
        except RuntimeError as e:
            if "auth token" not in str(e):
                raise
        for method, params, want in (
                ("fit", dict(nb_epoch=1, train_features_directory=dirs["x"],
                             train_labels_directory=dirs["y"]),
                 _want(kernels, lstm_fwd=2 * n, lstm_bwd=2 * n,
                       softmax_cross_entropy=n)),
                ("evaluate", dict(features_directory=dirs["x"],
                                  labels_directory=dirs["y"]),
                 _want(kernels, lstm_fwd=2 * n)),
                ("predict", dict(features=xs[0][:4].tolist()),
                 _want(kernels, lstm_fwd=2))):
            _zero(kernels)
            t0 = time.perf_counter()
            r = call("127.0.0.1", srv.port, method, token=token,
                     model_file_path=path, **params)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = _launches(kernels)
            summary = ({k: v for k, v in r.items() if k != "predictions"}
                       if method != "predict" else
                       {"shape": list(np.shape(r["predictions"]))})
            print(f"keras (c) gateway {method}: {summary} in {secs:.2f}s, "
                  f"launches {launches}", flush=True)
            _check_launches(f"keras (c) {method}", launches, want)
            res[method] = {"result": summary, "seconds": secs,
                           "launches": launches}
        pred = np.asarray(call("127.0.0.1", srv.port, "predict", token=token,
                               model_file_path=path,
                               features=xs[0][:4].tolist())["predictions"])
        if pred.shape != (4, KERAS_RNN_T, KERAS_RNN_V) or \
                not np.isfinite(pred).all():
            fail(f"keras (c): predictions of shape {pred.shape}")
        if not np.isfinite(res["fit"]["result"]["score"]):
            fail("keras (c): the gateway's fit score is not finite")
    finally:
        srv.stop()
    return res


def keras_phase(kernels) -> dict:
    """A8.1: a Keras-1 archive imported, served and fine-tuned on the card,
    and the Keras gateway over TCP."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="keras_phase_")
    try:
        return {"vgg16": _keras_vgg(kernels, tmp),
                "lstm": _keras_gateway(kernels, tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _write_idx(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(np.array([0x0800 | arr.ndim, *arr.shape], ">i4").tobytes())
        f.write(np.ascontiguousarray(arr, np.uint8).tobytes())


def _native_mnist(kernels, tmp: str) -> dict:
    """(b) MNIST-sized IDX files parsed natively and in Python; (c) one
    epoch of LeNet-5 fed by the native loader, against the loader's
    Python route."""
    from deeplearning4j_tpu_torch import nativert
    from deeplearning4j_tpu_torch.datasets import mnist
    rng = np.random.default_rng(SEED + 71)
    imgs = rng.integers(0, 256, (NATIVE_MNIST_N, 28, 28), dtype=np.uint8)
    lbls = rng.integers(0, 10, NATIVE_MNIST_N, dtype=np.uint8)
    paths = [os.path.join(tmp, n) for n in ("train-images-idx3-ubyte",
                                            "train-labels-idx1-ubyte")]
    _write_idx(paths[0], imgs)
    _write_idx(paths[1], lbls)
    times = {}
    for route, fn in (("native", nativert.read_idx),
                      ("python", nativert.read_idx_py),
                      ("datasets.mnist", lambda p: mnist.read_idx(Path(p)))):
        t0 = time.perf_counter()
        got = [fn(p) for p in paths]
        times[route] = time.perf_counter() - t0
        if not all(g.dtype == np.uint8 and g.tobytes() == a.tobytes()
                   and g.shape == a.shape for g, a in zip(got, (imgs, lbls))):
            fail(f"native (b): the {route} IDX parse differs")
    print(f"native (b) IDX {imgs.shape} + {lbls.shape}: native, Python and "
          f"datasets.mnist parses bitwise equal; seconds {times}", flush=True)
    n_batches = NATIVE_MNIST_N // NATIVE_B
    loader = nativert.AsyncNativeLoader.mnist(*paths, batch=NATIVE_B,
                                              seed=SEED)
    t0 = time.perf_counter()
    batches = list(loader)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = list(nativert.loader_batches_py(imgs, lbls, 10, NATIVE_B,
                                         seed=SEED))
    python_s = time.perf_counter() - t0
    if len(batches) != n_batches or any(
            a.tobytes() != c.tobytes() or b.tobytes() != d.tobytes()
            for (a, b), (c, d) in zip(batches, py)):
        fail("native (c): the loader's epoch differs from its Python route")
    del py
    loader.reset()
    net = MultiLayerNetwork(lenet_mnist(), device="cuda").init(seed=SEED)
    _zero(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    for x, y in loader:
        net.fit(x, y)
        steps += 1
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launches(kernels)
    loader.close()
    rates = {"native_batches_per_s": n_batches / native_s,
             "python_batches_per_s": n_batches / python_s}
    print(f"native (c) AsyncNativeLoader.mnist B={NATIVE_B}: {n_batches} "
          f"batches bitwise the Python route's; {rates['native_batches_per_s']:.1f} "
          f"batches/s native, {rates['python_batches_per_s']:.1f} Python; "
          f"a LeNet-5 epoch of {steps} fit steps in {fit_s:.2f}s, loss "
          f"{net.score_value}, launches {launches}", flush=True)
    _check_launches("native (c) LeNet epoch", launches,
                    _want(kernels, softmax_cross_entropy=n_batches))
    if steps != n_batches or not np.isfinite(net.score_value):
        fail(f"native (c): {steps} steps, loss {net.score_value}")
    return {"idx_seconds": times, "batches": n_batches, **rates,
            "fit_s": fit_s, "loss": net.score_value, "launches": launches}


def _native_csv(kernels, tmp: str) -> dict:
    """(d) an Iris-shaped CSV through CSVRecordReader and
    RecordReaderDataSetIterator into the Iris MLP."""
    from deeplearning4j_tpu_torch import nativert
    from deeplearning4j_tpu_torch.datavec import (
        CSVRecordReader, RecordReaderDataSetIterator)
    import csv

    from deeplearning4j_tpu_torch.datavec.records import _maybe_float
    rng = np.random.default_rng(SEED + 72)
    cls = rng.integers(0, 3, NATIVE_CSV_ROWS)
    centers = np.array([[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3],
                        [6.6, 3.0, 5.6, 2.0]])
    feats = np.round(centers[cls] + rng.normal(0, 0.3, (NATIVE_CSV_ROWS, 4)),
                     1)
    path = os.path.join(tmp, "iris_large.csv")
    with open(path, "w") as f:
        f.writelines(f"{a:.1f},{b:.1f},{c:.1f},{d:.1f},{k}\n"
                     for (a, b, c, d), k in zip(feats, cls))
    t0 = time.perf_counter()
    native = nativert.read_csv_numeric(path, strict=True)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(path, newline="") as f:
        general = np.asarray([[_maybe_float(v) for v in row]
                              for row in csv.reader(f)], np.float32)
    general_s = time.perf_counter() - t0
    plain = nativert.read_csv_numeric_py(path, strict=True)
    if native is None or native.tobytes() != general.tobytes() \
            or native.tobytes() != plain.tobytes():
        fail("native (d): the native CSV parse differs from the general "
             "reader's")
    conf = (NeuralNetConfiguration.builder().seed(1).learning_rate(0.1)
            .updater("adam").list()
            .layer(DenseLayer.conf(n_in=4, n_out=16, activation="relu"))
            .layer(OutputLayer.conf(n_in=16, n_out=3, loss="mcxent",
                                    activation="softmax")).build())
    net = MultiLayerNetwork(conf, device="cuda").init()
    it = RecordReaderDataSetIterator(CSVRecordReader(path),
                                     batch=NATIVE_CSV_B, label_index=4,
                                     num_classes=3)
    _zero(kernels)
    t0 = time.perf_counter()
    net.fit_iterator(it, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _launches(kernels)
    n_batches = NATIVE_CSV_ROWS // NATIVE_CSV_B
    acc = net.evaluate(it).accuracy()
    print(f"native (d) CSV {NATIVE_CSV_ROWS} x 5: native strict parse "
          f"{native_s:.2f}s, general reader {general_s:.2f}s, bitwise "
          f"equal; {n_batches} batches of {NATIVE_CSV_B} through "
          f"RecordReaderDataSetIterator into the Iris MLP in {fit_s:.2f}s, "
          f"accuracy {acc:.4f}, launches {launches}", flush=True)
    _check_launches("native (d) CSV fit", launches,
                    _want(kernels, softmax_cross_entropy=n_batches))
    if not acc > 0.9:
        fail(f"native (d): accuracy {acc} <= 0.9")
    return {"rows": NATIVE_CSV_ROWS, "native_parse_s": native_s,
            "general_parse_s": general_s, "fit_s": fit_s, "accuracy": acc,
            "launches": launches}


def _native_broker() -> dict:
    """(e) broker frames: the host runtime's ``decode_records`` on each
    float32 array's bytes (raw and bf16 coded) bitwise ``wire.decode_array``
    on the same bytes, both timed over the frames; then the frames through
    a ``ReconnectingConsumer``, bitwise the wire decode of what was sent."""
    from deeplearning4j_tpu_torch import nativert
    from deeplearning4j_tpu_torch.streaming import wire
    from deeplearning4j_tpu_torch.streaming.broker import (
        BrokerProducer, LoopbackBroker, ReconnectingConsumer)
    rng = np.random.default_rng(SEED + 73)
    frames = [{"x": rng.normal(size=NATIVE_FRAME_SHAPE).astype(np.float32),
               "y": np.eye(10, dtype=np.float32)[
                   rng.integers(0, 10, NATIVE_FRAME_SHAPE[0])],
               "ids": rng.integers(0, 10, NATIVE_FRAME_SHAPE[0])}
              for _ in range(NATIVE_FRAMES)]
    broker = LoopbackBroker().start()
    out = {}
    try:
        prod = BrokerProducer(broker.address)
        for codec in ("none", "bf16"):
            topic = f"frames_{codec}"
            sent, f32 = [], []
            for fr in frames:
                prod.publish(topic, fr, codec=codec)
                metas, views = wire.pack_arrays(fr, codec)
                raws = [bytes(v) for v in views]
                sent.append(wire.unpack_arrays(metas, b"".join(raws)))
                f32 += [(m, r) for m, r in zip(metas, raws)
                        if m["dtype"] == "float32"]
            kind = "f32" if codec == "none" else "bf16"
            t0 = time.perf_counter()
            nat = [nativert.decode_records(r, kind).reshape(tuple(m["shape"]))
                   for m, r in f32]
            native_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref = [wire.decode_array(m, r) for m, r in f32]
            wire_s = time.perf_counter() - t0
            same = all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                       for a, b in zip(nat, ref))
            cons = ReconnectingConsumer(broker.address, topic, group="g")
            got = [cons.get(timeout=10.0)[1] for _ in range(NATIVE_FRAMES)]
            cons.close()
            consumed = all(a[k].dtype == b[k].dtype
                           and a[k].tobytes() == b[k].tobytes()
                           for a, b in zip(got, sent) for k in b)
            print(f"native (e) {NATIVE_FRAMES} broker frames {codec}: "
                  f"{len(f32)} float32 arrays decoded by the runtime bitwise "
                  f"the wire's: {same} (seconds: native {native_s:.5f}, wire "
                  f"{wire_s:.5f}); the consumer's frames bitwise what was "
                  f"sent: {consumed}", flush=True)
            if not (same and consumed):
                fail(f"native (e): {codec} frames decode differently")
            out[codec] = {"native_s": native_s, "wire_s": wire_s}
        prod.close()
    finally:
        broker.stop()
    return out


def native_phase(kernels) -> dict:
    """A8.2 and DataVec: the host runtime built on the card's machine, its
    parsers, loader, CSV reader and decoder feeding the card."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch import nativert
    t0 = time.perf_counter()
    nativert.build()
    nativert.get_runtime()
    info = dict(nativert.build_info, load_s=time.perf_counter() - t0)
    print(f"native (a) host runtime built with {info['compiler']} in "
          f"{info['seconds']:.2f}s ({info['library']}; built in this "
          f"process: {info['built']})", flush=True)
    tmp = tempfile.mkdtemp(prefix="native_phase_")
    try:
        return {"build": info, "mnist": _native_mnist(kernels, tmp),
                "csv": _native_csv(kernels, tmp), "broker": _native_broker()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- A8.3 nlp
#: BASELINE config 4 (BASELINE.md, "Word2Vec skip-gram"; bench.py:410-470):
#: skip-gram with 5 negatives, HS off, vocab 10,000, vectors of 100, window
#: 5, batches of 1,024 pairs. The corpus: every word once, then 200,000
#: tokens drawn by Zipf's law (p ~ 1 / rank), in sentences of 20, from a
#: numpy seed
NLP_VOCAB, NLP_TOKENS, NLP_SENT = 10_000, 200_000, 20
NLP_DIM, NLP_NEG, NLP_WINDOW, NLP_BATCH = 100, 5, 5, 1024
#: the card's fit against the CPU's on the corpus's first tokens
NLP_CHECK_TOKENS = 20_000
#: batches profiled, and of the bare step at bench.py's shape
NLP_PROFILED = 32
#: card against CPU from the same seed and the same negatives,
#: ||card - cpu|| / ||cpu|| of each table: the scatter-adds accumulate in
#: another order on the card (atomics), and the float32 gaps grow over the
#: fit's hundred-odd batches
NLP_FIT_TOL = 1e-4


def _word(i: int) -> str:
    """The ``i``-th word: letters only, so CommonPreprocessor (the
    distributed pipeline's) keeps every word apart."""
    out = ""
    while True:
        i, r = divmod(i, 26)
        out += chr(ord("a") + r)
        if not i:
            return "w" + out


def _w2v_corpus(seed: int) -> list:
    rng = np.random.default_rng(seed)
    words = np.array([_word(i) for i in range(NLP_VOCAB)])
    p = 1.0 / np.arange(1, NLP_VOCAB + 1)
    ids = np.concatenate([rng.permutation(NLP_VOCAB),
                          rng.choice(NLP_VOCAB, NLP_TOKENS, p=p / p.sum())])
    toks = words[ids].tolist()
    return [toks[i:i + NLP_SENT] for i in range(0, len(toks), NLP_SENT)]


def _w2v(sentences, device, **kw):
    from deeplearning4j_tpu_torch.nlp import Word2Vec
    from deeplearning4j_tpu_torch.nlp.iterators import (
        CollectionSentenceIterator)
    b = (Word2Vec.builder().layer_size(kw.get("dim", NLP_DIM))
         .window_size(kw.get("window", NLP_WINDOW)).min_word_frequency(1)
         .seed(SEED).batch_size(kw.get("batch", NLP_BATCH)).device(device)
         .iterate(CollectionSentenceIterator(
             [" ".join(s) for s in sentences])))
    if kw.get("cbow"):
        b = b.elements_learning_algorithm("CBOW").use_hierarchic_softmax(True)
    else:
        b = b.negative_sample(NLP_NEG).use_hierarchic_softmax(False)
    return b.build()


class _one_cpu_thread:
    """The CPU references of the nlp phase on one thread: their ops are a
    few rows each, where a pool of threads costs more than it gives."""

    def __enter__(self):
        self.keep = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.keep)


def _tables_rel(card, cpu, names) -> dict:
    return {n: _norm_rel(getattr(card, n).cpu(), getattr(cpu, n))
            for n in names}


def _nlp_small(all_kernels) -> dict:
    """One small fit each on the card against the CPU from the same seed:
    HS CBOW Word2Vec, ParagraphVectors DBOW with infer_vector, GloVe,
    SparkWord2Vec on 4 workers, DeepWalk on a 1,000-vertex graph."""
    from deeplearning4j_tpu_torch.graph import DeepWalk, Graph
    from deeplearning4j_tpu_torch.nlp import Glove, ParagraphVectors
    from deeplearning4j_tpu_torch.nlp.distributed import SparkWord2Vec
    from deeplearning4j_tpu_torch.nlp.iterators import (
        LabelledDocument, SimpleLabelAwareIterator)
    sents = _w2v_corpus(SEED + 61)[:400]
    rng = np.random.default_rng(SEED + 62)
    g_edges = [(int(a), int(b)) for a, b in rng.integers(0, 1000, (4000, 2))
               if a != b]

    def fits(device):
        out = {}
        t0 = time.perf_counter()
        w = _w2v(sents, device, dim=32, cbow=True, batch=256)
        w.fit()
        out["cbow"] = (w.lookup, ("syn0", "syn1"), time.perf_counter() - t0)
        t0 = time.perf_counter()
        docs = [LabelledDocument(" ".join(s), [f"DOC_{i}"])
                for i, s in enumerate(sents[:100])]
        pv = (ParagraphVectors.builder().layer_size(32).window_size(4)
              .seed(SEED).device(device)
              .iterate(SimpleLabelAwareIterator(docs)).build())
        pv.fit()
        out["infer"] = pv.infer_vector(" ".join(sents[0]))
        out["pv_dbow"] = (pv.lookup, ("syn0", "syn1"),
                          time.perf_counter() - t0)
        t0 = time.perf_counter()
        gl = (Glove.builder().layer_size(32).window_size(4).epochs(2)
              .seed(SEED).batch_size(1024).device(device).build())
        gl.fit(sents[:200])
        out["glove"] = (gl.lookup, ("syn0",), time.perf_counter() - t0)
        t0 = time.perf_counter()
        sp = SparkWord2Vec(num_workers=4, vector_length=32, window=4,
                           seed=SEED, use_hierarchic_softmax=True,
                           batch_size=256, device=device).fit(
            [" ".join(s) for s in sents[:200]])
        out["spark4"] = (sp.master.lookup, ("syn0", "syn1"),
                         time.perf_counter() - t0)
        t0 = time.perf_counter()
        graph = Graph(1000)
        for a, b in g_edges:
            graph.add_edge(a, b)
        dw = (DeepWalk.builder().vector_size(32).window_size(4).seed(SEED)
              .device(device).build())
        dw.fit(graph, walk_length=10)
        out["deepwalk"] = (dw.model.lookup, ("syn0", "syn1"),
                           time.perf_counter() - t0)
        return out

    card = fits("cuda")
    with _one_cpu_thread():
        cpu = fits("cpu")
    res = {}
    for name in ("cbow", "pv_dbow", "glove", "spark4", "deepwalk"):
        lt, names, card_s = card[name]
        clt, _n, cpu_s = cpu[name]
        rel = _tables_rel(lt, clt, names)
        res[name] = {"rel": rel, "card_s": card_s, "cpu_s": cpu_s,
                     "finite": bool(torch.isfinite(lt.syn0).all())}
        print(f"nlp (b) {name}: card against CPU {rel} (tol "
              f"{NLP_FIT_TOL:.0e}); card {card_s:.2f}s, CPU {cpu_s:.2f}s",
              flush=True)
        if not (res[name]["finite"] and max(rel.values()) <= NLP_FIT_TOL):
            fail(f"nlp (b) {name}: card against CPU {rel}")
    inf = _norm_rel(torch.from_numpy(card["infer"]),
                    torch.from_numpy(cpu["infer"]))
    res["infer_vector_rel"] = inf
    print(f"nlp (b) infer_vector: card against CPU {inf:.3e}", flush=True)
    if not inf <= NLP_FIT_TOL:
        fail(f"nlp (b) infer_vector: {inf}")
    return res


def nlp_phase(kernels) -> dict:
    """A8.3's embedding engine on the card: Word2Vec at BASELINE config 4
    through ``Word2Vec.builder()...fit()`` (the corpus's first tokens on
    the card against the CPU, then the whole corpus on the card, pairs/s;
    32 batches profiled), the bare step at bench.py's shape, and the small
    fits of :func:`_nlp_small`. No TPU kernel lies on this path: no
    kernel's count may move."""
    from deeplearning4j_tpu_torch.nlp import learning
    all_kernels = tuple(kernels) + (fixed_matmul,)
    _zero(all_kernels)
    out = {"part_s": {}}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        out["part_s"][name] = now - t_part
        t_part = now
    sents = _w2v_corpus(SEED + 60)
    head = sents[:NLP_CHECK_TOKENS // NLP_SENT]
    # (a) the card against the CPU on the first tokens
    fitted = {}
    for device in ("cuda", "cpu"):
        w = _w2v(head, device)
        t0 = time.perf_counter()
        if device == "cuda":
            w.fit()
            torch.cuda.synchronize()
        else:
            with _one_cpu_thread():
                w.fit()
        fitted[device] = (w, time.perf_counter() - t0)
    rel = _tables_rel(fitted["cuda"][0].lookup, fitted["cpu"][0].lookup,
                      ("syn0", "syn1neg"))
    out["check"] = {"tokens": sum(map(len, head)), "rel": rel,
                    "card_s": fitted["cuda"][1], "cpu_s": fitted["cpu"][1]}
    print(f"nlp (a) Word2Vec config 4 on {out['check']['tokens']} tokens: "
          f"card against CPU {rel} (tol {NLP_FIT_TOL:.0e}); card "
          f"{fitted['cuda'][1]:.2f}s, CPU {fitted['cpu'][1]:.2f}s",
          flush=True)
    if max(rel.values()) > NLP_FIT_TOL:
        fail(f"nlp (a): card against CPU {rel}")
    del fitted
    part("check")
    # the whole corpus on the card
    w = _w2v(sents, "cuda")
    t0 = time.perf_counter()
    w.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pairs = w.pairs_trained
    syn0 = w.lookup.syn0
    if syn0.shape != (NLP_VOCAB, NLP_DIM) or not torch.isfinite(syn0).all():
        fail(f"nlp (a): syn0 {tuple(syn0.shape)}")
    global NLP_TABLE
    NLP_TABLE = syn0.detach().clone()
    out["fit"] = {"tokens": sum(map(len, sents)), "pairs": pairs,
                  "batches": -(-pairs // NLP_BATCH), "wall_s": wall,
                  "pairs_per_s": pairs / wall}
    print(f"nlp (a) Word2Vec config 4 fit: {out['fit']['tokens']} tokens, "
          f"{pairs} pairs in {out['fit']['batches']} batches, {wall:.2f}s "
          f"wall: {pairs / wall:.0f} pairs/s [{CARD}]", flush=True)
    part("fit")
    # 32 of its batches profiled: stage and step, as fit runs them
    acc = learning.BatchAccumulator(NLP_BATCH, 1, 1, NLP_VOCAB)
    batches = []
    gen = (b for s in sents for b in w._train_sequence(s, [], acc))
    while len(batches) < NLP_PROFILED:
        batches.append(next(gen))
    lt = w.lookup
    step = learning.make_train_step(False, NLP_NEG)
    C, S = learning.chunking(NLP_BATCH, 64)
    spare = torch.zeros((1, NLP_DIM), device="cuda")
    us = [torch.rand((C, S, NLP_NEG), generator=w._gen).numpy()
          for _ in batches]

    def run32():
        for b, u in zip(batches, us):
            st, lr, u_dev = learning.stage(b, "cuda", 0.025, u)
            step(lt.syn0, spare, lt.syn1neg, lt.cum_table, st, lr, u_dev)
    run32()
    torch.cuda.synchronize()
    # the device's events alone (no CPU op tracing: the 32 batches are some
    # 23,000 ops), their averages read once
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run32()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    t_read = time.perf_counter()
    averages = prof.key_averages()
    once = types.SimpleNamespace(key_averages=lambda: averages)
    dev_us = _device_us(once)
    top = sorted(((us_, k, n) for k, n, us_ in device_events(once)),
                 reverse=True)[:6]
    out["part_s"]["profile_readout"] = time.perf_counter() - t_read
    out["profile"] = {
        "batches": NLP_PROFILED, "wall_ms_per_batch": 1e3 * pwall / NLP_PROFILED,
        "device_ms_per_batch": dev_us / 1e3 / NLP_PROFILED,
        "idle": 1 - dev_us / 1e6 / pwall,
        "top_ops": [{"name": k[:80], "count": n, "us": u} for u, k, n in top]}
    print(f"nlp (a) profile of {NLP_PROFILED} batches: wall ms a batch "
          f"{out['profile']['wall_ms_per_batch']:.3f}, device ms a batch "
          f"{out['profile']['device_ms_per_batch']:.4f}, idle "
          f"{100 * out['profile']['idle']:.1f}%; top device ops "
          f"{[(t['name'][:48], t['count'], round(t['us'], 1)) for t in out['profile']['top_ops']]}",
          flush=True)
    part("profile")
    # the bare step at bench.py:410-470's shape: random pairs
    rng = np.random.default_rng(0)
    tab0 = torch.from_numpy(rng.normal(size=(NLP_VOCAB, NLP_DIM))
                            .astype(np.float32) * 0.01).cuda()
    tabn = torch.zeros((NLP_VOCAB, NLP_DIM), device="cuda")
    cum = torch.from_numpy((np.arange(1, NLP_VOCAB + 1) / NLP_VOCAB)
                           .astype(np.float32)).cuda()
    bare = []
    for _ in range(NLP_PROFILED):
        ones = np.ones((NLP_BATCH, 1), np.float32)
        zi = np.zeros((NLP_BATCH, 1), np.int32)
        hb = learning.PairBatch(
            rng.integers(0, NLP_VOCAB, (NLP_BATCH, 1)).astype(np.int32),
            ones, rng.integers(0, NLP_VOCAB, NLP_BATCH).astype(np.int32), zi,
            zi.astype(np.float32), zi.astype(np.float32),
            np.ones(NLP_BATCH, np.float32),
            rng.integers(0, NLP_VOCAB, (NLP_BATCH, 1)).astype(np.int32))
        bare.append(learning.stage(hb, "cuda", 0.025,
                                   rng.random((C, S, NLP_NEG),
                                              np.float32)))

    def run_bare():
        for st, lr, u_dev in bare:
            step(tab0, spare, tabn, cum, st, lr, u_dev)
    run_bare()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_bare()
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    # the least time: each pair reads its input row and 6 output rows and
    # writes the 7 back (float32, D = 100), the indices and uniforms once
    nbytes = NLP_BATCH * (7 * NLP_DIM * 4 * 2 + 4 * 3 + 4 * NLP_NEG)
    ops = NLP_BATCH * (1 + NLP_NEG) * NLP_DIM * 2 * 3
    bms, bby = bound(nbytes, ops)
    out["bare_step"] = {"wall_ms": 1e3 * bwall / NLP_PROFILED,
                        "bound_ms": bms, "bound_by": bby,
                        "pairs_per_s": NLP_BATCH * NLP_PROFILED / bwall}
    print(f"nlp (a) bare step at bench.py's shape (V {NLP_VOCAB}, D "
          f"{NLP_DIM}, {NLP_NEG} negatives, {NLP_BATCH} pairs): wall ms a "
          f"batch {out['bare_step']['wall_ms']:.3f} (its device time: the "
          f"profiled batches'), bound {bms:.5f} ({bby}); "
          f"{out['bare_step']['pairs_per_s']:.0f} pairs/s [{CARD}]",
          flush=True)
    del w, batches, bare
    part("bare_step")
    out["small"] = _nlp_small(all_kernels)
    part("small")
    print(f"nlp: seconds by part {out['part_s']}", flush=True)
    moved = {fn.__name__: fn.launches for fn in all_kernels if fn.launches}
    print(f"nlp: kernel launches during the phase {moved or 'none'}",
          flush=True)
    if moved:
        fail(f"nlp: a kernel launched on a path that has none: {moved}")
    return out


# ------------------------------------------------------- A8.3: embed
#: the embed phase: exact t-SNE at the JAX package's defaults (2
#: components, perplexity 30, 500 iterations) on every row of the nlp
#: phase's Word2Vec table (BASELINE config 4: 10,000 x 100); its step
#: profiled over a few steps at the fit's final state; card against CPU on
#: the first 1,000 rows (P, and coordinates after 3 iterations);
#: k-means at k 100 (up to 100 iterations); Barnes-Hut on the host at 256
#: rows, and its exact route below 64 rows on the card
EMBED_PERPLEXITY, EMBED_ITERS, EMBED_PROFILED = 30.0, 500, 5
EMBED_CHECK_ROWS, EMBED_CHECK_ITERS = 1000, 3
EMBED_K, EMBED_KMEANS_ITERS = 100, 100
EMBED_BH_N, EMBED_BH_ITERS, EMBED_BH_EXACT_N = 256, 50, 48
#: t-SNE's step: floating-point operations a pair (i, j) takes (the
#: difference 2, its square and sum 3, 1 + and 1 /, the kernel's sum, Q's
#: division and clamp, P - Q, the product by the kernel, the gradient's
#: product and sum over 2 components 4)
TSNE_PAIR_OPS = 16
#: tolerances of the card-against-CPU checks
EMBED_P_TOL, EMBED_Y_TOL, EMBED_CENTER_TOL = 1e-9, 1e-4, 1e-5
#: the nlp phase's trained syn0 (the embed phase's input), on the card
NLP_TABLE = None


def _embed_tsne_pair(sub) -> dict:
    """Exact t-SNE on the first rows on the card and on the CPU: P, the
    coordinates after 3 iterations, and KL(P || Q) at iteration 100 (the
    end of the exaggeration) and at the end, from one fit a device."""
    from deeplearning4j_tpu_torch.plot import Tsne, tsne
    runs = {}
    for device in ("cuda", "cpu"):
        seen = {}

        def keep(it, y, seen=seen):
            if it in (EMBED_CHECK_ITERS, 100):
                seen[it] = y.cpu().numpy()
        ts = Tsne(perplexity=EMBED_PERPLEXITY, max_iter=EMBED_ITERS,
                  device=device)
        t0 = time.perf_counter()
        y = ts.fit_transform(sub, callback=keep)
        runs[device] = {"P": ts.P.cpu(), "y3": seen[EMBED_CHECK_ITERS],
                        "kl_100": tsne.kl_divergence(ts.P, seen[100]),
                        "kl_final": tsne.kl_divergence(ts.P, y),
                        "wall_s": time.perf_counter() - t0}
    card, cpu = runs["cuda"], runs["cpu"]
    out = {"rows": len(sub),
           "P_rel": float(((card["P"] - cpu["P"]).abs() / cpu["P"]).max()),
           "y3_max_abs": float(np.abs(card["y3"] - cpu["y3"]).max()),
           **{f"{k}_{d}": runs[d][k] for d in runs
              for k in ("kl_100", "kl_final", "wall_s")}}
    print(f"embed (b) t-SNE card against CPU on {len(sub)} rows: P "
          f"{out['P_rel']:.3e} relative (tol {EMBED_P_TOL:.0e}), coordinates "
          f"after {EMBED_CHECK_ITERS} iterations {out['y3_max_abs']:.3e} "
          f"(tol {EMBED_Y_TOL:.0e}); KL at 100 / {EMBED_ITERS}: card "
          f"{card['kl_100']:.4f} / {card['kl_final']:.4f}, CPU "
          f"{cpu['kl_100']:.4f} / {cpu['kl_final']:.4f}; wall card "
          f"{card['wall_s']:.2f}s, CPU {cpu['wall_s']:.2f}s [{CARD}]",
          flush=True)
    if not out["P_rel"] <= EMBED_P_TOL or not out["y3_max_abs"] <= EMBED_Y_TOL:
        fail(f"embed (b): t-SNE card against CPU {out}")
    for d, r in runs.items():
        if not (np.isfinite(r["kl_final"]) and r["kl_final"] < r["kl_100"]):
            fail(f"embed (b): {d} KL {r['kl_final']} not below its value "
                 f"at iteration 100, {r['kl_100']}")
    return out


def _embed_kmeans(table) -> dict:
    """k-means at k 100 on every row, euclidean and cosine, on the card,
    then on the CPU: the same iterations, assignments and centers."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    out = {}
    for distance in ("euclidean", "cosine"):
        runs = {}
        for device in ("cuda", "cpu"):
            km = KMeansClustering(EMBED_K, EMBED_KMEANS_ITERS, seed=SEED,
                                  distance=distance, device=device)
            t0 = time.perf_counter()
            cs = km.apply_to(table)
            inertia = float(cs.inertia)   # a host read: the run's end
            runs[device] = (cs, inertia, time.perf_counter() - t0)
        (card, inertia, wall), (cpu, cpu_inertia, cpu_wall) = \
            runs["cuda"], runs["cpu"]
        r = {"iterations": card.iterations,
             "cpu_iterations": cpu.iterations, "inertia": inertia,
             "cpu_inertia": cpu_inertia, "wall_s": wall,
             "cpu_wall_s": cpu_wall,
             "assignments_differ": int((card.assignments.cpu()
                                        != cpu.assignments).sum()),
             "centers_max_abs": float((card.centers.cpu()
                                       - cpu.centers).abs().max())}
        out[distance] = r
        print(f"embed (c) k-means {distance}, k {EMBED_K}, {len(table)} rows: "
              f"{r['iterations']} iterations (CPU {r['cpu_iterations']}), "
              f"inertia {inertia:.6f} (CPU {cpu_inertia:.6f}), "
              f"{r['assignments_differ']} assignments differ, centers "
              f"{r['centers_max_abs']:.3e} (tol {EMBED_CENTER_TOL:.0e}); wall "
              f"{wall:.3f}s, CPU {cpu_wall:.3f}s [{CARD}]", flush=True)
        if r["iterations"] != r["cpu_iterations"] or r["assignments_differ"] \
                or not r["centers_max_abs"] <= EMBED_CENTER_TOL:
            fail(f"embed (c): k-means {distance} card against CPU {r}")
    return out


def embed_phase(kernels) -> dict:
    """A8.3's ``clustering/`` and ``plot/`` on the card over the nlp
    phase's Word2Vec table: (a) exact t-SNE on every row (wall, device ms a
    step from the profiler beside its bound, peak memory, the final KL);
    (b) t-SNE on the card against the CPU on the first 1,000 rows; (c)
    k-means at k 100 against the CPU; (d) Barnes-Hut on the host and its
    exact route on the card. No TPU kernel lies on this path: no kernel's
    count may move."""
    from deeplearning4j_tpu_torch.plot import BarnesHutTsne, Tsne, tsne
    all_kernels = tuple(kernels) + (fixed_matmul,)
    _zero(all_kernels)
    t_phase = time.perf_counter()
    if NLP_TABLE is not None:
        table = NLP_TABLE.float().cpu().numpy()
        source = "the nlp phase's trained syn0"
    else:
        rng = np.random.default_rng(SEED + 70)
        table = (rng.normal(size=(NLP_VOCAB, NLP_DIM)) * 0.1).astype(
            np.float32)
        source = (f"a seeded normal table (seed {SEED + 70}, scale 0.1): "
                  "the phase ran without the nlp phase")
    n = table.shape[0]
    print(f"embed: input {source}, {table.shape[0]} x {table.shape[1]}",
          flush=True)
    out = {"input": source, "rows": n, "dim": int(table.shape[1])}
    # (a) exact t-SNE on every row
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ts = Tsne(perplexity=EMBED_PERPLEXITY, max_iter=EMBED_ITERS,
              device="cuda")
    t0 = time.perf_counter()
    emb = ts.fit_transform(table)
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    kl = tsne.kl_divergence(ts.P, emb)
    if emb.shape != (n, 2) or not np.isfinite(emb).all() \
            or not np.isfinite(kl):
        fail(f"embed (a): t-SNE gave {emb.shape}, KL {kl}")
    # its step at the fit's final state, the same inputs each call
    P32 = ts.P.float()
    y = torch.from_numpy(emb).cuda()
    vel, gains = torch.zeros_like(y), torch.ones_like(y)

    def steps():
        for _ in range(EMBED_PROFILED):
            tsne.tsne_step(y, vel, gains, P32, ts.final_momentum,
                           ts.learning_rate)
    steps()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    steps()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / EMBED_PROFILED
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steps()
        torch.cuda.synchronize()
    dev_ms = _device_us(prof) / 1e3 / EMBED_PROFILED
    nbytes = n * n * 4 + 6 * n * 2 * 4
    bms, bby = bound(nbytes, TSNE_PAIR_OPS * n * n)
    out["tsne"] = {"iterations": EMBED_ITERS, "perplexity": EMBED_PERPLEXITY,
                   "wall_s": wall, "step_device_ms": dev_ms,
                   "step_event_ms": event_ms, "step_bound_ms": bms,
                   "step_bound_by": bby, "peak_gib": peak, "kl": kl}
    print(f"embed (a) exact t-SNE on {n} rows, perplexity "
          f"{EMBED_PERPLEXITY:g}, {EMBED_ITERS} iterations: {wall:.2f}s wall; "
          f"a step {dev_ms:.3f} device ms (profiler, {EMBED_PROFILED} steps), "
          f"{event_ms:.3f} ms (CUDA events), bound {bms:.4f} ms ({bby}); "
          f"peak {peak:.2f} GiB above the phase's start; final KL {kl:.4f} "
          f"[{CARD}]", flush=True)
    del ts, P32, y, vel, gains
    # (b) the card against the CPU on the first rows
    out["tsne_check"] = _embed_tsne_pair(table[:EMBED_CHECK_ROWS])
    # (c) k-means
    out["kmeans"] = _embed_kmeans(table)
    # (d) Barnes-Hut: the host loop, and its exact route on the card
    bh = BarnesHutTsne(perplexity=EMBED_PERPLEXITY, max_iter=EMBED_BH_ITERS,
                       device="cuda")
    t0 = time.perf_counter()
    bemb = bh.fit(table[:EMBED_BH_N])
    bh_wall = time.perf_counter() - t0
    small = table[:EMBED_BH_EXACT_N]
    exact = BarnesHutTsne(perplexity=EMBED_PERPLEXITY,
                          max_iter=EMBED_CHECK_ITERS, device="cuda").fit(small)
    ref = Tsne(perplexity=EMBED_PERPLEXITY, max_iter=EMBED_CHECK_ITERS,
               device="cpu").fit_transform(small)
    exact_err = float(np.abs(exact - ref).max())
    out["barnes_hut"] = {"rows": EMBED_BH_N, "iterations": EMBED_BH_ITERS,
                         "wall_s": bh_wall, "exact_rows": EMBED_BH_EXACT_N,
                         "exact_max_abs": exact_err}
    print(f"embed (d) Barnes-Hut t-SNE on the host, {EMBED_BH_N} rows, "
          f"{EMBED_BH_ITERS} iterations: {bh_wall:.2f}s wall; its exact route "
          f"at {EMBED_BH_EXACT_N} rows on the card against the CPU after "
          f"{EMBED_CHECK_ITERS} iterations {exact_err:.3e} (tol "
          f"{EMBED_Y_TOL:.0e})", flush=True)
    if bemb.shape != (EMBED_BH_N, 2) or not np.isfinite(bemb).all() \
            or not exact_err <= EMBED_Y_TOL:
        fail(f"embed (d): Barnes-Hut {bemb.shape}, exact route {exact_err}")
    out["seconds"] = time.perf_counter() - t_phase
    moved = {fn.__name__: fn.launches for fn in all_kernels if fn.launches}
    print(f"embed: {out['seconds']:.1f}s; kernel launches during the phase "
          f"{moved or 'none'}", flush=True)
    if moved:
        fail(f"embed: a kernel launched on a path that has none: {moved}")
    return out


#: the phases :func:`run_phases` runs alone, by name
PHASES_ALONE = {"c3": lambda k: c3_phase(), "sharded_pins": _sh_pins,
                "sharded": sharded_phase,
                "fixed_matmul": lambda k: check_fixed_matmul(
                    [], torch.device("cuda")),
                "keras": keras_phase, "native": native_phase,
                "nlp": nlp_phase, "embed": embed_phase,
                "serve": lambda k: serve(k[:3]),
                "tracing": lambda k: serve(k[:3])["tracing"],
                "replicas": replicas_phase,
                "diagnostics": diagnostics_phase,
                "parallel": parallel_phase,
                "param_server": param_server_phase,
                "elastic": elastic_phase}


def run_phases(*names: str) -> dict:
    """Run the named phases alone (after the card setup and the kernel
    build), for debugging them on the card:
    ``python3 -c "import chip_smoke; chip_smoke.run_phases('keras')"``."""
    global CARD
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(CARD, flush=True)
    _cuda.build()
    kernels = (int8_matmul, paged_gather, flash_fwd, softmax_cross_entropy,
               flash_bwd_dq, flash_bwd_dkv, lstm_ops.lstm_fwd,
               lstm_ops.lstm_bwd)
    out = {}
    for name in names:
        t0 = time.perf_counter()
        out[name] = PHASES_ALONE[name](kernels)
        print(f"phase {name}: {time.perf_counter() - t0:.1f}s", flush=True)
    return out


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    # full float32 matmuls and convolutions, as the reference computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = CARD = smi.splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    _cuda.build()
    build_s = time.perf_counter() - t0
    print(f"built {_cuda.sources()} with nvcc for sm_90a in {build_s:.1f}s",
          flush=True)
    for name, log in sorted(_cuda.build_log.items()):
        for entry in ptxas_report(log):
            print(f"  {name}: {entry}", flush=True)

    dev = torch.device("cuda")
    rows: list = []
    check_int8(rows, dev)
    check_gather(rows, dev)
    check_flash(rows, dev)
    check_xent(rows, dev)
    check_flash_bwd(rows, dev)
    check_flash_noncausal(rows, dev)
    check_lstm(rows, dev)
    check_bf16(rows, dev)
    check_fixed_matmul(rows, dev)

    kernels = (int8_matmul, paged_gather, flash_fwd, softmax_cross_entropy,
               flash_bwd_dq, flash_bwd_dkv, lstm_ops.lstm_fwd,
               lstm_ops.lstm_bwd)
    served = serve(kernels[:3])
    # the host-bound K-step paths are timed before any profiler session
    kstep_run = {"lenet": ksteps_lenet(kernels),
                 "transformer": ksteps_transformer(kernels)}
    trained = train(kernels[:6])
    wide = train_wide(kernels)
    wide2 = train_wide(kernels, n_heads=WIDE2_HEADS)
    served_rnn = serve_lstm(kernels)
    trained_rnn = train_lstm(kernels)
    lenet_run = lenet(kernels)
    resnet_run = resnet(kernels)
    for pending in PROFILE_LATER:
        _profile_pair(*pending)
    t0 = time.perf_counter()
    diag_run = diagnostics_phase(kernels)
    print(f"phase diagnostics: {time.perf_counter() - t0:.1f}s", flush=True)
    kstep_run["resnet50"] = ksteps_resnet(kernels)
    graph_rnn_run = graph_rnn(kernels)
    dtype_run = dtype_phase(kernels)
    files_run = files_phase(kernels)
    phase_s = {}
    for name, phase in (("self_attention", self_attention), ("moe", moe),
                        ("zoo", zoo), ("pretrain", pretrain_phase),
                        ("iris", iris), ("spec", spec_phase),
                        ("replicas", replicas_phase),
                        ("multi_input", multi_input_phase),
                        ("parallel", parallel_phase),
                        ("param_server", param_server_phase),
                        ("elastic", elastic_phase),
                        ("c3", lambda k: c3_phase()),
                        ("sharded", sharded_phase),
                        ("keras", keras_phase), ("native", native_phase),
                        ("nlp", nlp_phase), ("embed", embed_phase)):
        t0 = time.perf_counter()
        phase_s[name] = (phase(kernels), time.perf_counter() - t0)
        print(f"phase {name}: {phase_s[name][1]:.1f}s", flush=True)
    sa_run, moe_run, zoo_run, pretrain_run, iris_run = (
        phase_s[n][0] for n in ("self_attention", "moe", "zoo", "pretrain",
                                "iris"))
    spec_run, replicas_run, multi_run, par_run, ps_run, el_run, sh_run = (
        phase_s[n][0] for n in ("spec", "replicas", "multi_input",
                                "parallel", "param_server", "elastic",
                                "sharded"))
    c3_run, keras_run, native_run, nlp_run, embed_run = (
        phase_s[n][0] for n in ("c3", "keras", "native", "nlp", "embed"))
    t0 = time.perf_counter()
    measure_device_times()
    print(f"device times: {time.perf_counter() - t0:.1f}s; the script so far "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)

    # one entry per kernel, at the shape its main path gave it: decode at
    # capacity 8 (M = 8, the widest matmul), predict at B = 2, training at
    # B = 16, T = 256; the flash kernels also carry the numbers of their
    # other paths (training, the wide phase at D = 128) under "by_path"
    train_shape = {"B": TRAIN_B, "T": TRAIN_T, "D": 64}
    wide_shape = {"B": WIDE_B, "T": WIDE_T, "D": 128}
    wide2_shape = {"B": WIDE_B, "T": WIDE_T, "D": WIDE_WIDTH // WIDE2_HEADS}
    rnn_xent = {"N": RNN_B * RNN_CHUNK, "C": RNN_V, "dtype": "torch.float32"}
    lenet_xent = {"N": LENET_B, "C": 10, "dtype": "torch.float32"}
    resnet_xent = {"N": RES_B, "C": RES_CLASSES, "dtype": "torch.float32"}
    main_shape = {"int8_matmul": {"M": 8, "K": 256, "N": 1024},
                  "paged_gather": {"cap": 8},
                  "flash_fwd": {"B": 2, "T": 512, "D": 64},
                  "sm_xent": {"N": TRAIN_B * TRAIN_T, "C": TRAIN_V,
                              "dtype": "torch.float32"},
                  "flash_bwd_dq": train_shape, "flash_bwd_dkv": train_shape}
    rnn_train = {"T": RNN_CHUNK, "B": RNN_B, "F": RNN_V, "H": RNN_H,
                 "peephole": True, "masked": False}
    rnn_paths = {"decode": dict(rnn_train, T=1, B=RNN_DECODE_B),
                 "stream": dict(rnn_train, T=1, B=1), "train": rnn_train}
    main_shape["lstm_fwd"] = main_shape["lstm_bwd"] = rnn_train

    def row_at(name, want):
        """The row of ``name`` at ``want``'s shape keys, float32 unless
        ``want`` names a dtype."""
        want = {"dtype": "torch.float32", **want}
        return next(r for r in rows if r["name"] == name and all(
            r["shape"].get(k, "torch.float32" if k == "dtype" else None) == v
            for k, v in want.items()))

    # the dtype phase's paths: every launch on them, and those whose
    # operands were bf16 (seen by DtypeSeen), by kernel
    dt_res = dtype_run["resnet50"]
    dt_lm, dt_rnn = dtype_run["transformer"], dtype_run["char_rnn"]
    dtype_paths = {
        "dtype_resnet50_check": dtype_run["resnet50_check"]["launches"],
        "dtype_resnet50_eager": dt_res["eager_launches"],
        "dtype_resnet50_float32_eager": dt_res["float32_eager_launches"],
        "dtype_resnet50_ksteps": dt_res["kstep_launches"],
        "dtype_transformer_train": dt_lm["train_launches"],
        "dtype_transformer_ksteps": dt_lm["kstep_launches"],
        "dtype_transformer_generate": dt_lm["generate_launches"],
        "dtype_transformer_predict": dt_lm["predict_launches"],
        "dtype_rnn_train": dt_rnn["train_launches"],
        "dtype_rnn_decode": dt_rnn["decode_launches"],
        "dtype_rnn_stream": dt_rnn["stream_launches"]}
    bf16_paths = {
        "flash_fwd": ("dtype_transformer_train", "dtype_transformer_ksteps",
                      "dtype_transformer_predict"),
        "flash_bwd_dq": ("dtype_transformer_train",
                         "dtype_transformer_ksteps"),
        "flash_bwd_dkv": ("dtype_transformer_train",
                          "dtype_transformer_ksteps"),
        "int8_matmul": ("dtype_transformer_generate",),
        "lstm_fwd": ("dtype_rnn_train", "dtype_rnn_decode",
                     "dtype_rnn_stream"),
        "lstm_bwd": ("dtype_rnn_train",)}
    bf16_shape = {"flash_fwd": dict(train_shape, dtype="torch.bfloat16"),
                  "flash_bwd_dq": dict(train_shape, dtype="torch.bfloat16"),
                  "flash_bwd_dkv": dict(train_shape, dtype="torch.bfloat16"),
                  "int8_matmul": {"M": 8, "K": 256, "N": 1024,
                                  "dtype": "torch.bfloat16"},
                  "lstm_fwd": dict(rnn_train, dtype="torch.bfloat16"),
                  "lstm_bwd": dict(rnn_train, dtype="torch.bfloat16")}

    # the files phase's paths, every launch on each
    files_paths = {
        "files_early_stopping": files_run["lenet"]["launches"],
        "files_resnet50_resume": files_run["resnet50"]["launches"],
        "files_transformer_memory":
            files_run["transformer"]["launches"]["memory"],
        "files_transformer_file": files_run["transformer"]["launches"]["file"],
        "files_lbfgs": files_run["lbfgs"]["launches"]}

    # the A5 paths, every launch on each
    a5_paths = {
        "selfattention": sa_run["launches"],
        "selfattention_timed": sa_run["timed_launches"],
        "moe_train": moe_run["launches"],
        "moe_ksteps": moe_run["kstep"]["launches"],
        "moe_eager": moe_run["eager_launches"],
        "moe_predict": moe_run["predict_launches"],
        "vgg16": zoo_run["vgg16"]["launches"],
        "alexnet": zoo_run["alexnet"]["launches"],
        "googlenet": zoo_run["googlenet"]["launches"],
        "vgg16_check": zoo_run["vgg16"]["check"]["launches"],
        "alexnet_check": zoo_run["alexnet"]["check"]["launches"],
        "googlenet_check": zoo_run["googlenet"]["check"]["launches"],
        "pretrain": pretrain_run["launches"], "iris": iris_run["launches"],
        "spec": spec_run["launches"], "replicas": replicas_run["launches"]}
    sa_shape = {"B": SA_B, "H": SA_H, "D": SA_D, "causal": False}
    a5_rows = {"noncausal": dict(sa_shape, T=SA_T, masked=False),
               "noncausal_ragged": dict(sa_shape, T=SA_RAGGED_T,
                                        masked=False),
               "noncausal_masked": dict(sa_shape, T=SA_T, masked=True)}
    # sm_xent's rows: each path's shape and the paths launching at it
    a5_xent = {"moe": ({"N": MOE_B * MOE_T, "C": MOE_V}, ("moe_train",)),
               "vgg16": ({"N": VGG_B, "C": ZOO_CLASSES}, ("vgg16",)),
               "vgg16_check": ({"N": VGG_CHECK_B, "C": ZOO_CLASSES},
                               ("vgg16_check",)),
               "alexnet_googlenet": ({"N": ZOO_OTHER_B, "C": ZOO_CLASSES},
                                     ("alexnet", "googlenet")),
               "alexnet_googlenet_check": (
                   {"N": ZOO_SMALL_B, "C": ZOO_CLASSES},
                   ("alexnet_check", "googlenet_check")),
               "selfattention": ({"N": SA_B, "C": 10},
                                 ("selfattention", "selfattention_timed")),
               "pretrain": ({"N": PT_B, "C": 10}, ("pretrain",)),
               "iris": ({"N": IRIS_B, "C": 3}, ("iris",))}

    def add_dtype_paths(entry, fname, name):
        entry["launches_by_path"].update(
            {p: n[fname] for p, n in {**dtype_paths, **files_paths,
                                       **a5_paths}.items()})
        if name.startswith("flash"):
            by = entry.setdefault("by_path", {})
            by["moe"] = {"launches": moe_run["launches"][fname],
                         **nums(row_at(name, {"B": MOE_B, "T": MOE_T,
                                              "D": 64}))}
            for path, shp in a5_rows.items():
                by[path] = {"launches": {
                    "noncausal": sa_run["unmasked_launches"][fname],
                    "noncausal_masked": sa_run["masked_launches"][fname]}
                    .get(path, 0), **nums(row_at(name, shp))}
        elif name == "sm_xent":
            for path, (shp, lpaths) in a5_xent.items():
                entry["by_path"][path] = {
                    "launches": sum(a5_paths[p][fname] for p in lpaths),
                    **nums(row_at(name, shp))}
        if name in bf16_paths:
            entry["bf16_launches_by_path"] = {
                p: dtype_paths[p][fname] for p in bf16_paths[name]}
            entry.setdefault("by_path", {})["bf16"] = {
                "launches": sum(entry["bf16_launches_by_path"].values()),
                **nums(row_at(name, bf16_shape[name]))}

    # the A8 paths (the keras and native phases), every launch on each,
    # and the shapes sm_xent and the LSTM kernels took on them
    a8_paths = {
        "keras_vgg16_finetune": keras_run["vgg16"]["launches"],
        "keras_lstm_output": keras_run["lstm"]["sigmoid"]["output_launches"],
        "keras_gateway_fit":
            keras_run["lstm"]["sigmoid"]["fit"]["launches"],
        "keras_gateway_evaluate":
            keras_run["lstm"]["sigmoid"]["evaluate"]["launches"],
        "keras_gateway_predict":
            keras_run["lstm"]["sigmoid"]["predict"]["launches"],
        "keras_hard_sigmoid_output":
            keras_run["lstm"]["hard_sigmoid"]["output_launches"],
        "keras_hard_sigmoid_fit":
            keras_run["lstm"]["hard_sigmoid"]["fit_launches"],
        "native_lenet_epoch": native_run["mnist"]["launches"],
        "native_csv_mlp": native_run["csv"]["launches"]}
    keras_lstm = {"T": KERAS_RNN_T, "B": KERAS_RNN_B, "F": KERAS_RNN_V,
                  "H": KERAS_RNN_H, "peephole": False, "masked": False}
    keras_xent = {"N": KERAS_RNN_B * KERAS_RNN_T, "C": KERAS_RNN_V}
    a8_shapes = {
        "sm_xent": {"keras_vgg16_finetune": {"N": KERAS_VGG_B, "C": 1000},
                    "keras_gateway_fit": keras_xent,
                    "keras_hard_sigmoid_fit": keras_xent,
                    "native_lenet_epoch": {"N": NATIVE_B, "C": 10},
                    "native_csv_mlp": {"N": NATIVE_CSV_B, "C": 3}},
        "lstm_fwd": {"keras_lstm_output": keras_lstm,
                     "keras_gateway_fit": keras_lstm,
                     "keras_gateway_evaluate": keras_lstm},
        "lstm_bwd": {"keras_gateway_fit": keras_lstm}}

    def add_a8_paths(entry, fname, name):
        entry["launches_by_path"].update(
            {p: n[fname] for p, n in a8_paths.items()})
        for path, shp in a8_shapes.get(name, {}).items():
            entry.setdefault("by_path", {})[path] = {
                "launches": a8_paths[path][fname], **nums(row_at(name, shp))}

    numbers = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "shape")
    #: present on some rows only: profiler device times, the flash kernels'
    #: float32 bound, the card of the redesigned kernels' rows, int8_matmul's
    #: and sm_xent's plans, lstm_fwd's and lstm_bwd's parts
    optional = ("device_ms", "library_device_ms", "bound_f32_ms",
                "bound_f32_by", "card", "plan", "bwd_parts_ms", "fwd_parts_ms")

    def nums(row):
        return {**{k: row[k] for k in numbers},
                **{k: row[k] for k in optional if k in row}}

    meta = {
        "int8_matmul": ("deeplearning4j_tpu_torch/csrc/int8_matmul.cu",
                        "deeplearning4j_tpu/ops/quant.py:157"),
        "paged_gather": ("deeplearning4j_tpu_torch/csrc/paged_gather.cu",
                         "deeplearning4j_tpu/ops/paged_attention.py:79"),
        "flash_fwd": ("deeplearning4j_tpu_torch/csrc/flash_fwd.cu",
                      "deeplearning4j_tpu/ops/pallas_kernels.py:180"),
        "sm_xent": ("deeplearning4j_tpu_torch/csrc/sm_xent.cu",
                    "deeplearning4j_tpu/ops/pallas_kernels.py:678"),
        "flash_bwd_dq": ("deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
                         "deeplearning4j_tpu/ops/pallas_kernels.py:519"),
        "flash_bwd_dkv": ("deeplearning4j_tpu_torch/csrc/flash_bwd.cu",
                          "deeplearning4j_tpu/ops/pallas_kernels.py:543"),
        "lstm_fwd": ("deeplearning4j_tpu_torch/csrc/lstm.cu",
                     "deeplearning4j_tpu/ops/lstm.py:486"),
        "lstm_bwd": ("deeplearning4j_tpu_torch/csrc/lstm.cu",
                     "deeplearning4j_tpu/ops/lstm.py:539"),
    }
    line = []
    for fn in kernels:
        fname = fn.__name__
        name = "sm_xent" if fname == "softmax_cross_entropy" else fname
        row = row_at(name, main_shape[name])
        if name.startswith("lstm"):
            # the recurrent path: TBPTT training is the main path of both;
            # the forward also runs in decode and streaming, at T = 1
            by_path = {"decode": served_rnn["decode_launches"][fname],
                       "stream": served_rnn["stream_launches"][fname],
                       "train": trained_rnn["launches"][fname],
                       "graph_rnn_tbptt": graph_rnn_run["launches"][fname],
                       "graph_rnn_time_step":
                           graph_rnn_run["step_launches"][fname],
                       "graph_rnn_stream":
                           graph_rnn_run["stream_launches"][fname]}
            entry = {"name": name, "route": "cuda", "source": meta[name][0],
                     "replaces": meta[name][1], "launches": by_path["train"],
                     "launches_by_path": by_path,
                     **nums(row)}
            if name == "lstm_fwd":
                entry["by_path"] = {
                    p: {"launches": by_path[p],
                        **nums(row_at(name, shp))}
                    for p, shp in rnn_paths.items()}
            add_dtype_paths(entry, fname, name)
            add_a8_paths(entry, fname, name)
            line.append(entry)
            continue
        by_path = {"serve": served["launches"].get(fname, 0),
                   "train": trained["launches"][fname],
                   "wide": wide["output_launches"][fname]
                   + wide["launches"][fname],
                   "wide_d256": wide2["output_launches"][fname]
                   + wide2["launches"][fname],
                   "rnn": trained_rnn["launches"][fname]
                   + served_rnn["decode_launches"][fname]
                   + served_rnn["stream_launches"][fname],
                   "lenet": lenet_run["launches"][fname],
                   "resnet50": resnet_run["launches"][fname],
                   "graph_rnn": graph_rnn_run["launches"][fname],
                   "diagnostics": diag_run["launches"][fname]}
        # the K-step paths: launches counted as the replays count them
        # (each replay adds its capture's launches)
        for path, run in kstep_run.items():
            by_path[f"ksteps_{path}"] = run["launches"][fname]
        entry = {"name": name, "route": "cuda", "source": meta[name][0],
                 "replaces": meta[name][1],
                 "launches": by_path["train" if name in
                                     ("sm_xent", "flash_bwd_dq",
                                      "flash_bwd_dkv") else "serve"],
                 "launches_by_path": by_path,
                 **nums(row)}
        if name == "flash_fwd":
            entry["by_path"] = {
                "serve": {"launches": by_path["serve"],
                          **nums(row)},
                "train": {"launches": by_path["train"],
                          **nums(row_at(name, train_shape))},
                "wide": {"launches": by_path["wide"],
                         **nums(row_at(name, wide_shape))},
                "wide_d256": {"launches": by_path["wide_d256"],
                              **nums(row_at(name, wide2_shape))}}
        elif name.startswith("flash_bwd"):
            entry["by_path"] = {
                "train": {"launches": by_path["train"], **nums(row)},
                "wide": {"launches": by_path["wide"],
                         **nums(row_at(name, wide_shape))},
                "wide_d256": {"launches": by_path["wide_d256"],
                              **nums(row_at(name, wide2_shape))}}
        elif name == "sm_xent":
            entry["by_path"] = {
                "train": {"launches": by_path["train"], **nums(row)},
                "rnn": {"launches": by_path["rnn"],
                        **nums(row_at(name, rnn_xent))},
                "lenet": {"launches": by_path["lenet"],
                          **nums(row_at(name, lenet_xent))},
                "resnet50": {"launches": by_path["resnet50"],
                             **nums(row_at(name, resnet_xent))}}
        elif name == "int8_matmul":
            entry["by_path"] = {"serve": {"launches": by_path["serve"],
                                          **nums(row)}}
        # the A6 paths: spec decoding's verify rounds (the decode shapes),
        # the replicas' predicts (flash at their widest dispatch)
        if name in ("int8_matmul", "paged_gather"):
            entry.setdefault("by_path", {})["spec"] = {
                "launches": spec_run["launches"][fname],
                "verify_rounds": spec_run["rounds"], **nums(row)}
        if name in ("int8_matmul", "paged_gather", "flash_fwd"):
            entry.setdefault("by_path", {})["replicas"] = {
                "launches": replicas_run["launches"][fname],
                "dispatches": replicas_run["dispatches"],
                **nums(row_at(name, {"B": REPLICA_B, "T": REPLICA_T, "D": 64})
                       if name == "flash_fwd" else row)}
        add_dtype_paths(entry, fname, name)
        # the A7 paths (an NCCL group of one, the training shape): sync DP's
        # single steps, its K-step group, Ulysses
        if fname in par_run["launches"]["parallel_dp"]:
            train_row = row_at(name, train_shape if name != "sm_xent"
                               else main_shape["sm_xent"])
            for path in ("parallel_dp", "parallel_ksteps",
                         "parallel_ulysses"):
                entry.setdefault("by_path", {})[path] = {
                    "launches": par_run["launches"][path][fname],
                    **nums(train_row)}
            entry["launches_by_path"].update(
                {p: n[fname] for p, n in par_run["launches"].items()})
            # A7.3/A7.4, new paths of the same kernels at the training
            # shape: the PS workers' steps (threads, then processes, whose
            # launches each process counted) and the elastic workers'
            ps_paths = dict(ps_run["launches"],
                            elastic=el_run["run"]["launches"])
            for path, n in ps_paths.items():
                entry["by_path"][path] = {"launches": n[fname],
                                          **nums(train_row)}
                entry["launches_by_path"][path] = n[fname]
            # A7.5, A7.6, A7.9: each path at its shape on a rank (the
            # pipeline's microbatch, an expert-parallel rank's rows, a
            # dp_tp rank's heads; sm_xent's rows), with the launches of the
            # group of one and of each gloo rank (in rank order)
            flash_at = {"pipe": {"B": TRAIN_B // PAR_PIPE_M, "T": TRAIN_T,
                                 "H": 4, "D": 64},
                        "moe": {"B": MOE_B, "T": MOE_T, "H": 4, "D": 64},
                        "ep_rank": {"B": MOE_B // 2, "T": MOE_T, "H": 4,
                                    "D": 64},
                        "tp_rank": {"B": TRAIN_B, "T": TRAIN_T,
                                    "H": PAR_TP_HEADS, "D": 64}}
            xent_at = {"pipe": main_shape["sm_xent"],
                       "moe": {"N": MOE_B * MOE_T, "C": MOE_V},
                       "ep_rank": {"N": MOE_B // 2 * MOE_T, "C": MOE_V},
                       "tp_rank": main_shape["sm_xent"]}
            gloo = par_run["gloo"]
            for path, n, at in (
                    ("parallel_pipeline",
                     par_run["launches"]["parallel_pipeline"][fname], "pipe"),
                    ("parallel_expert",
                     par_run["launches"]["parallel_expert"][fname], "moe"),
                    ("gloo_pipeline",
                     [r[fname] for r in gloo["pipeline"]["launches"]],
                     "pipe"),
                    ("gloo_expert",
                     [r[fname] for r in gloo["expert"]["launches"]],
                     "ep_rank"),
                    ("gloo_dp_tp",
                     [r[fname] for r in gloo["dp_tp"]["launches"]],
                     "tp_rank")):
                shape = xent_at[at] if name == "sm_xent" else flash_at[at]
                per_rank = n if isinstance(n, list) else None
                entry["by_path"][path] = {
                    "launches": sum(per_rank) if per_rank else n,
                    **({"launches_per_rank": per_rank} if per_rank else {}),
                    **nums(row_at(name, shape))}
                entry["launches_by_path"][path] = n
            # A7.8's second half: the sharded pins' and replicas' forwards
            # (flash_fwd), and on each gloo rank the restore's output and
            # the fits from it, and the fits with whole views
            sh = {"sharded_pins": sh_run["pins"]["launches"]
                  if fname == "flash_fwd" else 0,
                  "sharded_replicas": sh_run["replicas"]["launches"]
                  if fname == "flash_fwd" else 0,
                  "sharded_restore_output": [
                      r["output_launches"][fname] for r in sh_run["restore"]],
                  "sharded_restore_fit": [
                      r["fit_launches"][fname] for r in sh_run["restore"]]}
            for mode, runs in sh_run["views"].items():
                sh[f"sharded_views_{mode}"] = [r["launches"][fname]
                                               for r in runs]
            entry["launches_by_path"].update(sh)
            if fname == "flash_fwd":
                entry["by_path"]["sharded_pins"] = {
                    "launches": sh["sharded_pins"],
                    **nums(row_at(name, {"B": 8 // SH_AXES["data"],
                                         "T": 512, "D": 64}))}
        add_a8_paths(entry, fname, name)
        line.append(entry)
    # C3's repair: the serving pins' dense products, at a data slot's
    # share of the whole pin's [8, 512] (the FFN's down-projection); no
    # TPU kernel stands behind it (XLA's dot in the JAX package)
    line.append({"name": "fixed_matmul", "route": "cuda",
                 "source": "deeplearning4j_tpu_torch/csrc/fixed_matmul.cu",
                 "replaces": "deeplearning4j_tpu/nn/conf/layers/"
                             "feedforward.py:34",
                 "launches": sh_run["pins"]["fixed_matmul_launches"],
                 **nums(row_at("fixed_matmul",
                               {"M": 2048, "K": 1024, "N": 256}))})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "rows": rows,
                   "serve": served, "train": trained, "train_wide": wide,
                   "train_wide_d256": wide2, "flash_bwd_wide_edges": WIDE_EDGES,
                   "serve_rnn": served_rnn,
                   "train_rnn": trained_rnn, "lenet": lenet_run,
                   "resnet50": resnet_run, "ksteps": kstep_run,
                   "graph_rnn": graph_rnn_run, "diagnostics": diag_run,
                   "dtype": dtype_run,
                   "files": files_run, "self_attention": sa_run,
                   "moe": moe_run, "zoo": zoo_run, "pretrain": pretrain_run,
                   "iris": iris_run, "spec": spec_run,
                   "replicas": replicas_run, "multi_input": multi_run,
                   "parallel": par_run, "param_server": ps_run,
                   "elastic": el_run, "sharded": sh_run, "c3": c3_run,
                   "keras": keras_run, "native": native_run,
                   "nlp": nlp_run, "embed": embed_run,
                   "phase_seconds": {n: v[1] for n, v in phase_s.items()},
                   "kernels": line,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
