#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card: build, check, serve, train.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (nvcc)::

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result):

1. The card's name and power limit (``nvidia-smi``), and the build of
   every CUDA kernel of the port from ``sparknet_tpu_torch/ops/csrc``.
2. Each kernel against its plain PyTorch version on the card, in
   float32, at the serving path's shapes — flash forward (causal and
   not, T in 16..256, a ragged T_q, a block of fully-masked rows; also
   the LM training shape, q, k, v as views of one fused qkv tensor, D=16,
   32, 48, 128 and 256, D=40 and 200 padded, and two launches at the LM
   shape giving the same bits) and decode attention over the paged KV
   arena (the serving geometry: 8 slots, 64 blocks of 16 and the trash
   block, each slot's table drawn shuffled, lengths 1-256; at D=64, 16,
   48, 256 and 40, the arena kept at the built head dim; two launches
   giving the same bits, no copy; length 0 giving o = 0; and through the
   gathered entry point), then 8 decode steps of a head-dim-40 engine
   that copy nothing — then each kernel's time
   beside its plain version's, one PyTorch library call's
   (``scaled_dot_product_attention``, a yardstick the port never calls)
   and the least time the card could take, the flash forward also at the
   LM training shape (B=8, T=256, H=4, D=64, causal), decode attention
   also at head dim 256 (H=2).
3. End to end at the CLI's default model (``TransformerLM(dim=256,
   depth=4, heads=4, seq_len=256)``, seeded weights): the engine is
   built and warmed as ``cli serve --generate`` does, ``ServeServer``
   listens on a loopback port, and 4 concurrent ``POST /generate``
   streams of 32 tokens are read back.  Kernel launch counts are reset
   just before the requests and read just after.  Every streamed
   logprob is held against a CPU copy of the same model (plain
   attention) scoring the same tokens teacher-forced, and every token
   against the CPU model's argmax except where its top-2 logit margin
   is a near-tie.  The decode step with 8 live slots is profiled: every
   device row printed, decode attention once a layer, no context gather
   and no more launches than the step that gathered (190).

4. The comm plane's epilogue kernels — K9 encode, K10 barriered apply,
   K11 overlap correction — against their plain versions on the card,
   bit for bit (the readout's sums within 1e-5), at the three comm
   chunks of cifar10_full at W=4 and of AlexNet at W=2 (its 16
   parameter leaves, fc6's 37,748,736 floats a worker), and at the four
   of ResNet-50 at W=2 (320 leaves: 161 parameters, then 159 BatchNorm
   stat blobs, so a chunk holds over 100; one launch a group of at most
   32 leaves, the launches counted against that arithmetic): fp32, bf16
   and int8, the error readout on and off, a masked worker and no
   survivors for K10, an all-zero leaf.  Then each kernel's time over one
   round's launches (every chunk) at the three widths beside its plain
   version's and
   the least time the card could take (bytes over 3.35 TB/s: the
   function's, and the design's: K9's two passes, K10's and K11's mean
   read by each worker); no single PyTorch call computes these
   functions, so there is no library time.
5. The training main path: ``apps.cifar_app.main`` in process on
   synthesized CIFAR (5,000 train / 1,000 test), cifar10_full, 4
   workers, tau 10, batch 100, in three legs — no compression,
   ``--compress int8`` and ``--compress bf16 --overlap_avg``.  Launch
   counts are reset before each leg and read after it, and must match
   the chunk arithmetic (3 chunks: 3 K9 + 3 K10 per int8 round; 3 K9 per
   overlapped round and 3 K11 per round landed, the last at finalize).
   Each compressed leg's final smoothed loss is held within the JAX
   package's LOSS_BAND (0.08) of the uncompressed leg's, each leg's
   first round against the same round on the CPU, and one int8 round is
   profiled (device busy share, top kernels, K9-K11's share).

6. The flash backward kernels — K3 (dq) and K4 (dk/dv) — against their
   plain versions on the card, in float32, with a nonzero ``dlse``: the
   training shape (B=8, T=256, H=4, D=64, causal), non-causal, a ragged
   T_q, offsets (0, 64) with fully-masked rows, D=16, 32, 48, 128 and 256
   (causal and not), D=40 and 200 padded, q and k
   scaled by 8 at the training shape (held to a float64 evaluation of the
   same formulas, within 2e-5 of the scale or the float32 plain version's
   own gap from it, whichever is larger),
   and q, k, v as strided views of one fused qkv tensor.  Then each
   kernel's time beside its plain version's and the least time the card
   could take (its three TF32 passes, and the float32 bound of the same
   work), and, for K3 and K4 together, the library yardstick
   ``scaled_dot_product_attention`` forward+backward minus its forward.
   K1, K3 and K4 are also timed at head dim 256 (B=8, T=256, H=2),
   beside ``scaled_dot_product_attention`` there (or its refusal).
7. The LM training main path: ``apps.lm_app.main`` in process at the
   CLI's model width (dim 256, depth 4, heads 4, seq_len 256), W=2,
   tau 4, batch 8, 6 rounds, in two legs — the default (flash: K1, K3,
   K4) and ``--dense_attention``.  Launch counts are reset before each
   leg and read after it: the flash leg launches exactly depth x W x
   tau x rounds = 192 each of K1, K3 and K4, the dense leg none.  Both
   legs' losses are finite and fall from ~ln 256; the flash leg's
   per-round losses and final params lie within LM_TOL (5e-4) of the
   dense leg's; its first round on the card matches the same round on
   the CPU relative to the update; one flash round is profiled.  Then
   one round of ``lm_app --dim 512 --heads 2 --depth 2`` (head dim 256)
   on the kernels: depth x W x tau launches each, the kernel-path gauge
   1, finite losses.

8. The LRN kernels — K5 (forward) and K6 (backward) — and the fused
   LRN + 3x3/2 max pool — K7 and K8 — against their plain versions on
   the card: AlexNet's two LRN inputs at the training batch, (32, 96,
   55, 55) and (32, 256, 27, 27), and GoogLeNet's (phase 12), (32, 64,
   57, 57) and (32, 192, 57, 57), each also at the test batch 16 and
   tied (K5/K6), ragged and small shapes, C < n, n = 3 and 4 and a beta
   on the powf path (K5/K6; K5 also at AlexNet's inputs with n = 3 and
   beta 0.6); AlexNet's two sandwiches and GoogLeNet's conv2/norm2 ->
   pool2 (57x57, odd), the JAX tests' shapes and a tie case (K7/K8,
   whose routing must equal the plain version's bit for bit, and K8's
   dx too); forward rtol 2e-5 / atol 2e-6, backward 5e-5 / 5e-6, and K5
   everywhere, K6-K8 at both nets' inputs bit for bit.  Then each kernel's time per training step (both
   sandwiches, and each sandwich alone with its bound) beside its plain
   version's, the least time the card could take and a library
   yardstick the port never calls (``F.local_response_norm``, then
   ``F.max_pool2d`` for K7/K8; backward: forward+backward minus
   forward).
9. The ImageNet training main path: ``apps.imagenet_app`` at AlexNet's
   full width (60,965,224 parameters, crop 227 from 256), W=2, tau 4,
   batch 32 (test 16), 4 rounds testing every 2, mirror and dropout on,
   through the app's ``train`` on seeded uint8 partitions made with
   numpy, in six legs: the default (K5/K6) twice, ``SPARKNET_FUSION=1``
   (K7/K8 in training, K5 in the test net), ``--compress int8`` for
   2 rounds (K9 + K10 once per comm chunk a round, 3 chunks), and
   ``--overlap_avg`` with an fp32 and with a bf16 payload (``--compress
   bf16``) for 2 rounds each (K9 once per chunk a round, K11 once per
   chunk for each round's average, the last at finalize, no K10); each
   compressed leg's smoothed losses within LOSS_BAND of those of the
   fp32 leg of its averaging schedule (int8: the default leg; bf16: the
   fp32 overlap leg) at the same rounds, and every comm leg's gap to the
   default leg printed.  Launch counts are reset
   before each leg and held to the arithmetic; losses finite, the first
   ~ln 1000, the last round's below the first's; the fused leg's
   per-round losses within 1e-4 (relative) of the default leg's in round
   0 and within 2e-3 in every round (a second run of the default leg
   shows how far two runs of one program drift apart); the default leg's
   first round on the card against the same round on the CPU, after one
   local step and after two (``IMNET_CPU_STEPS``), and both against the
   same round on the CPU in float64; one round of the default, fused,
   int8 and bf16+overlap legs profiled (the comm rounds with K9-K11's
   shares).  Where Pillow imports, ``imagenet_app.main`` also runs on
   synthesized JPEG shards at a small size, driving the data stage.

10. Weights and snapshots.  ``apps.lm_app`` at the serving width (W=2,
   tau 4, batch 8, lr 0.01), in two legs — no compression and
   ``--compress int8`` — each run 4 rounds straight through with
   ``--snapshot_every 2``, then 2 rounds and a ``--resume`` run to round
   4: the final params, the momentum stacks, the comm residuals and
   every smoothed loss equal bit for bit, and the resumed run launches
   K1, K3 and K4 (and K9/K10 once per comm chunk a round in the int8
   leg; counts reset just before it and read just after).  The
   uninterrupted leg's last snapshot, restored by a CPU solver, equals
   the card's worker-0 state bit for bit.  ``cli serve --generate
   --weights`` on that snapshot's ``.caffemodel``: phase 3's 4 streams
   and checks against a CPU engine loaded from the same file, K1 and K2
   launched, the tokens unlike the seeded engine's.  ``cli train
   --solver`` on cifar10_full (batch 100, tau 10) and synthesized CIFAR
   binaries: 40 iterations straight through vs 20 and ``--resume``,
   bit-identical.  Then one LM round and one ``cli train`` window with
   deterministic algorithms on and off (toggled here through
   ``utils.devices.deterministic_algorithms``, the block the apps train
   in), once each, warm: wall and device-busy time (after phase 11,
   with its CaffeNet round).  The phases before 10 run with torch's default
   settings: each app call puts them back on its way out.

11. The two-phase ImageNet DB path.  Where Pillow imports,
   ``imagenet_create_db_app.main`` on synthesized JPEG shards; then the
   files it writes, through its ``write_dbs``, from seeded uint8 arrays:
   W=2, full size 256, 1,000 classes (2-byte labels), 10 train batches
   of 32 a worker (4 rounds read 16: the shards wrap), val shards of 2
   and 1 batches of 16 (padded and masked).  ``imagenet_run_db_app``
   with CaffeNet at full width (crop 227), tau 4, testing every 2
   rounds, mirror and dropout on, warm-started from a seeded CaffeNet's
   ``.caffemodel``, in two resume pairs — no compression and ``--compress
   int8`` — each 4 rounds straight through with ``--snapshot_every 2``
   vs 2 rounds and a ``--resume`` run to round 4: final params, momentum
   stacks, the int8 residuals, every loss and the final accuracy equal
   bit for bit; the resumed runs launch K5 and K6 (and K9/K10 once per
   comm chunk a round) in the counts the arithmetic gives.  The last
   snapshot, restored by a CPU solver, equals the card's worker-0 state
   bit for bit.  ``cli test`` with the zoo AlexNet prototxt, that
   snapshot's ``.caffemodel`` and an LMDB of 100 records at 227 written
   by the port: scores within 1e-4 of ``--device cpu``, K5 launched.
   Then the readers' records/s (native, Python) over one round's records
   beside what a round consumes, and one CaffeNet DB round profiled.

12. The deep nets on the main loop: ``apps.imagenet_app``'s ``train``
   at full width — GoogLeNet (Inception-v1 with its two aux heads at
   loss weight 0.3) and ResNet-50, 1,000 classes, crop 227 from 256,
   mirror and dropout on, their zoo solvers (poly; multistep), W=2, tau
   4, batch 32 (test 16), 3 rounds testing at rounds 0 and 2, phase 9's
   seeded partitions, ResNet-50 at lr 0.002 (its recipe's 0.1 is for
   batch 256; see DEEP_LR), the first eight legs under
   ``deterministic_algorithms()``: GoogLeNet default (9
   hconv groups; K5/K6 for both LRNs), ``SPARKNET_FUSION=1``
   (conv2/norm2 -> pool2 at 57x57 runs K7/K8, norm1 K5/K6) and
   ``SPARKNET_HFUSE=0`` (1 round: its round-0 loss within 1e-4 of the
   default's); ResNet-50 default twice (the runs equal bit for bit),
   ``--compress int8`` (K9 + K10 once a leaf group of each of the 4
   chunks a round) and ``--overlap_avg`` with an fp32 and a bf16 payload
   (2 rounds each: K9 and K11); then ResNet-50's default and int8 legs
   under the app's own settings (torch's defaults), their gap printed.
   Launch counts reset before each leg and held to the arithmetic;
   losses finite and falling; GoogLeNet's first loss within 15% of its
   value at init on the CPU; the fused leg's round-0 loss within 1e-4 of
   the default's; each deterministic compressed leg within LOSS_BAND of
   its fp32 schedule's leg; the averaged BatchNorm stats equal on every
   worker and equal to the workers' mean; the first local step of each
   net on the card against the CPU at batch 8 (losses within 1e-5):
   GoogLeNet in float32 within 1% of the update, ResNet-50 in float64
   within 1e-6 (in float32 its BatchNorm puts the CPU's run as far from
   float64 as the card's); GoogLeNet's round profiled with hconv on and off, and
   ResNet-50's default and int8 rounds (wall, device busy share,
   launches, peak memory, top kernels, K5-K11's share).

13. Image serving: ``cli serve`` in process (``ServeServer`` on a
   loopback port) on CaffeNet at full width (the zoo's ``caffenet``
   taken to its deploy view, 1,000 classes, 3x227x227, buckets 1, 4, 16
   and 64), seeded weights written with ``io/caffemodel.save_weights``.
   First K5 in bfloat16 against its plain version (float32 math on the
   widened input, one round-to-nearest-even narrowing) at CaffeNet's two
   LRN inputs at the top bucket, (64, 96, 55, 55) and (64, 256, 27, 27),
   random and tied, and an odd shape: bit-equal, as float32 there; timed
   beside the plain version and ``F.local_response_norm`` in bf16.  Then
   ``--replicas 2 --watch DIR``: 16 concurrent clients ``POST
   /predict`` bodies of 1, 3, 16 and 64 images (launch counts reset just
   before, read just after): every prob within 1e-4 of a CPU
   ``InferenceEngine`` on the same weights and each row within 1e-4 of
   its top prob, each replica's shape count 4, K5 launched twice per
   forward; images/s and p50/p99 latency; one forward per bucket
   profiled.  Delivery on that fleet, under mirrored live traffic: a
   seeded solver's state published with a passing verdict is canaried
   and promoted to both replicas (each then equal bit for bit to a
   fresh engine on the published file, under
   ``deterministic_algorithms()``, forwards outside the counted legs);
   a publish with fc8 x 50 rolls back and is quarantined; a snapshot
   with no verdict is rejected; K5 launched twice per forward of every
   engine (served, mirrored, warmed).  ``--queue 2``: a third client
   gets 429 with Retry-After, K5 twice per forward.  ``--dtype
   bfloat16``: the 64 images in one request, top-1 equal to the fp32
   engine's on every row whose top-2 margin exceeds 5% of the top prob,
   max |prob difference| printed and, against the row's top prob, over
   the fp32 limit (the limit tells the dtypes apart), K5 (bf16) twice
   per forward.  ``serve --generate --replicas 2`` at the CLI model:
   phase 3's 4 prompts stream phase 3's tokens, K1 and K2 launched.

14. Training health and crash-consistent recovery (about 100 s; the
   kill-anywhere sweep of ``runtime.recover`` runs in phase 16, through
   ``chaos.run_kill_sweep``).  Full-width resume:
   ``imagenet_run_db_app`` (CaffeNet, phase 11's DB, W=2, tau 4, batch
   32, int8, ``--journal --health warn --snapshot_every 2``, 4 rounds)
   as a subprocess, SIGKILLed once the ledger (scanned with the port's
   ``journal.scan``) holds round 2's intent, then resumed: its final
   snapshot equals the uninterrupted in-process run's bit for bit
   (params, every worker's momentum, residuals), and that run with
   ``--health`` equals it without; the audit's cost a round (device ms
   and launches of one iteration's audit at CaffeNet's size, times W x
   tau, and the rounds' wall) and a commit's fsync wall.  The in-round
   mask at the serving width (the LM of phase 7, int8): worker 1's
   round-1 window poisoned with NaN (a float ``poison`` factor on its
   loss) equals the same round with ``live_mask=[1, 0]`` and worker 1's
   history zeroed, bit for bit; K10's rejoin branch leaves its residual
   zero; the sentry's verdict names worker 1 and ``warn`` continues;
   every worker poisoned under ``rollback`` restores the newest
   snapshot and the next round trains; ``halt`` raises ``SentryHalt``
   and leaves a flight bundle ``load_bundle`` reads; under ``bf16
   --overlap_avg`` the masked round takes K10 and leaves nothing for
   K11.  Elastic over slices: ``cifar_app`` (cifar10_full, W=4, tau
   10, batch 100, ``--slices 2 --cross_slice_every 2 --compress int8
   --elastic --rejoin_after 2``, 8 rounds) with a SIGTERM in round 1:
   slice 1 leaves, dies (K10's ``alive`` [1, 1, 0, 0] in the cross round
   while it is dead) and is readmitted; intra rounds launch no comm
   kernel, cross rounds K9 + K10 by the arithmetic; the final smoothed
   loss within LOSS_BAND of phase 5's uncompressed leg.  ``cli train
   --solver`` (cifar10_full) ``--health warn --publish_to DIR``: the
   publish carries its CRC manifest and a passing verdict, and the
   port's delivery reader stages it.

15. The training data plane (about 120 s).  One
   ``http.server.ThreadingHTTPServer`` on loopback serves phase 11's
   temporary directory, counting bytes and requests by path
   (``HTTPStore`` lists its autoindex hrefs).  (a) ``imagenet_run_db_app``
   with CaffeNet at full width on phase 11's DB, warm-started from its
   seeded ``.caffemodel``, W=2, tau 4, batch 32, 4 rounds, ``--seed 1
   --shuffle_epochs 2`` (seed 1 deals the two train DBs [0, 1] then [1,
   0]; both tables printed): from ``--db_dir http://...`` with a fresh
   ``--cache_dir``, again over the now-warm cache, and from the local
   directory, equal bit for bit (params, momentum stacks, every smoothed
   loss and loss, the accuracies); the cold run fetches the DB's bytes
   once, the warm run none (``cache_bytes{src="miss"}`` 0, hits > 0);
   K5/K6 by the arithmetic.  Then ``--compress int8 --snapshot_every 2``
   over the warm cache, 4 rounds straight through against the round-2
   snapshot alone ``--resume``d to round 4 across the epoch boundary:
   bit-identical, residuals included, K9/K10 once per chunk a round.
   (b) ``lm_app`` at the serving width, W=2, tau 4, batch 8, 4 rounds,
   ``--corpus http://.../corpus --cache_dir`` against the same corpus
   from ``file://``: bit for bit, K1/K3/K4 depth x W x tau x rounds
   launches each.  (c) ``cli train --solver`` cifar10_full (batch 100,
   tau 10, 60 iterations) on phase 10's CIFAR binaries from
   ``--data http://... --cache_dir --shuffle_epochs 2`` against the local
   directory: bit for bit.  (d) A ``RoundFeed`` on the card whose
   ``assemble`` blocks once, in round 1, 2 s past ``stall_timeout_s=1``:
   ``PrefetchStall``, ``feed_stalls`` 1, and after ``restart(1)`` rounds
   0-3 equal an unstalled feed's bit for bit.  (e) ``featurizer_app
   --model caffenet --blob fc7`` on phase 11's seeded weights and its
   val LMDB (records at 227), card against ``--device cpu`` within 1e-4
   of the largest feature, K5 twice a batch; where h5py imports, its
   ``.h5`` output and ``cli train --solver`` on a cifar10_full-shaped net
   whose data layers are ``HDF5Data`` and that taps ``ip1`` through
   ``HDF5Output`` (2 windows), the tap's file within 1e-4 of a CPU run
   (h5py is printed yes/no; no skips only these).  (f) Where Pillow
   imports: ``imagenet_app`` over HTTP JPEG shards with ``--cache_dir
   --shuffle_epochs 2`` at phase 9's small size against the local
   shards, both under ``deterministic_algorithms()``: bit for bit; an
   ``ImageData`` and a ``WindowData`` net (each with an ACROSS LRN)
   through the featurizer, card against CPU, K5 once a batch.  Launch
   counts are reset before each leg and read after it.

16. Bounded staleness, the round profiler, ``cli time`` and the chaos
   harness (about 150 s), in phase 11's temporary directory.  (a) The
   stale trainer at CaffeNet's full width (60,965,224 parameters, crop
   227, 1,000 classes, phase 11's seeded weights), W=4, tau 4, batch 32,
   4 boundaries on seeded batches made on the card, under
   ``deterministic_algorithms()``: ``stale_bound=0`` equals
   ``ParameterAveragingTrainer`` bit for bit (params, stats, history,
   iter, every loss); then ``stale_bound=2``, discount 0.5, worker 3
   never arriving by itself and worker 1 missing boundary 1, flat and
   two-tier (2 slices of 2, cross every 2nd round): at each boundary the
   lags, the forced set, the weights and the ledger equal the JAX rules
   restated on host integers, an absent worker's replica is bit-unchanged,
   and each arrived worker's params lie within 1e-6 (of the largest
   magnitude) of a float64 weighted mean of its group's arrived
   post-window replicas; K5 and K6 launch 2 x tau x the windows run (an
   absent worker's window is not run).  (b) ``imagenet_run_db_app
   --stale_bound 2 --journal`` (phase 11's DB, 4 rounds) within 1e-5 of
   the ``--stale_bound 0`` run, its journal carrying ``worker_rounds``
   on every record.  (c) ``chaos.run_kill_sweep`` on the card: recover
   processes (cifar10_quick, W=2, tau 2, batch 8, int8, the audit on),
   all at once, SIGKILLed at each synchronous point of round 2 and
   resumed, the ``--no_journal`` and journal-off controls, and the
   ``--stale_bound 2`` leg SIGKILLed at ``stale_boundary:2``; each resumes
   to its control's digest, which equals an in-process control whose
   K9/K10 launches match the chunk arithmetic.  (d) ``imagenet_run_db_app
   --compress int8 --profile --profile_out`` (W=2, tau 4, batch 32, 4
   rounds): the phases assemble, h2d, execute, quantize, allreduce,
   dequantize and average, the h2d hidden fraction, per-worker execute ms
   from CUDA events, achieved FLOP/s (``utils/flops.train_flops``) and
   MFU against 67 TFLOP/s; a run whose round-2 assembly of worker 1
   sleeps 0.4 s under ``worker_timer``, named by the straggler verdict at
   round 2 and no other; ``imagenet_app --model alexnet --compress bf16
   --overlap_avg --profile`` (3 rounds): the comm hidden fraction, K11 3
   a round.  (e) ``cli time --model caffenet --iterations 10 --batch
   32``: the whole table, K5 and K6 launched.  (f) ``chaos.run_chaos``
   on the card with the default plan (``collector_outage`` too: 0
   events lost or dropped): every injected fault survived, the NaN flagged at round 2, the straggler
   named at worker 3, round 1, the final loss in the baseline's band,
   the decode replica kill's resumed tokens equal to the undisturbed
   run's (K1, K2), the corrupt publish never canaried, the recovery
   latency printed.

17. bf16 training through the Solver (about 60 s, the kernels' part with
   phase 8's checks, the rest in phase 11's temporary directory).  (a)
   K6, K7 and K8 in bfloat16 against their plain versions (the float32
   ones on the widened inputs, narrowed once), bit for bit, at AlexNet's
   two LRN inputs (batch 32, random and tied) and an odd shape, and K5
   and K6 so at CaffeNet's two at batch 256, where (b) runs them; each
   timed over both sandwiches beside its plain version, the PyTorch call
   for the same function in bf16 (the autograd backward of
   ``F.local_response_norm``, alone and with ``F.max_pool2d``; never
   called by the port) and the float32 kernel, its bound at 2-byte I/O.
   (b) ``bench.py``'s training protocol: CaffeNet at full width (1,000
   classes, crop 227, batch 256), ``Solver(compute_dtype="bfloat16")``
   and float32, ``step_repeat`` tau 20 on one seeded batch: images/s,
   device time and busy share (``torch.profiler`` over a window of 5
   iterations), peak memory; masters
   and history float32; K5 and K6 launch 40 times in bf16 (none in
   float32), 40 in float32 in the float32 window; the first iteration's
   loss within 2e-2 of float32's.  (c) AlexNet under ``SPARKNET_FUSION=1``
   through the averaging trainer (W=2, tau 4, batch 32, 3 rounds on
   seeded batches made on the card), bf16 and float32: K7 and K8 48
   launches each in the dtype of the leg, the bf16 smoothed losses
   within ``LOSS_BAND`` of float32's; then one more round of each leg
   under ``torch.profiler`` (wall, device busy, K7 and K8).  (d) The JAX
   slow test's
   evidence (cifar10_full, batch 25, 200 iterations, tau 20) held to its
   asserts; the tails' gap printed beside its docstring's 5%.  (e)
   ``imagenet_run_db_app --model googlenet --profile`` on phase 11's DB
   (W=2, tau 4, 2 rounds): finite losses, K5 44 and K6 32 launches, each
   worker's window's device time.  (f) ``debug_info_pass`` on one
   cifar10_quick window on the card and the CPU from one init: the same
   57 lines, values within 1e-3.
18. The sequence ring and SparkNet's loop across processes.  (a)
   ``ring_self_attention`` over a stacked sp=4 ring (B=2, T=4096, H=4,
   D=64) and an sp=2 ring at head dim 256 (T=1024, H=2), causal and
   not, forward and q/k/v gradients: sp^2 launches each of K1, K3 and
   K4 at absolute offsets, held to the same ring on the plain versions
   (``KERNEL_ATOL`` or 2e-5 of the largest magnitude) and to sp=1
   ``flash_attention`` (``LM_TOL``); K3's ``dlse`` nonzero; the causal
   ring's fully masked (shard, step) pairs printed; the ring's time
   beside sp=1's, and each one's device-busy share and K1/K3/K4 time
   under ``torch.profiler``.  (b) ``lm_app --sp 2`` at the CLI width (W=2, tau 4,
   batch 8, 2 rounds): depth x W x tau x rounds x sp^2 = 256 launches
   each of K1, K3 and K4, losses and params within ``LM_TOL`` of the
   sp=1 leg.  (c) A two-layer ``Attention`` net (E=256, causal): its
   gradients on the card within 1e-4 of the CPU's.  (d) Two ranks on
   the one card joined over gloo (asked for explicitly), one
   cifar10_full worker a rank (tau 10, batch 100, 2 rounds,
   deterministic), default and ``--compress int8``: bit for bit the
   one-process W=2 run, K9/K10 by the chunk arithmetic in each rank,
   the bytes that crossed the group and the host-staging ms printed.
   (e) ``tools/launch.py --nprocs 2 --backend gloo cifar`` on the card:
   only rank 0 logs, smoothed losses within ``LOSS_BAND`` of one
   process's.  (f) (d)'s rounds with the dp group over NCCL at world
   size 1: the bits of the run with no group.
19. Caffe's all-reduce data parallelism and the LM's dp x sp mesh
   across processes, two ranks sharing the card over gloo
   (``allreduce_end_to_end``): ``cli train --devices 2`` on CaffeNet, a
   ResNet-50 step under ``AllReduceTrainer``, ``lm_app --sp 2`` as two
   ranks, a resume, and NCCL at world size 1.
20. SparkNet's failure and straggler machinery across processes
   (``averaging_machinery_across_processes``): cifar10_full W=4 as two
   ranks on the card over gloo (two workers a rank, tau 10, batch 100,
   3 rounds, deterministic), each leg bit for bit the one-process
   stacked run of the same W (rows, losses, live masks, view epochs,
   rosters, tiers): (a) ``--compress int8 --slices 2
   --cross_slice_every 2`` (0 B reach a rank on the intra rounds, the
   other rank's int8 rows on the cross round; K9/K10 3 a rank), (b)
   ``--elastic --rejoin_after 1 --compress int8`` with a SIGTERM that
   rank 1 alone sends itself at round 1 (epochs 0, 1, 2, 4 on both
   ranks; K9/K10 12 a rank), (c) ``--stale_bound 2``, (d) ``--journal
   --profile --profile_out`` (rank 0's ledger equals the stacked run's,
   rank 1 keeps none; a W-row worker table, written by rank 0); (e)
   ``tools/launch.py --nprocs 2 --slices 2 --preempt_slice 1
   --preempt_at --relaunch_after cifar --elastic``: the lifecycle lines,
   the notice agreed (the leave in rank 0's log), rank 1 killed and
   relaunched, rank 0 stopping with ``mesh.PeerLost`` naming rank 1, no
   hang until the launcher's deadline; (f) the real entry point,
   ``tools/launch.py --nprocs 2 --devices_per_host 2 cifar --slices 2
   --cross_slice_every 2 --compress int8 --elastic`` (2 rounds),
   observed (``utils/procs.observed_launch``): every rank's rows, losses,
   masks, smoothed loss and accuracy bit for bit a one-process
   ``cifar_app --workers 4`` run of the same flags.  (e) and (f) run
   beside (a)-(d), so (a)-(d)'s round walls come from a shared card.
   (a)-(d)'s and (f)'s K9/K10 launches join the kernels line.
21. The run's telemetry plane (``telemetry_end_to_end``): (a)
   ``cifar_app --compress int8`` at cifar10_full's width (W=4, tau 10,
   batch 100, 3 rounds) with ``--obs --obs_port 0 --slo --trace_out
   --fleet_collector 127.0.0.1:0 --profile``: ``/metrics``,
   ``/healthz``, ``/query``, ``/slo`` and ``/signals`` scraped while the
   run is alive, every round's phase spans in the trace (each span's
   count its ``sparknet_phase_latency_seconds`` count), the collector's
   ``/fleet`` with 1 live host at the last round, no event dropped, 3 K9
   and 3 K10 launches a round, and the losses and final parameters bit
   for bit the same run's without telemetry; (b) ``tools/launch.py
   --nprocs 2 --devices_per_host 2 --fleet_collector 127.0.0.1:0 cifar
   --compress int8``, two gloo ranks on ``cuda:0``: 2 hosts, 0 late, 0
   dead, the merged ``sparknet_rounds_total`` the hosts' sum; (c) ``cli
   serve --generate --obs --obs_port 0 --slo`` at its default LM width,
   16 streams: ``/slo``'s ``serve-ttft-p99`` counts good + bad = 16,
   ``/signals`` answers, K1 and K2 launch.  Each leg's round or stream
   wall with and without telemetry and a scrape's latency print (host
   clock, reported only).  (a)'s K9/K10 and (c)'s K1/K2 launches join
   the kernels line.

Before its last lines the script prints its wall seconds by function
(callees included), for a slice that must cut depth to stay inside the
time limit.  A failed run prints cuDNN's error log
(kept in the temporary directory) and the tensors of the port's
innermost frame on the failing stack.  The second-to-last line is
``{"kernels": [...]}`` (K1-K11, K5 in bf16 and K6-K8 in bf16, with
launches summed over every phase's main-path runs; bf16 launches are
counted apart from float32 ones); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import http.client
import inspect
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# cuBLAS reads its workspace setting when it first runs: the setting
# under which it repeats itself bit for bit, before anything touches CUDA
# (lm_app and cli train run deterministic algorithms, which need it)
if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in (":4096:8", ":16:8"):
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
# cuDNN's error log (errors only; CUDNN_LOGLEVEL_DBG for cuDNN 9,
# CUDNN_LOGERR_DBG for 8), read back if the run fails: one fresh process
# once failed its first convolution ("GET was unable to find an
# engine"), cause unknown (ROADMAP.md §C), and this is what to keep
# when it recurs
CUDNN_ERROR_LOG = os.environ.get("CUDNN_LOGDEST_DBG")
if CUDNN_ERROR_LOG is None:
    CUDNN_ERROR_LOG = os.path.join(
        tempfile.gettempdir(), f"chip_smoke_cudnn_{os.getpid()}.log")
    os.environ.update(CUDNN_LOGLEVEL_DBG="1", CUDNN_LOGERR_DBG="1",
                      CUDNN_LOGDEST_DBG=CUDNN_ERROR_LOG)

import torch  # noqa: E402

# float32 on both sides; the kernels sum tile by tile (online softmax)
# where the plain versions sum densely, so results agree to rounding
KERNEL_ATOL = 2e-5
# streamed logprobs vs the CPU model's teacher-forced scores: float32
# through 4 layers, summed in another order on another device
LOGPROB_ATOL = 1e-4
# a token may differ from the CPU argmax only where the CPU's top-2
# logits are this close (seeded random weights give near-ties)
TIE_MARGIN = 1e-4
# the flash backward against its plain version: 2e-5 of the largest
# magnitude of the plain output (float32 sums of up to T products, in
# another order)
BWD_RTOL = 2e-5

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, float32
# operations/s outside the tensor cores (every kernel but K1/K3/K4 runs
# fp32 FMA), TF32 operations/s on the tensor cores (K1/K3/K4 run each
# product as three TF32 products)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12

CLI_MODEL = dict(dim=256, depth=4, heads=4, seq_len=256)
CLI_SERVE = dict(
    prefill_buckets=(16, 32, 64, 128), max_streams=8, kv_blocks=64,
    kv_block_size=16,
)
PROMPT_LENS = (5, 23, 50, 100)
MAX_NEW = 32
# the decode kernel's slots: ragged, a block edge either side, full S
DECODE_LENGTHS = [1, 17, 256, 100, 200, 64, 128, 255]
# the decode step's launches (profiler rows, memcopies included) when
# it still gathered each step's context out of the arena: 190 of 25
# kinds at the CLI's default model; the paged step launches no more
GATHERED_STEP_LAUNCHES = 190


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int = 50, warm: int = 5) -> float:
    """Mean device time of one call, CUDA events around ``iters``
    back-to-back calls after ``warm`` untimed ones."""
    for _ in range(warm):
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


def device_ms(fn, n: int = 20):
    """Device time of one call without the host's launch cost: ``n``
    calls captured in one CUDA graph, the graph replayed between CUDA
    events, divided by ``n``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return time_ms(graph.replay, iters=10, warm=2) / n


def bound_ms(nbytes: float, ops: float, peak_ops_s: float = PEAK_FP32_S):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def paged_decode_case(dev, gen, h, d):
    """``(q, arena_k, arena_v, block_table)`` at the serving geometry: 8
    slots, the CLI's 64 KV blocks of 16 and the trash block 0, each
    row ``arena_head_dim(d)`` wide (pad columns zero).  Each slot holds
    the blocks its ``DECODE_LENGTHS`` entry needs, drawn shuffled from
    the free list, and the trash block past them; the lengths need 67
    blocks, so slots draw independently (the arena is only read)."""
    from sparknet_tpu_torch.ops import cuda_attention as ca

    bs, nblocks = CLI_SERVE["kv_block_size"], CLI_SERVE["kv_blocks"]
    b, width = CLI_SERVE["max_streams"], CLI_MODEL["seq_len"] // bs
    dp = ca.arena_head_dim(d)
    arenas = []
    for _ in range(2):
        a = torch.zeros(((nblocks + 1) * bs, h, dp))
        a[..., :d] = torch.randn(((nblocks + 1) * bs, h, d), generator=gen)
        arenas.append(a.to(dev))
    table = torch.zeros((b, width), dtype=torch.int32)
    for i, n in enumerate(DECODE_LENGTHS):
        drawn = torch.randperm(nblocks, generator=gen)[: -(-n // bs)] + 1
        table[i, : drawn.numel()] = drawn
    q = torch.randn((b, 1, h, d), generator=gen)
    return q.to(dev), arenas[0], arenas[1], table.to(dev)


def max_err(got, want) -> float:
    """Max |got - want| over entries finite in ``want``; infinities must
    match exactly (the (0, -inf) rule of masked rows)."""
    inf = torch.isinf(want)
    check(bool(torch.equal(torch.isinf(got), inf)), "infinities differ")
    check(bool(torch.equal(got[inf], want[inf])), "infinity signs differ")
    check(not bool(torch.isnan(got).any()), "NaN in kernel output")
    if bool(inf.all()):
        return 0.0
    return float((got[~inf] - want[~inf]).abs().max())


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------
def check_kernels(dev):
    """Hold each kernel against its plain version; return the per-kernel
    records (without launch counts) for the kernels line."""
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops import cuda_attention as ca

    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    B, H, D = 1, 4, 64
    flash_err = 0.0
    cases = [(t, t, False) for t in (16, 32, 64, 128, 256)]
    cases += [(t, t, True) for t in (16, 32, 64, 128, 256)]
    cases += [(37, 37, True), (37, 128, True), (37, 128, False)]
    for tq, tk, causal in cases:
        q, k, v = rand(B, tq, H, D), rand(B, tk, H, D), rand(B, tk, H, D)
        o, lse = ca._flash_core(q, k, v, tk - tq, 0, causal)
        o_ref, lse_ref = ca._flash_core_reference(q, k, v, tk - tq, 0, causal)
        e = max(max_err(o, o_ref), max_err(lse, lse_ref))
        print(f"K1 flash_fwd tq={tq} tk={tk} causal={causal}: "
              f"max_abs_err {e:.3e}")
        check(e <= KERNEL_ATOL, f"flash_fwd disagrees at {tq}x{tk}: {e}")
        flash_err = max(flash_err, e)
    # the LM training shape, q, k and v apart and as views of one fused
    # qkv tensor; D = 16, 32, 48, 128 and 256 (its output's columns in
    # halves), and D = 40 and 200, which the autograd path (the LM's)
    # zero-pads to the D = 48 and 224 builds (PAD_COPIES)
    LB, LT = LM_BATCH, LM_MODEL["seq_len"]
    for what, (q, k, v) in (
            ("LM shape", (rand(LB, LT, H, D) for _ in range(3))),
            ("LM shape, fused-qkv views", rand(LB, LT, 3, H, D).unbind(2)),
            ("D=16", (rand(2, 70, H, 16) for _ in range(3))),
            ("D=32", (rand(2, 70, H, 32) for _ in range(3))),
            ("D=48", (rand(2, 100, H, 48) for _ in range(3))),
            ("D=128", (rand(2, 100, H, 128) for _ in range(3))),
            ("D=256", (rand(2, 100, H, 256) for _ in range(3))),
            ("D=40, padded to 48", (rand(2, 100, H, 40) for _ in range(3))),
            ("D=200, padded to 224", (rand(2, 100, H, 200) for _ in range(3)))):
        ca.reset_launch_counts()
        o, lse = ca._FlashCore.apply(q, k, v, 0, 0, True)
        padded = q.shape[-1] not in ca.KERNEL_HEAD_DIMS
        check(ca.LAUNCHES["flash_fwd"] == 1
              and ca.PAD_COPIES == (3 if padded else 0),
              f"flash_fwd {what}: launches {ca.LAUNCHES}, pad copies "
              f"{ca.PAD_COPIES}")
        o_ref, lse_ref = ca._flash_core_reference(q, k, v, 0, 0, True)
        e = max(max_err(o, o_ref), max_err(lse, lse_ref))
        print(f"K1 flash_fwd {what} {tuple(q.shape)} causal: max_abs_err {e:.3e}")
        check(e <= KERNEL_ATOL, f"flash_fwd disagrees ({what}): {e}")
        flash_err = max(flash_err, e)
        if what == "LM shape":  # the split partials' merge order is fixed
            again = ca._flash_core(q, k, v, 0, 0, True)
            check(torch.equal(again[0], o) and torch.equal(again[1], lse),
                  "flash_fwd: two launches on the same inputs differ")
    # absolute offsets: keys start at 64, so query rows 0..63 see nothing
    q, k, v = rand(B, 128, H, D), rand(B, 128, H, D), rand(B, 128, H, D)
    o, lse = ca._flash_core(q, k, v, 0, 64, True)
    o_ref, lse_ref = ca._flash_core_reference(q, k, v, 0, 64, True)
    check(bool((o[:, :64] == 0).all()), "masked rows must give o = 0")
    e = max(max_err(o, o_ref), max_err(lse, lse_ref))
    print(f"K1 flash_fwd offsets (0, 64), 64 fully-masked rows: "
          f"max_abs_err {e:.3e}")
    check(e <= KERNEL_ATOL, f"flash_fwd disagrees with offsets: {e}")
    flash_err = max(flash_err, e)

    # decode attention (K2) on a paged arena at the serving geometry, at
    # D = 64, 16, 48, 256 and 40 (the arena 48 wide, pad columns zero);
    # two launches give the same bits, and no launch copies anything
    Bd, S = CLI_SERVE["max_streams"], CLI_MODEL["seq_len"]
    bs = CLI_SERVE["kv_block_size"]
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    dec_err = 0.0
    paged = {}
    for d in (D, 16, 48, 256, 40):
        case = paged_decode_case(dev, gen, H, d)
        ca.reset_launch_counts()
        o = ca.paged_decode_attention(*case, lengths, bs)
        again = ca.paged_decode_attention(*case, lengths, bs)
        check(ca.LAUNCHES["decode_attention"] == 2 and ca.PAD_COPIES == 0
              and ca.ALIGN_COPIES == 0,
              f"paged decode D={d}: launches {ca.LAUNCHES}, pad copies "
              f"{ca.PAD_COPIES}, align copies {ca.ALIGN_COPIES}")
        check(torch.equal(again, o),
              f"paged decode D={d}: two launches on the same inputs differ")
        e = max_err(o, ca.paged_decode_attention_reference(*case, lengths, bs))
        print(f"K2 paged decode B={Bd} H={H} D={d} arena "
              f"{tuple(case[1].shape)} lengths {DECODE_LENGTHS}: max_abs_err "
              f"{e:.3e}, two launches bit-identical")
        check(e <= KERNEL_ATOL, f"paged decode disagrees at D={d}: {e}")
        dec_err = max(dec_err, e)
        paged[d] = case
    # length 0 gives o = 0; the other slots are unchanged by it
    some_empty = lengths.clone()
    some_empty[::2] = 0
    o = ca.paged_decode_attention(*paged[D], some_empty, bs)
    check(bool((o[::2] == 0).all()), "paged decode: length 0 must give o = 0")
    e = max_err(o, ca.paged_decode_attention_reference(*paged[D], some_empty,
                                                       bs))
    print(f"K2 paged decode, lengths {some_empty.tolist()}: o = 0 at length "
          f"0, max_abs_err {e:.3e}")
    check(e <= KERNEL_ATOL, f"paged decode disagrees with empty slots: {e}")
    dec_err = max(dec_err, e)
    # the gathered entry point: the same kernel, the identity table
    qd, kd, vd = rand(Bd, 1, H, D), rand(Bd, S, H, D), rand(Bd, S, H, D)
    od = ca.decode_attention(qd, kd, vd, lengths)
    e = max_err(od, ca.decode_attention_reference(qd, kd, vd, lengths))
    print(f"K2 decode_attention (gathered) B={Bd} S={S} lengths "
          f"{lengths.tolist()}: max_abs_err {e:.3e}")
    check(e <= KERNEL_ATOL, f"decode_attention disagrees: {e}")
    check(torch.equal(ca.decode_attention(qd, kd, vd, lengths), od),
          "decode_attention: two launches on the same inputs differ")
    dec_err = max(dec_err, e)
    for d in (16, 48, 256, 40):  # 40: zero-padded to the D = 48 build
        qs, ks, vs = rand(Bd, 1, H, d), rand(Bd, S, H, d), rand(Bd, S, H, d)
        e = max_err(ca.decode_attention(qs, ks, vs, lengths),
                    ca.decode_attention_reference(qs, ks, vs, lengths))
        print(f"K2 decode_attention (gathered) D={d}: max_abs_err {e:.3e}")
        check(e <= KERNEL_ATOL, f"decode_attention disagrees at D={d}: {e}")
        dec_err = max(dec_err, e)

    def timed(record, kernel, plain, library=None):
        """Per-call times of the kernel, its plain version and the
        library call: on the device (``ms``, ``plain_ms``,
        ``library_ms``: CUDA-graph replays, no host launch cost) and as
        a caller waits (``call_ms`` etc.: CUDA events around
        back-to-back calls, the host's launch cost included)."""
        for key, fn in (("", kernel), ("plain_", plain),
                        ("library_", library)):
            if fn is not None:
                record[key + "ms"] = device_ms(fn)
                record[key + "call_ms"] = time_ms(fn)
        return record

    # times at every prefill bucket and the scorer's T=256, causal
    for t in (16, 32, 64, 128, 256):
        q, k, v = rand(B, t, H, D), rand(B, t, H, D), rand(B, t, H, D)
        r = timed({}, lambda: ca.flash_attention(q, k, v, True),
                  lambda: ca.flash_attention_reference(q, k, v, True))
        print(f"K1 flash_fwd T={t} causal: kernel {r['ms']:.4f} ms on "
              f"device ({r['call_ms']:.4f} ms per call), plain "
              f"{r['plain_ms']:.4f} ms ({r['plain_call_ms']:.4f} ms)")
    T = CLI_SERVE["prefill_buckets"][-1]
    q, k, v = rand(B, T, H, D), rand(B, T, H, D), rand(B, T, H, D)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = B * H * T * (T + 1) // 2  # visible (query, key) pairs
    flash_bytes = 4 * (4 * B * T * H * D + B * H * T)  # q,k,v,o + lse
    # 2 products, 2 ops a MAC, each product three TF32 products
    fb, fby = bound_ms(flash_bytes, 3 * 4 * D * pairs, PEAK_TF32_S)
    flash = timed(
        dict(
            name="flash_fwd", route="cuda",
            source="sparknet_tpu_torch/ops/csrc/flash_fwd.cu",
            replaces="sparknet_tpu/ops/pallas_attention.py:67",
            max_abs_err=flash_err, bound_ms=fb, bound_by=fby,
            shape=f"B={B} T={T} H={H} D={D} causal fp32",
        ),
        lambda: ca.flash_attention(q, k, v, True),
        lambda: ca.flash_attention_reference(q, k, v, True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
    )

    # K2 timed on the paged arena, beside masked SDPA on the context
    # gathered from it; the bound counts the valid rows only
    n_valid = int(lengths.sum())
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])
    mask = mask[:, None, None, :]

    def paged_timed(h, d, record):
        case = paged[d] if h == H else paged_decode_case(dev, gen, h, d)
        q, ak, av, table = case
        db, dby = bound_ms(4 * (2 * Bd * h * d + 2 * n_valid * h * d + Bd),
                           4 * h * d * n_valid)
        rows = (table.long()[:, torch.arange(S, device=dev) // bs] * bs
                + torch.arange(S, device=dev) % bs)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, ak[rows], av[rows]))
        record.update(bound_ms=db, bound_by=dby, shape=(
            f"paged: B={Bd} H={h} D={d} {ak.shape[0] // bs} blocks of {bs}, "
            f"sum(lengths)={n_valid} fp32"))
        return timed(
            record,
            lambda: ca.paged_decode_attention(q, ak, av, table, lengths, bs),
            lambda: ca.paged_decode_attention_reference(q, ak, av, table,
                                                        lengths, bs),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
        )

    decode = paged_timed(H, D, dict(
        name="decode_attention", route="cuda",
        source="sparknet_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="sparknet_tpu/ops/pallas_attention.py:320",
        max_abs_err=dec_err,
    ))
    wide = paged_timed(2, 256, {})
    print(f"K2 paged decode [{wide['shape']}] on device: kernel "
          f"{wide['ms']:.4f} ms ({wide['call_ms']:.4f} per call), plain "
          f"{wide['plain_ms']:.4f} ms, library {wide['library_ms']:.4f} ms, "
          f"bound {wide['bound_ms'] * 1e3:.3f} us ({wide['bound_by']})")
    decode["d256"] = wide
    # K1 at the LM training shape, beside its SDPA yardstick and bound
    q, k, v = (rand(LB, LT, H, D) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = LB * H * LT * (LT + 1) // 2
    lb, lby = bound_ms(4 * (4 * LB * LT * H * D + LB * H * LT), 3 * 4 * D * pairs,
                       PEAK_TF32_S)
    lm = timed({}, lambda: ca.flash_attention(q, k, v, True),
               lambda: ca.flash_attention_reference(q, k, v, True),
               lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    print(f"K1 flash_fwd [B={LB} T={LT} H={H} D={D} causal fp32] on device: "
          f"kernel {lm['ms']:.4f} ms ({lm['call_ms']:.4f} per call), plain "
          f"{lm['plain_ms']:.4f} ms, library {lm['library_ms']:.4f} ms, bound "
          f"{lb * 1e3:.3f} us ({lby}, 3xTF32: {lb / lm['ms']:.1%} of it)")
    flash["lm_shape"] = dict(lm, bound_ms=lb, bound_by=lby)
    for r in (flash, decode):
        print(f"{r['name']} [{r['shape']}] on device (per call as a caller "
              f"waits): kernel {r['ms']:.4f} ms ({r['call_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms ({r['plain_call_ms']:.4f}), library "
              f"{r['library_ms']:.4f} ms ({r['library_call_ms']:.4f}), bound "
              f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    return [flash, decode]


def padded_decode_step(dev):
    """``cli serve --generate --lm_dim 160 --lm_heads 4`` (head dim 40):
    the pool keeps its rows 48 wide, so a decode step copies nothing
    (``PAD_COPIES`` 0) and runs K2 once a layer; the streamed logprobs
    within ``LOGPROB_ATOL`` of a CPU copy scoring the same tokens."""
    from sparknet_tpu_torch.models.transformer_lm import TransformerLM
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.serve import GenerationEngine

    model, steps = dict(CLI_MODEL, dim=160), 8
    engine = GenerationEngine(TransformerLM(**model), device=dev, **CLI_SERVE)
    check(tuple(engine.pool.k.shape[2:]) == (4, 48),
          f"D=40 pool rows {tuple(engine.pool.k.shape)}")
    prompt = list(range(1, 30))
    slot, tok, lp = engine.admit(prompt, steps + 1)
    ca.reset_launch_counts()
    toks, lps = [tok], [lp]
    for _ in range(steps):
        t, l = engine.step()[slot]
        toks.append(t)
        lps.append(l)
    torch.cuda.synchronize()
    launches, pads = dict(ca.LAUNCHES), ca.PAD_COPIES
    engine.finish(slot)
    cpu = GenerationEngine(TransformerLM(**model), device="cpu", **CLI_SERVE)
    err = float(np.abs(np.array(lps) - cpu.score_tokens(prompt, toks)).max())
    print(f"K2 in {steps} decode steps at head dim 40 (rows 48 wide): "
          f"launches {launches}, pad copies {pads}, max |logprob diff| vs "
          f"CPU {err:.3e}")
    check(pads == 0 and launches["decode_attention"] == steps * model["depth"],
          f"D=40 decode step: launches {launches}, pad copies {pads}")
    check(err <= LOGPROB_ATOL, f"D=40 decode step: logprobs differ by {err}")


# ----------------------------------------------------------------------
# phase 3: the main path — cli serve --generate, 4 concurrent streams
# ----------------------------------------------------------------------
def _stream(host, port, prompt, out, i):
    conn = http.client.HTTPConnection(host, port, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", "/generate",
                 body=json.dumps({"prompt": prompt, "max_new": MAX_NEW}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    events, t_first = [], None
    for line in resp:
        if not line.strip():
            continue
        ev = json.loads(line)
        if t_first is None:
            t_first = time.perf_counter() - t0
        events.append(ev)
    conn.close()
    out[i] = dict(status=resp.status, events=events, ttft_s=t_first,
                  total_s=time.perf_counter() - t0)


def serve_end_to_end(dev, card, weights=None, out=None):
    """Phase 3, and phase 10's ``--weights`` run (``weights``: a model
    file both engines load); ``out`` receives each stream's tokens."""
    from sparknet_tpu_torch.models.transformer_lm import TransformerLM
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.serve import GenerationEngine, ServeServer

    t0 = time.perf_counter()
    engine = GenerationEngine(TransformerLM(**CLI_MODEL), weights=weights,
                              device=dev, **CLI_SERVE)
    n_shapes = engine.warmup()
    print(f"engine built and warmed ({n_shapes} shapes, "
          f"{engine.lm.num_params()} params) in "
          f"{time.perf_counter() - t0:.2f} s")
    server = ServeServer(engine, host="127.0.0.1", port=0)
    server.start()
    host, port = server.address
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, size=n).tolist() for n in PROMPT_LENS]
    results = [None] * len(prompts)
    threads = [
        threading.Thread(target=_stream, args=(host, port, p, results, i),
                         name=f"client-{i}")
        for i, p in enumerate(prompts)
    ]
    ca.reset_launch_counts()
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t_start
    torch.cuda.synchronize()
    launches = dict(ca.LAUNCHES)
    prefills = server.batcher.m_ttft.count
    steps = server.batcher.m_occupancy.count
    server.shutdown()
    check(all(not t.is_alive() for t in threads), "a stream did not finish")

    depth = CLI_MODEL["depth"]
    print(f"main path: {prefills} prefills, {steps} decode steps, "
          f"launches {launches}")
    check(prefills == len(prompts), f"{prefills} prefills")
    check(launches["flash_fwd"] >= prefills * depth > 0,
          "prefill did not run the flash kernel")
    check(launches["decode_attention"] >= steps * depth > 0,
          "decode did not run the decode kernel")

    # the CPU reference: the same seeded model, plain attention
    cpu = GenerationEngine(TransformerLM(**CLI_MODEL), weights=weights,
                           device="cpu", **CLI_SERVE)
    for name, p in engine.lm.state_dict().items():
        check(torch.equal(p.cpu(), cpu.lm.state_dict()[name]),
              f"weights differ at {name}")
    worst_lp, worst_gpu_score, ties, n_tok = 0.0, 0.0, 0, 0
    streamed = []
    for prompt, r in zip(prompts, results):
        check(r is not None and r["status"] == 200, f"stream failed: {r}")
        evs = r["events"]
        check(evs[-1]["event"] == "done", f"stream ended {evs[-1]}")
        toks = [e["token"] for e in evs if e["event"] == "token"]
        lps = np.array([e["logprob"] for e in evs if e["event"] == "token"])
        check(len(toks) == MAX_NEW and toks == evs[-1]["tokens"],
              "token events and the done event disagree")
        streamed.append(toks)
        check(bool(np.isfinite(lps).all()), "non-finite logprob")
        ref_lp = cpu.score_tokens(prompt, toks)
        worst_lp = max(worst_lp, float(np.abs(lps - ref_lp).max()))
        gpu_lp = engine.score_tokens(prompt, toks)  # the scorer on the card
        worst_gpu_score = max(worst_gpu_score,
                              float(np.abs(gpu_lp - ref_lp).max()))
        seq = np.zeros((1, CLI_MODEL["seq_len"]), np.int64)
        seq[0, : len(prompt) + len(toks)] = prompt + toks
        logits = cpu.lm.forward_logits(torch.from_numpy(seq))[0]
        for j, tok in enumerate(toks):
            top2 = torch.topk(logits[len(prompt) - 1 + j], 2)
            n_tok += 1
            if tok != int(top2.indices[0]):
                margin = float(top2.values[0] - top2.values[1])
                check(margin < TIE_MARGIN,
                      f"token {j} differs from the CPU argmax "
                      f"(margin {margin})")
                ties += 1
    print(f"vs CPU reference: {n_tok} tokens, max |logprob diff| "
          f"{worst_lp:.3e} (limit {LOGPROB_ATOL}), scorer on card "
          f"{worst_gpu_score:.3e}, {ties} tokens differ at near-ties")
    check(worst_lp <= LOGPROB_ATOL, f"logprobs differ by {worst_lp}")
    check(worst_gpu_score <= LOGPROB_ATOL,
          f"card scorer differs by {worst_gpu_score}")
    ttfts = sorted(r["ttft_s"] for r in results)
    print(f"[{card}] TTFT over {len(results)} concurrent streams: "
          f"min {ttfts[0] * 1e3:.2f} ms, max {ttfts[-1] * 1e3:.2f} ms")
    print(f"[{card}] {n_tok} tokens in {wall:.3f} s wall: "
          f"{n_tok / wall:.1f} tokens/s across 4 streams; intertoken p50 "
          f"{server.batcher.m_intertoken.quantile(0.5) * 1e3:.2f} ms")
    if out is not None:
        out["tokens"] = streamed
    if weights is None:
        where_time_goes(engine, card)
    return launches


def where_time_goes(engine, card, iters: int = 15):
    """Wall time of one decode step with all 8 slots live (prompts of
    16..128 tokens) and of one T=128 prefill, the device's busy share
    of it, and the kernels that take the device time
    (``torch.profiler``).  The prefill's pad rows are all dropped, so
    it writes nothing; the slots are freed at the end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    T = CLI_SERVE["prefill_buckets"][-1]
    rs = np.random.RandomState(1)
    slots = [
        engine.admit(rs.randint(0, 256, size=16 * (i + 1)).tolist(),
                     2 * iters + 8)[0]
        for i in range(engine.max_streams)
    ]
    oob = np.full((T,), engine.pool.oob_row, np.int64)
    programs = (
        ("decode step, 8 live slots", engine.step),
        (f"prefill T={T}",
         lambda: engine._prefill(np.zeros((1, T), np.int64), 0, oob)),
    )
    for name, fn in programs:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        # device-side events only: a CPU op also reports the device
        # time of the kernels it launched, which would count them twice
        rows = sorted(
            ((e.self_device_time_total / iters / 1e3, e.count // iters, e.key)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0),
            reverse=True,
        )
        busy = sum(r[0] for r in rows)
        check(busy > 0, f"{name}: the profiler saw no device time")
        attn = sum(r[0] for r in rows if "flash_fwd_kernel" in r[2]
                   or "paged_decode" in r[2])
        n_kernels = sum(r[1] for r in rows)
        print(f"[{card}] {name}: {wall_ms:.3f} ms wall, {busy:.3f} ms "
              f"device busy ({busy / wall_ms:.1%}), {n_kernels} kernel "
              f"launches of {len(rows)} kinds; the port's attention "
              f"kernels {attn:.4f} ms ({attn / busy:.1%} of device)")
        decode = name.startswith("decode")
        for ms, count, key in rows if decode else rows[:6]:
            print(f"    {ms:.4f} ms ({ms / busy:.1%} of device, {count} "
                  f"launches)  {key[:90]}")
        if decode:
            # K2 reads the arena through the block table: no advanced-index
            # read (the (L, B, S, H, D) context gather ran as one) and no
            # more launches than the step that gathered
            gathers = [r for r in rows if "index_kernel_impl" in r[2]]
            check(not gathers, f"{name}: a context gather ran: {gathers}")
            check(n_kernels <= GATHERED_STEP_LAUNCHES,
                  f"{name}: {n_kernels} launches, more than the "
                  f"{GATHERED_STEP_LAUNCHES} of the gathering step")
            check(any("paged_decode_kernel" in r[2] and r[1] == CLI_MODEL[
                "depth"] for r in rows), f"{name}: K2 not once a layer")
    for slot in slots:
        engine.finish(slot)
    check(engine.pool.used() == 0, "KV blocks leaked")

# ----------------------------------------------------------------------
# phase 4: the comm epilogue kernels (K9-K11) against their plain
# versions, bit for bit, at the cifar10_full chunk shapes
# ----------------------------------------------------------------------
CIFAR_W, CIFAR_TAU, CIFAR_BATCH = 4, 10, 100
TRAIN_ROUNDS = 8  # per training leg of phase 5
TRAIN_LOSSES: dict = {}  # phase 5's final smoothed losses, by leg


def _cifar_trainer(dev, compress="int8", overlap=False, metrics=None):
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
    from sparknet_tpu_torch.solver import Solver

    solver = Solver(models.load_model_solver("cifar10_full"), device=dev)
    return ParameterAveragingTrainer(solver, CIFAR_W, compress=compress,
                                     overlap_avg=overlap, metrics=metrics)


def _bitwise(got, want, what) -> float:
    """Check ``got`` equals ``want`` bit for bit (NaNs in the same places;
    bf16 compared as bits) and return max |got - want| (0.0)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
          f"{tuple(want.shape)}")
    if not got.is_floating_point():
        check(bool(torch.equal(got, want)), f"{what}: payload differs")
        return float((got.float() - want.float()).abs().max())
    gn, wn = torch.isnan(got.float()), torch.isnan(want.float())
    check(bool(torch.equal(gn, wn)), f"{what}: NaNs differ")
    g, w = got[~gn], want[~wn]
    if got.dtype == torch.bfloat16:
        check(bool(torch.equal(g.view(torch.int16), w.view(torch.int16))),
              f"{what}: bits differ")
    else:
        check(bool(torch.equal(g, w)), f"{what}: bits differ")
    return float((g.float() - w.float()).abs().max()) if g.numel() else 0.0


def _comm_set(dev, trainer, seed):
    """A trainer's comm leaves near its init, as one round's epilogue sees
    them: params x, anchors a, residuals r and chunk means, made on the
    card from ``seed``.  Returns ``(x, a, r, means, chunks)``."""
    state = trainer.init_state(0)
    leaves, chunks = trainer._comm.plan(state)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def near(xs, s):
        return [(t + s * torch.randn(t.shape, generator=gen, device=dev))
                .contiguous() for t in xs]

    a = [t.contiguous() for t in leaves]
    x = near(a, 1e-3)
    r = near([torch.zeros_like(t) for t in a], 1e-6)
    means = [t[0].contiguous() for t in near(a, 1e-3)]
    return x, a, r, means, chunks


def _check_comm_set(cc, x, a, r, means, chunks, w, modes_of, err, what):
    """K9 in every mode of ``modes_of`` (the readout off and on) and K11
    after it, K10 with every worker live, one masked and none, each
    against its plain version bit for bit (the readout's sums within
    1e-5); the worst |diff| of each kernel goes into ``err``."""
    dev = x[0].device
    for mode in modes_of:
        for sl in chunks:
            modes = (mode,) * (sl.stop - sl.start)
            for with_err in (False, True):
                got = cc.encode(x[sl], a[sl], r[sl], modes, with_err)
                want = cc.encode_reference(x[sl], a[sl], r[sl], modes, with_err)
                for g, wt in zip(got[0] + got[1] + got[2],
                                 want[0] + want[1] + want[2]):
                    err["comm_encode"] = max(err["comm_encode"],
                                             _bitwise(g, wt, f"K9 {mode} {what}"))
                if with_err:
                    check(bool(torch.equal(got[3][:, 0], want[3][:, 0])),
                          f"K9 max|err| differs ({what})")
                    rel = float(((got[3][:, 1:] - want[3][:, 1:]).abs()
                                 / want[3][:, 1:].abs().clamp_min(1e-30)).max())
                    check(rel <= 1e-5, f"K9 readout sums differ by {rel} ({what})")
            q, scales = got[0], got[1]
            got = cc.apply_correction(x[sl], a[sl], q, scales, means[sl], modes)
            want = cc.apply_correction_reference(x[sl], a[sl], q, scales,
                                                 means[sl], modes)
            for g, wt in zip(got[0] + got[1], want[0] + want[1]):
                err["comm_apply_correction"] = max(
                    err["comm_apply_correction"],
                    _bitwise(g, wt, f"K11 {mode} {what}"))
    for alive in ([1] * w, [1, 0] + [1] * (w - 2), [0] * w):
        al = torch.tensor(alive, dtype=torch.float32, device=dev)
        d0 = al.sum()
        for sl in chunks:
            got = cc.apply_barriered(x[sl], a[sl], means[sl], r[sl], al, d0)
            want = cc.apply_barriered_reference(x[sl], a[sl], means[sl], r[sl],
                                                al, d0)
            for g, wt in zip(got[0] + got[1], want[0] + want[1]):
                err["comm_apply_barriered"] = max(
                    err["comm_apply_barriered"],
                    _bitwise(g, wt, f"K10 {alive} {what}"))
    torch.cuda.synchronize()


def _time_comm_set(cc, x, a, r, means, chunks, w, n):
    """Each kernel's device time over one round's launches (every chunk)
    at the main path's modes — K9 int8 with the readout, K10 all live,
    K11 bf16 (the overlap leg) — beside its plain version's, with the
    bytes of its bound: what the function must move (each input read
    once, each output written once) and what the design moves.  ``n``
    rounds a CUDA graph."""
    def per_round(fn):
        return lambda: [fn(sl) for sl in chunks]

    int8 = {sl.start: ("int8",) * (sl.stop - sl.start) for sl in chunks}
    bf16 = {sl.start: ("bf16",) * (sl.stop - sl.start) for sl in chunks}
    q16 = {sl.start: cc.encode(x[sl], a[sl], r[sl], bf16[sl.start], False)[:2]
           for sl in chunks}
    al = torch.ones(w, device=x[0].device)
    d0 = al.sum()
    elems = sum(t.numel() for t in x)
    cases = {
        "comm_encode": (
            "K9", "int8, readout on",
            lambda sl: cc.encode(x[sl], a[sl], r[sl], int8[sl.start], True),
            lambda sl: cc.encode_reference(x[sl], a[sl], r[sl], int8[sl.start],
                                           True),
            sum(cc.chunk_bytes("encode", a[sl], int8[sl.start]) for sl in chunks),
            # int8: one pass for max |delta| (x, a, r in, delta out), one
            # to quantize (delta in, q and the residual out)
            25 * elems,
        ),
        "comm_apply_barriered": (
            "K10", "all live",
            lambda sl: cc.apply_barriered(x[sl], a[sl], means[sl], r[sl], al, d0),
            lambda sl: cc.apply_barriered_reference(x[sl], a[sl], means[sl],
                                                    r[sl], al, d0),
            sum(cc.chunk_bytes("apply_barriered", a[sl], int8[sl.start])
                for sl in chunks),
            # a, mean (read by each worker), r in; x, r out
            20 * elems,
        ),
        "comm_apply_correction": (
            "K11", "bf16",
            lambda sl: cc.apply_correction(x[sl], a[sl], *q16[sl.start],
                                           means[sl], bf16[sl.start]),
            lambda sl: cc.apply_correction_reference(
                x[sl], a[sl], *q16[sl.start], means[sl], bf16[sl.start]),
            sum(cc.chunk_bytes("apply_correction", a[sl], bf16[sl.start])
                for sl in chunks),
            # x, a, the payload (2 B), mean (read by each worker) in; x, a out
            22 * elems,
        ),
    }
    out = {}
    for name, (tag, what, kern, plain, nbytes, design) in cases.items():
        b, by = bound_ms(nbytes, 0.0)
        out[name] = dict(
            tag=tag, what=what, bytes=nbytes, bound_ms=b, bound_by=by,
            design_bytes=design,
            design_bound_ms=None if design is None else design / PEAK_BYTES_S * 1e3,
            ms=device_ms(per_round(kern), n), call_ms=time_ms(per_round(kern)),
            plain_ms=device_ms(per_round(plain), n),
            plain_call_ms=time_ms(per_round(plain), iters=10, warm=2),
        )
    return out


def check_comm_kernels(dev):
    """K9 encode, K10 barriered apply and K11 overlap correction against
    their plain versions on the card, at the real comm chunks of
    cifar10_full at W=4 (all three modes, the readout on and off, a
    masked worker and no survivors for K10, an all-zero leaf) and of
    AlexNet at W=2 (int8, bf16 and fp32 over its 16 parameter leaves).
    Then each kernel's time over one round's launches at both beside its
    plain version's and its bound.  Returns the kernels-line records, with
    AlexNet's times."""
    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer

    err = {"comm_encode": 0.0, "comm_apply_barriered": 0.0,
           "comm_apply_correction": 0.0}
    x, a, r, means, chunks = _comm_set(dev, _cifar_trainer(dev), 1)
    # the ip1 bias leaf all zero: amax 0 -> int8 scale 1
    for t in (a, x, r):
        t[-1] = torch.zeros_like(t[-1])
    sizes = [sl.stop - sl.start for sl in chunks]
    print(f"comm plane, cifar10_full: {len(chunks)} chunks of {sizes} leaves, "
          f"{sum(t[0].numel() for t in a)} floats per worker, W={CIFAR_W}")
    check(len(chunks) == 3, f"expected 3 comm chunks, got {len(chunks)}")
    _check_comm_set(cc, x, a, r, means, chunks, CIFAR_W, ("fp32", "bf16", "int8"),
                    err, "cifar10_full")
    times = {"cifar10_full": _time_comm_set(cc, x, a, r, means, chunks, CIFAR_W,
                                            20)}
    del x, a, r, means

    solver = imagenet_app.build_solver(
        _imnet_args(dev), np.zeros((3, IMNET_FULL, IMNET_FULL), np.float32), dev)
    x, a, r, means, chunks = _comm_set(
        dev, ParameterAveragingTrainer(solver, IMNET_W, compress="int8"), 2)
    del solver
    sizes = [sl.stop - sl.start for sl in chunks]
    print(f"comm plane, AlexNet: {len(chunks)} chunks of {sizes} leaves, "
          f"{sum(t[0].numel() for t in a)} floats per worker, W={IMNET_W}; "
          "floats per worker of each leaf: "
          + ", ".join(str(t[0].numel()) for t in a))
    check(len(a) == 16, f"AlexNet has 16 parameter leaves, got {len(a)}")
    _check_comm_set(cc, x, a, r, means, chunks, IMNET_W, ("fp32", "bf16", "int8"),
                    err, "AlexNet")
    times["AlexNet"] = _time_comm_set(cc, x, a, r, means, chunks, IMNET_W, 5)
    del x, a, r, means

    # ResNet-50's 320 comm leaves (161 learnable, then 159 BatchNorm stat
    # blobs), cut into the plane's 4 byte-balanced chunks: a chunk of more
    # than MAX_LEAVES leaves runs one launch a group of at most 32 of them
    solver = imagenet_app.build_solver(
        _imnet_args(dev, model="resnet50"),
        np.zeros((3, IMNET_FULL, IMNET_FULL), np.float32), dev)
    x, a, r, means, chunks = _comm_set(
        dev, ParameterAveragingTrainer(solver, IMNET_W, compress="int8"), 3)
    del solver
    sizes = [sl.stop - sl.start for sl in chunks]
    groups = sum(-(-n // cc.MAX_LEAVES) for n in sizes)
    print(f"comm plane, ResNet-50: {len(chunks)} chunks of {sizes} leaves "
          f"({groups} launches of at most {cc.MAX_LEAVES} leaves a round), "
          f"{sum(t[0].numel() for t in a)} floats per worker, W={IMNET_W}")
    check(len(a) == 320 and len(chunks) == 4 and max(sizes) > cc.MAX_LEAVES,
          f"ResNet-50: {len(a)} comm leaves in chunks of {sizes}")
    cc.reset_launch_counts()
    _check_comm_set(cc, x, a, r, means, chunks, IMNET_W, ("fp32", "bf16", "int8"),
                    err, "ResNet-50")
    # per mode: K9 with the readout off and on, K11 once; K10 for three
    # masks; each wrapper call launches once a group
    want = {"comm_encode": 3 * 2 * groups, "comm_apply_correction": 3 * groups,
            "comm_apply_barriered": 3 * groups}
    check(cc.LAUNCHES == want,
          f"ResNet-50 comm launches {cc.LAUNCHES}, expected {want}")
    cc.reset_launch_counts()
    times["ResNet-50"] = _time_comm_set(cc, x, a, r, means, chunks, IMNET_W, 5)
    del x, a, r, means
    torch.cuda.empty_cache()
    print("K9-K11 bitwise equal to their plain versions at cifar10_full (W=4), "
          "AlexNet (W=2) and ResNet-50 (W=2, chunks of up to "
          f"{max(sizes)} leaves): 3 modes x readout on/off, a masked worker, "
          "no survivors, an all-zero leaf")

    records = []
    replaces = {"comm_encode": 83, "comm_apply_barriered": 164,
                "comm_apply_correction": 224}
    for name, line in replaces.items():
        for shape, t in times.items():
            rec = t[name]
            design = ("" if rec["design_bytes"] is None else
                      f"; the design's {rec['design_bytes']} bytes "
                      f"{rec['design_bound_ms'] * 1e3:.3f} us "
                      f"({rec['design_bound_ms'] / rec['ms']:.1%} of it)")
            print(f"{rec['tag']} {name} [{shape}, one round's launches, "
                  f"{rec['what']}]: kernel {rec['ms']:.4f} ms on device "
                  f"({rec['call_ms']:.4f} ms per call), plain "
                  f"{rec['plain_ms']:.4f} ms ({rec['plain_call_ms']:.4f}); "
                  f"bound {rec['bound_ms'] * 1e3:.3f} us ({rec['bound_by']}, "
                  f"{rec['bytes']} bytes: {rec['bound_ms'] / rec['ms']:.1%} of "
                  f"it){design}; library: none")
        alex = times["AlexNet"][name]
        records.append(dict(
            name=name, route="cuda",
            source="sparknet_tpu_torch/ops/csrc/comm_epilogue.cu",
            replaces=f"sparknet_tpu/ops/pallas_comm.py:{line}",
            max_abs_err=err[name], library_ms=None,
            **{k: alex[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        ))
    return records


# ----------------------------------------------------------------------
# phase 5: the training main path — cifar_app on the card, three legs
# ----------------------------------------------------------------------
def _first_round_matches_cpu(dev, compress, overlap):
    """One round of the W=4 cifar10_full trainer on the card and on the
    CPU from one carried init and one set of windows: the round's
    parameter updates agree within ``tol`` of their size."""
    from sparknet_tpu_torch.data import CifarLoader, MinibatchSampler, stack_windows
    from sparknet_tpu_torch.utils.tree import tree_leaves

    with tempfile.TemporaryDirectory() as d:
        CifarLoader.write_synthetic(d, num_train=5000, num_test=100)
        xs, ys = CifarLoader(d, seed=0).minibatches(CIFAR_BATCH)
    batches = stack_windows([
        MinibatchSampler({"data": x, "label": y}, CIFAR_TAU, seed=w).next_window()
        for w, (x, y) in enumerate(zip(np.array_split(xs, CIFAR_W),
                                       np.array_split(ys, CIFAR_W)))
    ])
    runs = []
    init = None
    for d in (dev, torch.device("cpu")):
        tr = _cifar_trainer(d, compress, overlap)
        init = init if init is not None else tr.solver.init_state(0)
        st0 = tr.broadcast_state(init)
        st, _ = tr.round(st0, {k: torch.from_numpy(v).to(d)
                               for k, v in batches.items()})
        st = tr.finalize(st)
        runs.append([t.cpu() for t in tree_leaves(st.params)])
    x0 = [t.cpu() for t in tree_leaves(init.params)]
    # float32 on both sides, but cuDNN and the CPU sum the convolutions in
    # other orders over 10 momentum steps (~1e-3 of the update, measured);
    # quantized deltas: a last-bit difference may also move an element
    # across one step of the bf16/int8 grid
    tol = 1e-2 if compress == "none" else 3e-2
    worst = 0.0
    for g, c, p0 in zip(runs[0], runs[1], x0):
        size = float((c - p0[None]).abs().max())
        worst = max(worst, float((g - c).abs().max()) / max(size, 1e-30))
    check(worst <= tol, f"first round on the card vs the CPU ({compress}): "
          f"{worst:.3e} of the update (limit {tol})")
    return worst


def train_end_to_end(dev, card):
    """``cifar_app.main`` in process on synthesized CIFAR (5,000 / 1,000),
    W=4, tau=10, batch 100, TRAIN_ROUNDS rounds, in three legs: no
    compression, ``--compress int8`` (K9 + K10) and ``--compress bf16
    --overlap_avg`` (K9 + K11).  Launch counts are reset before each leg
    and read after it; each compressed leg's final smoothed loss is held
    within LOSS_BAND of the uncompressed leg's, and each leg's first round
    against the same round on the CPU.  Returns the summed launches."""
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.parallel import LOSS_BAND

    legs = (("none", []), ("int8", ["--compress", "int8"]),
            ("bf16+overlap", ["--compress", "bf16", "--overlap_avg"]))
    argv = ["--device", dev.type, "--workers", str(CIFAR_W), "--tau",
            str(CIFAR_TAU), "--batch", str(CIFAR_BATCH), "--rounds",
            str(TRAIN_ROUNDS)]
    total = dict.fromkeys(cc.LAUNCHES, 0)
    losses = {}
    R = TRAIN_ROUNDS
    expect = {
        "none": dict(comm_encode=0, comm_apply_barriered=0, comm_apply_correction=0),
        "int8": dict(comm_encode=3 * R, comm_apply_barriered=3 * R,
                     comm_apply_correction=0),
        "bf16+overlap": dict(comm_encode=3 * R, comm_apply_barriered=0,
                             comm_apply_correction=3 * R),
    }
    for leg, extra in legs:
        result = {}
        cc.reset_launch_counts()
        rc = cifar_app.main(argv + extra, result)
        torch.cuda.synchronize()
        launches = dict(cc.LAUNCHES)
        check(rc == 0, f"cifar_app leg {leg} exited {rc}")
        print(f"train leg {leg}: launches {launches}, final smoothed_loss "
              f"{result['smoothed_loss']:.6f}, accuracy {result['accuracy']:.4f}")
        check(launches == expect[leg],
              f"leg {leg}: launches {launches}, expected {expect[leg]}")
        for leaf in result["state"].params.values():
            for t in leaf:
                check(bool(torch.isfinite(t).all()), f"leg {leg}: non-finite params")
        losses[leg] = result["smoothed_loss"]
        check(np.isfinite(losses[leg]), f"leg {leg}: non-finite loss")
        rs = np.array(result["round_seconds"][1:])  # round 0 warms up
        imgs = CIFAR_W * CIFAR_TAU * CIFAR_BATCH
        print(f"[{card}] train leg {leg}: {1.0 / rs.mean():.3f} rounds/s, "
              f"{imgs / rs.mean():.1f} images/s (mean of rounds 1..{R - 1}: "
              f"{rs.mean() * 1e3:.2f} ms, min {rs.min() * 1e3:.2f} ms)")
        worst = _first_round_matches_cpu(
            dev, "none" if leg == "none" else extra[1], "--overlap_avg" in extra
        )
        print(f"train leg {leg}: first round on the card vs the CPU, worst "
              f"|diff| {worst:.3e} of the update")
        for k, v in launches.items():
            total[k] += v
    TRAIN_LOSSES.update(losses)
    for leg in ("int8", "bf16+overlap"):
        gap = abs(losses[leg] - losses["none"])
        print(f"loss band: {leg} {losses[leg]:.6f} vs none {losses['none']:.6f}: "
              f"gap {gap:.6f} (limit {LOSS_BAND})")
        check(gap <= LOSS_BAND, f"{leg} leaves the loss band: {gap}")
    where_train_time_goes(dev, card)
    return total


def where_train_time_goes(dev, card):
    """One int8 round of the W=4 cifar10_full trainer under
    ``torch.profiler``: wall time, the device's busy share, the kernels
    that take the device time, and K9-K11's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr = _cifar_trainer(dev, "int8")
    st = tr.init_state(0)
    rs = np.random.RandomState(0)
    batch = {
        "data": torch.from_numpy(rs.randn(CIFAR_W, CIFAR_TAU, CIFAR_BATCH, 3, 32, 32)
                                 .astype(np.float32) * 50).to(dev),
        "label": torch.from_numpy(rs.randint(0, 10, (CIFAR_W, CIFAR_TAU, CIFAR_BATCH))
                                  .astype(np.float32)).to(dev),
    }
    st, _ = tr.round(st, batch)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = tr.round(st, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st, _ = tr.round(st, batch)
        torch.cuda.synchronize()
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    check(busy > 0, "train round: the profiler saw no device time")
    comm = sum(r[0] for r in rows if "encode_kernel" in r[2]
               or "apply_barriered_kernel" in r[2]
               or "apply_correction_kernel" in r[2])
    n_kernels = sum(r[1] for r in rows)
    print(f"[{card}] train round (cifar10_full, W={CIFAR_W}, tau={CIFAR_TAU}, "
          f"int8): {wall_ms:.3f} ms wall, {busy:.3f} ms device busy "
          f"({busy / wall_ms:.1%}), {n_kernels} kernel launches of {len(rows)} "
          f"kinds; K9-K11 {comm:.4f} ms ({comm / busy:.2%} of device)")
    for ms, count, key in rows[:8]:
        print(f"    {ms:.4f} ms ({ms / busy:.1%} of device, {count} launches)  "
              f"{key[:90]}")


# ----------------------------------------------------------------------
# phase 6: the flash backward kernels (K3, K4) against their plain
# versions, at the LM training shape and its edges
# ----------------------------------------------------------------------
LM_MODEL = dict(CLI_MODEL)  # the LM trains at the width it serves
LM_W, LM_TAU, LM_BATCH, LM_ROUNDS = 2, 4, 8, 6
# lm_app's default rate, 0.1 (the JAX package's, tuned at dim 64), diverged
# at this width on the H100 (per-round loss 4.61 -> 8.16 -> 9.46); 0.05,
# 0.03 and 0.02 spiked; 0.01 falls from ln 256 to ~2.9 in 6 rounds
LM_LR = 0.01
# the JAX package's LM associativity tolerance (bench.py BENCH_LM_TOL)
LM_TOL = 5e-4
# first LM round on the card vs the CPU, relative to the round's update:
# float32 on both sides, summed in other orders over 4 momentum steps
LM_CPU_TOL = 1e-2
# the large-magnitude case of K3/K4: q and k scaled by this
BWD_LARGE = 8.0
# (sum, sum of |w|) in float64 of LM_MODEL's weights from seed 0, drawn with
# the JAX package's threefry recipe; tests/test_torch_jax_prng.py pins the
# same value for the port's init and the JAX package's
LM_INIT_CHECKSUM = (2320.4935653680072, 42125.24800601355)
LM_INIT_RTOL = 1e-6


def lm_init_checksum(params):
    """(sum, sum of |w|) in float64 over every blob of ``params``."""
    blobs = [t.detach().double() for bs in params.values() for t in bs]
    return (sum(float(t.sum()) for t in blobs),
            sum(float(t.abs().sum()) for t in blobs))


def _bwd_case(dev, gen, b, tq, tk, h, d, q_off, k_off, causal, mag=1.0,
              fused=False):
    """Seeded inputs of K3/K4: q, k, v, do, dlse and K1's (o, lse) (through
    the autograd path, which pads a head dim off the built ones); q and
    k scaled by ``mag``; with ``fused``, q, k and v are strided views of
    one (B, T, 3, H, D) tensor, as a fused qkv projection gives them."""
    from sparknet_tpu_torch.ops import cuda_attention as ca

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    if fused:
        q, k, v = rand(b, tq, 3, h, d).unbind(2)
    else:
        q, k, v = rand(b, tq, h, d), rand(b, tk, h, d), rand(b, tk, h, d)
    if mag != 1.0:
        q, k = q * mag, k * mag
    do, dlse = rand(b, tq, h, d), rand(b, h, tq)
    o, lse = ca._FlashCore.apply(q, k, v, q_off, k_off, causal)
    return (q, k, v, do, o, lse, dlse, q_off, k_off, causal)


def _bwd_float64(q, k, v, do, o, lse, dlse, q_off, k_off, causal):
    """dq, dk, dv of the flash backward's formulas in float64 (dense),
    from the same float32 inputs: the referee of the large-magnitude
    case, where the float32 plain version is itself not that close to
    the exact result."""
    q, k, v, do, o = (x.double().permute(0, 2, 1, 3) for x in (q, k, v, do, o))
    tq, tk, d = q.shape[2], k.shape[2], q.shape[-1]
    scale = 1.0 / np.sqrt(d)
    s = q @ k.transpose(-1, -2) * scale
    if causal:
        q_pos = q_off + torch.arange(tq, device=q.device)[:, None]
        k_pos = k_off + torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, float("-inf"))
    lse = lse.double()
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    delta = (do * o).sum(-1) - dlse.double()
    ds = p * (do @ v.transpose(-1, -2) - delta[..., None]) * scale
    return tuple(x.permute(0, 2, 1, 3)
                 for x in (ds @ k, ds.transpose(-1, -2) @ q,
                           p.transpose(-1, -2) @ do))


def check_bwd_kernels(dev):
    """Hold K3 and K4 against their plain versions on the card; return
    their kernels-line records (without launch counts)."""
    from sparknet_tpu_torch.ops import cuda_attention as ca

    gen = torch.Generator(device="cpu").manual_seed(2)
    B, T, H, D = LM_BATCH, LM_MODEL["seq_len"], LM_MODEL["heads"], \
        LM_MODEL["dim"] // LM_MODEL["heads"]
    cases = [
        ("training shape", (B, T, T, H, D, 0, 0, True), {}),
        ("non-causal", (B, T, T, H, D, 0, 0, False), {}),
        ("ragged T_q", (2, 37, 100, H, D, 63, 0, True), {}),
        ("offsets (0, 64), 64 fully-masked rows",
         (2, 128, 128, H, D, 0, 64, True), {}),
        ("D=16", (2, 70, 70, H, 16, 0, 0, True), {}),
        ("D=32", (2, 70, 70, H, 32, 0, 0, True), {}),
        ("D=48", (2, 100, 100, H, 48, 0, 0, True), {}),
        ("D=128", (2, 100, 100, H, 128, 0, 0, True), {}),
        ("D=256", (2, 100, 100, H, 256, 0, 0, True), {}),
        ("D=256, non-causal", (2, 100, 100, H, 256, 0, 0, False), {}),
        ("D=40, padded to 48", (2, 100, 100, H, 40, 0, 0, True), {}),
        ("D=200, padded to 224", (2, 100, 100, H, 200, 0, 0, True), {}),
        (f"q, k x{BWD_LARGE:g}", (B, T, T, H, D, 0, 0, True),
         dict(mag=BWD_LARGE)),
        ("q, k, v views of a fused qkv", (B, T, T, H, D, 0, 0, True),
         dict(fused=True)),
    ]
    err = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for what, shape, how in cases:
        args = _bwd_case(dev, gen, *shape, **how)
        ca.reset_launch_counts()
        padded = shape[4] not in ca.KERNEL_HEAD_DIMS
        if padded:
            # K3/K4 take built head dims: the autograd path pads q, k and
            # v once in the forward and do in the backward
            q, k, v = (t.detach().requires_grad_(True) for t in args[:3])
            o, lse = ca._FlashCore.apply(q, k, v, *args[7:])
            torch.autograd.backward((o, lse), (args[3], args[6]))
            got = {"flash_bwd_dq": (q.grad,),
                   "flash_bwd_dkv": (k.grad, v.grad)}
            args = (*args[:4], o.detach(), lse.detach(), *args[6:])
        else:
            got = {"flash_bwd_dq": (ca.flash_bwd_dq(*args),),
                   "flash_bwd_dkv": ca.flash_bwd_dkv(*args)}
        check(ca.LAUNCHES["flash_bwd_dq"] == ca.LAUNCHES["flash_bwd_dkv"] == 1
              and ca.PAD_COPIES == (4 if padded else 0),
              f"K3/K4 {what}: launches {ca.LAUNCHES}, pad copies "
              f"{ca.PAD_COPIES}")
        want = {"flash_bwd_dq": (ca._flash_bwd_dq_reference(*args),),
                "flash_bwd_dkv": ca._flash_bwd_dkv_reference(*args)}
        exact = _bwd_float64(*args)
        torch.cuda.synchronize()
        # with q, k x8 the scores have a spread of ~64, and float32 itself
        # strays from the exact result by more than BWD_RTOL there (the
        # plain version's gap is printed): the kernels are held to a
        # float64 evaluation, within BWD_RTOL of the scale or the plain
        # float32 version's own gap from it, whichever is larger
        large = how.get("mag", 1.0) != 1.0
        for name, outs, x64 in (("flash_bwd_dq", ("K3 dq",), exact[:1]),
                                ("flash_bwd_dkv", ("K4 dk", "K4 dv"),
                                 exact[1:])):
            for g, w, x, out in zip(got[name], want[name], x64, outs):
                check(bool(torch.isfinite(g).all()), f"{out} {what}: non-finite")
                ref = x if large else w.double()
                e = float((g.double() - ref).abs().max())
                scale = max(1.0, float(ref.abs().max()))
                plain_gap = float((w.double() - x).abs().max())
                limit = max(BWD_RTOL * scale, plain_gap if large else 0.0)
                print(f"{out} {what} {tuple(g.shape)}: max_abs_err {e:.3e} "
                      f"against the {'float64' if large else 'plain'} version "
                      f"(scale {scale:.3g}, limit {limit:.3e}); kernel - "
                      f"float64 {float((g.double() - x).abs().max()) / scale:.2e}"
                      f", plain - float64 {plain_gap / scale:.2e} of the scale")
                check(e <= limit,
                      f"{name} disagrees ({what}): {e} > {limit}")
                if not large:
                    err[name] = max(err[name], e)
        if shape[6] == 64:  # q_off 0, k_off 64: rows 0..63 see no key
            check(bool((got["flash_bwd_dq"][0][:, :64] == 0).all()),
                  "fully-masked rows must give dq = 0")

    # times at the training shape, causal, dlse = 0 (what the LM passes)
    args = list(_bwd_case(dev, gen, B, T, T, H, D, 0, 0, True))
    args[6] = torch.zeros_like(args[6])
    args = tuple(args)
    q, k, v, do = args[:4]
    pairs = B * H * T * (T + 1) // 2  # visible (query, key) pairs
    tensor_bytes = 4 * B * T * H * D
    row_bytes = 4 * B * H * T
    # K3 reads q, k, v, o, do, lse, dlse and writes dq: 3 products; K4
    # reads the same and writes dk, dv: 4 products.  Each product runs as
    # three TF32 products on the tensor cores (the kernels-line bound); the
    # float32 bound is the same work outside the tensor cores.
    dq_bytes, dq_ops = 6 * tensor_bytes + 2 * row_bytes, 6 * D * pairs
    dkv_bytes, dkv_ops = 7 * tensor_bytes + 2 * row_bytes, 8 * D * pairs
    dq_b, dq_by = bound_ms(dq_bytes, 3 * dq_ops, PEAK_TF32_S)
    dkv_b, dkv_by = bound_ms(dkv_bytes, 3 * dkv_ops, PEAK_TF32_S)
    fp32_bound = {"flash_bwd_dq": bound_ms(dq_bytes, dq_ops),
                  "flash_bwd_dkv": bound_ms(dkv_bytes, dkv_ops)}
    lib_fwd, lib_fwd_bwd, _ = sdpa_yardstick(q, k, v, do)
    library = lib_fwd_bwd - lib_fwd
    shape = f"B={B} T={T} H={H} D={D} causal fp32"
    records = []
    for name, tag, line, kernel, plain, b, by in (
        ("flash_bwd_dq", "K3", 91, lambda: ca.flash_bwd_dq(*args),
         lambda: ca._flash_bwd_dq_reference(*args), dq_b, dq_by),
        ("flash_bwd_dkv", "K4", 119, lambda: ca.flash_bwd_dkv(*args),
         lambda: ca._flash_bwd_dkv_reference(*args), dkv_b, dkv_by),
    ):
        rec = dict(
            name=name, route="cuda",
            source="sparknet_tpu_torch/ops/csrc/flash_bwd.cu",
            replaces=f"sparknet_tpu/ops/pallas_attention.py:{line}",
            max_abs_err=err[name], bound_ms=b, bound_by=by,
            library_ms=library, shape=shape,
            ms=device_ms(kernel), call_ms=time_ms(kernel),
            plain_ms=device_ms(plain), plain_call_ms=time_ms(plain),
        )
        f32_b, f32_by = fp32_bound[name]
        print(f"{tag} {name} [{shape}]: kernel {rec['ms']:.4f} ms on device "
              f"({rec['call_ms']:.4f} ms per call), plain {rec['plain_ms']:.4f} "
              f"ms ({rec['plain_call_ms']:.4f}); bound {b * 1e3:.3f} us ({by}, "
              f"3xTF32: {b / rec['ms']:.1%} of it), float32 bound "
              f"{f32_b * 1e3:.3f} us ({f32_by}: "
              + (f"{f32_b / rec['ms']:.1%})" if f32_b <= rec["ms"] else
                 "beaten: no bound for tensor-core products)"))
        records.append(rec)
    print(f"K3+K4 library yardstick: scaled_dot_product_attention fwd+bwd "
          f"{lib_fwd_bwd:.4f} ms - fwd {lib_fwd:.4f} ms = {library:.4f} ms on "
          f"device; K3+K4 {records[0]['ms'] + records[1]['ms']:.4f} ms")
    return records


def sdpa_yardstick(q, k, v, do):
    """``scaled_dot_product_attention`` (causal) on the kernels' (B, T, H,
    D) inputs, a yardstick the port never calls: its device time forward
    and forward + backward (cotangent ``do``), and the backend it takes."""
    import torch.nn.functional as F

    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    do_s = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qs, ks, vs), do_s)

    try:  # the dispatcher's choice, as an SDPBackend index
        from torch.nn.attention import SDPBackend

        backend = SDPBackend(torch._fused_sdp_choice(qs, ks, vs,
                                                     is_causal=True)).name
    except (AttributeError, ImportError, RuntimeError, ValueError) as e:
        backend = f"not reported ({type(e).__name__}: {e})"
    return device_ms(sdpa), device_ms(sdpa_fwd_bwd), backend


# ``lm_app --dim 512 --heads 2``'s attention: head dim 256, the widest
# build (K1, K3 and K4 split the output's columns into halves)
WIDE_LM = dict(dim=512, depth=2, heads=2, seq_len=256)


def time_wide_head(dev):
    """K1, K3 and K4 at B=8, T=256, H=2, D=256, causal, with a nonzero
    dlse: each held against its plain version on the same inputs (K1 to
    KERNEL_ATOL, K3/K4 to BWD_RTOL of the plain output's largest
    magnitude), then its device time beside the plain version's and the
    bound (bytes, or three TF32 passes of the products), and the library
    yardstick ``scaled_dot_product_attention`` at the same shape (K1: its
    forward; K3+K4: forward + backward minus forward), or its refusal."""
    from sparknet_tpu_torch.ops import cuda_attention as ca

    gen = torch.Generator(device="cpu").manual_seed(3)
    b, t, h = LM_BATCH, WIDE_LM["seq_len"], WIDE_LM["heads"]
    d = WIDE_LM["dim"] // h
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen).to(dev)
                   for _ in range(4))
    dlse = torch.randn(b, h, t, generator=gen).to(dev)
    o, lse = ca._flash_core(q, k, v, 0, 0, True)
    want_o, want_lse = ca._flash_core_reference(q, k, v, 0, 0, True)
    e = max(max_err(o, want_o), max_err(lse, want_lse))
    print(f"flash_fwd D={d}: max_abs_err {e:.3e} against the plain version")
    check(e <= KERNEL_ATOL, f"flash_fwd disagrees at D={d}: {e}")
    args = (q, k, v, do, o, lse, dlse, 0, 0, True)
    got = (ca.flash_bwd_dq(*args), *ca.flash_bwd_dkv(*args))
    want = (ca._flash_bwd_dq_reference(*args),
            *ca._flash_bwd_dkv_reference(*args))
    for out, g, w in zip(("K3 dq", "K4 dk", "K4 dv"), got, want):
        e = max_err(g, w)
        limit = BWD_RTOL * max(1.0, float(w.abs().max()))
        print(f"{out} D={d}: max_abs_err {e:.3e} against the plain version "
              f"(limit {limit:.3e})")
        check(e <= limit, f"{out} disagrees at D={d}: {e} > {limit}")
    pairs = b * h * t * (t + 1) // 2
    tensor_bytes, row_bytes = 4 * b * t * h * d, 4 * b * h * t
    kernel_ms = {}
    for name, kernel, plain, nbytes, ops in (
        ("flash_fwd", lambda: ca._flash_core(q, k, v, 0, 0, True),
         lambda: ca._flash_core_reference(q, k, v, 0, 0, True),
         4 * tensor_bytes + row_bytes, 4 * d * pairs),
        ("flash_bwd_dq", lambda: ca.flash_bwd_dq(*args),
         lambda: ca._flash_bwd_dq_reference(*args),
         6 * tensor_bytes + 2 * row_bytes, 6 * d * pairs),
        ("flash_bwd_dkv", lambda: ca.flash_bwd_dkv(*args),
         lambda: ca._flash_bwd_dkv_reference(*args),
         7 * tensor_bytes + 2 * row_bytes, 8 * d * pairs),
    ):
        bound, by = bound_ms(nbytes, 3 * ops, PEAK_TF32_S)
        ms = device_ms(kernel)
        kernel_ms[name] = ms
        print(f"{name} [B={b} T={t} H={h} D={d} causal fp32]: kernel {ms:.4f} "
              f"ms on device, plain {device_ms(plain):.4f} ms, bound "
              f"{bound * 1e3:.3f} us ({by}, 3xTF32: {bound / ms:.1%} of it)")
    try:
        lib_fwd, lib_fwd_bwd, backend = sdpa_yardstick(q, k, v, do)
    except RuntimeError as e:  # SDPA may refuse fp32 at this head dim
        print(f"library yardstick at D={d}: scaled_dot_product_attention "
              f"refused: {e}")
        return
    bwd = kernel_ms["flash_bwd_dq"] + kernel_ms["flash_bwd_dkv"]
    print(f"library yardstick [B={b} T={t} H={h} D={d} causal fp32]: "
          f"scaled_dot_product_attention ({backend}) fwd {lib_fwd:.4f} ms "
          f"(K1 {kernel_ms['flash_fwd']:.4f}); fwd+bwd {lib_fwd_bwd:.4f} - fwd "
          f"= {lib_fwd_bwd - lib_fwd:.4f} ms (K3+K4 {bwd:.4f})")


# ----------------------------------------------------------------------
# phase 7: the LM training main path — lm_app on the card, two legs
# ----------------------------------------------------------------------
def _lm_argv(dev):
    m = LM_MODEL
    return ["--device", dev.type, "--workers", str(LM_W), "--tau", str(LM_TAU),
            "--batch", str(LM_BATCH), "--rounds", str(LM_ROUNDS),
            "--dim", str(m["dim"]), "--depth", str(m["depth"]),
            "--heads", str(m["heads"]), "--seq_len", str(m["seq_len"]),
            "--base_lr", str(LM_LR), "--log_every", "1"]


def _lm_trainer(dev):
    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer

    args = lm_app._parser().parse_args(_lm_argv(dev))
    lm, solver = lm_app.build_lm_solver(args, dev)
    return lm, ParameterAveragingTrainer(solver, LM_W)


def _lm_batch(r: int):
    """Round ``r``'s (W, tau, B, T) windows, as lm_app draws them."""
    from sparknet_tpu_torch.data import (
        TextWindowSampler, load_corpus, stack_windows, write_synthetic_corpus)

    with tempfile.TemporaryDirectory() as d:
        write_synthetic_corpus(d, seed=0)
        docs = load_corpus(d)
    base = TextWindowSampler(docs, LM_MODEL["seq_len"], LM_BATCH, seed=0)
    return stack_windows([base.for_worker(w).window_for_round(r, LM_TAU)
                          for w in range(LM_W)])


def _lm_first_round_matches_cpu(dev):
    """Round 0 of the flash leg on the card and on the CPU from one init
    and one set of windows: the parameter updates agree within
    LM_CPU_TOL of their size, the losses within LM_TOL."""
    from sparknet_tpu_torch.utils.tree import tree_leaves

    batch = _lm_batch(0)
    runs, init = [], None
    for d in (dev, torch.device("cpu")):
        _, tr = _lm_trainer(d)
        init = init if init is not None else tr.solver.init_state(0)
        st, losses = tr.round(tr.broadcast_state(init),
                              {k: torch.from_numpy(v).to(d)
                               for k, v in batch.items()})
        runs.append(([t.cpu() for t in tree_leaves(st.params)], losses.cpu()))
    x0 = [t.cpu() for t in tree_leaves(init.params)]
    worst = 0.0
    for g, c, p0 in zip(runs[0][0], runs[1][0], x0):
        size = float((c - p0[None]).abs().max())
        worst = max(worst, float((g - c).abs().max()) / max(size, 1e-30))
    loss_gap = float((runs[0][1] - runs[1][1]).abs().max())
    check(worst <= LM_CPU_TOL, f"LM first round on the card vs the CPU: "
          f"{worst:.3e} of the update (limit {LM_CPU_TOL})")
    check(loss_gap <= LM_TOL, f"LM first-round losses differ by {loss_gap}")
    return worst, loss_gap


def lm_train_end_to_end(dev, card):
    """``lm_app.main`` in process at the CLI model's width, W=2, tau 4,
    batch 8, LM_ROUNDS rounds, flash and dense legs; returns the flash
    leg's launches."""
    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.utils.tree import tree_leaves

    n = LM_MODEL["depth"] * LM_W * LM_TAU * LM_ROUNDS
    expect = {
        "flash": dict(flash_fwd=n, flash_bwd_dq=n, flash_bwd_dkv=n,
                      decode_attention=0),
        "dense": dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
                      decode_attention=0),
    }
    from sparknet_tpu_torch.models.transformer_lm import TransformerLMNet

    t0 = time.perf_counter()
    init, _ = TransformerLMNet(**LM_MODEL).init(0, torch.device("cpu"))
    draw_s = time.perf_counter() - t0
    got = lm_init_checksum(init)
    print(f"LM init from seed 0 (the JAX package's threefry recipe, drawn on "
          f"the host in {draw_s:.3f} s): checksum sum {got[0]!r}, sum|w| "
          f"{got[1]!r}; pinned {LM_INIT_CHECKSUM}")
    check(bool(np.allclose(got, LM_INIT_CHECKSUM, rtol=LM_INIT_RTOL, atol=0)),
          f"LM init checksum {got} is not the pinned {LM_INIT_CHECKSUM}")
    results, launches = {}, {}
    for leg, extra in (("flash", []), ("dense", ["--dense_attention"])):
        result = {}
        ca.reset_launch_counts()
        rc = lm_app.main(_lm_argv(dev) + extra, result)
        torch.cuda.synchronize()
        launches[leg] = dict(ca.LAUNCHES)
        check(rc == 0, f"lm_app leg {leg} exited {rc}")
        losses = result["losses"]  # (rounds, W, tau)
        per_round = losses.mean(axis=(1, 2))
        print(f"LM leg {leg}: launches {launches[leg]}, per-round mean loss "
              + " ".join(f"{x:.4f}" for x in per_round))
        check(launches[leg] == expect[leg],
              f"LM leg {leg}: launches {launches[leg]}, expected {expect[leg]}")
        check(bool(np.isfinite(losses).all()), f"LM leg {leg}: non-finite loss")
        check(abs(float(losses[0, :, 0].mean()) - np.log(256)) < 0.5,
              f"LM leg {leg}: first loss {losses[0, :, 0].mean()} not ~ln 256")
        check(per_round[-1] < per_round[0] - 0.5,
              f"LM leg {leg}: loss did not fall ({per_round[0]} -> "
              f"{per_round[-1]})")
        for t in tree_leaves(result["state"].params):
            check(bool(torch.isfinite(t).all()), f"LM leg {leg}: non-finite params")
        rs = np.array(result["round_seconds"][1:])  # round 0 warms up
        print(f"[{card}] LM leg {leg}: {result['tokens_per_round'] / rs.mean():.1f} "
              f"tokens/s, {1.0 / rs.mean():.3f} rounds/s (mean of rounds "
              f"1..{LM_ROUNDS - 1}: {rs.mean() * 1e3:.2f} ms, min "
              f"{rs.min() * 1e3:.2f} ms)")
        results[leg] = result
    loss_gap = float(np.abs(results["flash"]["losses"]
                            - results["dense"]["losses"]).max())
    param_gap = max(
        float((a - b).abs().max())
        for a, b in zip(tree_leaves(results["flash"]["state"].params),
                        tree_leaves(results["dense"]["state"].params)))
    print(f"LM flash vs dense over {LM_ROUNDS} rounds: losses {loss_gap:.3e}, "
          f"params {param_gap:.3e} (limit {LM_TOL})")
    check(loss_gap <= LM_TOL, f"flash and dense losses differ by {loss_gap}")
    check(param_gap <= LM_TOL, f"flash and dense params differ by {param_gap}")
    worst, first_gap = _lm_first_round_matches_cpu(dev)
    print(f"LM first round on the card vs the CPU: worst |diff| {worst:.3e} of "
          f"the update, losses {first_gap:.3e}")
    where_lm_time_goes(dev, card)
    # head dim 256 (dim 512, 2 heads): one round on the kernels
    w = WIDE_LM
    result = {}
    ca.reset_launch_counts()
    rc = lm_app.main(["--device", dev.type, "--workers", str(LM_W), "--tau",
                      str(LM_TAU), "--batch", str(LM_BATCH), "--rounds", "1",
                      "--dim", str(w["dim"]), "--depth", str(w["depth"]),
                      "--heads", str(w["heads"]), "--seq_len",
                      str(w["seq_len"]), "--base_lr", str(LM_LR),
                      "--log_every", "1"], result)
    torch.cuda.synchronize()
    wide = dict(ca.LAUNCHES)
    n = w["depth"] * LM_W * LM_TAU
    gauge = result["metrics"].kernel_path.labels("attention").value
    print(f"LM head dim {w['dim'] // w['heads']} (dim {w['dim']}, heads "
          f"{w['heads']}, depth {w['depth']}), one round: launches {wide}, "
          f"kernel-path gauge {gauge}, losses "
          f"{result['losses'].mean(axis=(1, 2)).round(4).tolist()}")
    check(rc == 0 and bool(np.isfinite(result["losses"]).all()),
          "lm_app at head dim 256 failed")
    check(wide == dict(flash_fwd=n, flash_bwd_dq=n, flash_bwd_dkv=n,
                       decode_attention=0) and ca.PAD_COPIES == 0,
          f"lm_app at head dim 256: launches {wide}, pad copies {ca.PAD_COPIES}")
    check(gauge == 1.0, f"lm_app at head dim 256: kernel-path gauge {gauge}")
    return {k: launches["flash"][k] + wide[k] for k in wide}


def where_lm_time_goes(dev, card):
    """One flash round of the LM trainer under ``torch.profiler``: wall
    time, the device's busy share, the top kernels and K1/K3/K4's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, tr = _lm_trainer(dev)
    st = tr.init_state(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _lm_batch(0).items()}
    st, _ = tr.round(st, batch)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = tr.round(st, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        st, _ = tr.round(st, batch)
        torch.cuda.synchronize()
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    check(busy > 0, "LM round: the profiler saw no device time")
    share = {tag: sum(r[0] for r in rows if kern in r[2])
             for tag, kern in (("K1", "flash_fwd_kernel"),
                               ("K3", "flash_bwd_dq_kernel"),
                               ("K4", "flash_bwd_dkv_kernel"))}
    n_kernels = sum(r[1] for r in rows)
    print(f"[{card}] LM round (dim {LM_MODEL['dim']}, depth {LM_MODEL['depth']}, "
          f"W={LM_W}, tau={LM_TAU}, batch {LM_BATCH}, flash): {wall_ms:.3f} ms "
          f"wall, {busy:.3f} ms device busy ({busy / wall_ms:.1%}), {n_kernels} "
          f"kernel launches of {len(rows)} kinds; "
          + ", ".join(f"{t} {ms:.4f} ms ({ms / busy:.1%})" for t, ms in share.items()))
    for ms, count, key in rows[:8]:
        print(f"    {ms:.4f} ms ({ms / busy:.1%} of device, {count} launches)  "
              f"{key[:90]}")


# ----------------------------------------------------------------------
# phase 8: the LRN kernels (K5, K6) and the fused LRN + max pool (K7,
# K8) against their plain versions, at AlexNet's shapes and the edges
# ----------------------------------------------------------------------
IMNET_W, IMNET_TAU, IMNET_BATCH, IMNET_TEST_BATCH = 2, 4, 32, 16
IMNET_FULL, IMNET_CROP, IMNET_ROUNDS, IMNET_TEST_EVERY = 256, 227, 4, 2
# AlexNet's LRN inputs at the training batch: norm1 over conv1, norm2
# over conv2 (alexnet_train_val.prototxt, crop 227)
ALEXNET_LRN = ((IMNET_BATCH, 96, 55, 55), (IMNET_BATCH, 256, 27, 27))
# the bf16 LRN kernels' counts in a float32 run's launches
NO_BF16 = dict.fromkeys(("lrn_fwd_bf16", "lrn_bwd_bf16", "lrn_pool_fwd_bf16",
                         "lrn_pool_bwd_bf16"), 0)
# GoogLeNet's LRN inputs at crop 227 (phase 12): norm1 after pool1 and
# norm2 after conv2, both 57x57 (odd: under SPARKNET_FUSION=1 the
# training net's conv2/norm2 -> pool2 runs K7/K8)
GOOGLENET_LRN = ((IMNET_BATCH, 64, 57, 57), (IMNET_BATCH, 192, 57, 57))
LRN_HP = (5, 1e-4, 0.75, 1.0)
LRN_FWD_TOL = dict(rtol=2e-5, atol=2e-6)  # the JAX tests' (test_pallas_plp.py)
LRN_BWD_TOL = dict(rtol=5e-5, atol=5e-6)
# the fused leg's per-round (mean over workers and iterations) losses
# against the default leg's, relative.  Both draw the same crops and
# masks, and the forwards are bit-equal (K5 and K7 share the LRN
# arithmetic), but K8 sums a position's routed gradients in the Pallas
# order where max_pool2d's backward sums them in its own, and cuDNN's
# backward is not deterministic: last-bit differences that 16 SGD steps
# of a net whose loss falls from 6.9 to 4.8 amplify.  Round 0 is held to
# 1e-4; every round to 2e-3: on the H100 the fused leg lay up to 2.8e-4
# from the default leg, and two runs of the default leg up to 4.8e-4
# from each other.
FUSED_LOSS_RTOL = 1e-4
FUSED_DRIFT_RTOL = 2e-3
# the default leg's first round on the card vs the CPU, of each blob's
# update: 1% after one local step, where only summation order and
# rsqrt's rounding differ; 5% after several, where a net whose loss
# falls fast flips ReLU units and pooling maxima near their ties on one
# device and not the other (2.0e-2 measured on the H100 after tau = 4,
# and two runs of the default leg on the card drift 2e-4 apart in the
# loss by round 2).  The round of several steps runs IMNET_CPU_STEPS of
# them: the CPU's float32 and float64 runs of AlexNet at batch 32 take
# most of phase 9, about 15 s a local step
IMNET_CPU_TOL = 1e-2
IMNET_CPU_ROUND_TOL = 5e-2
IMNET_CPU_STEPS = 2
# the comm-plane legs (int8: K9 + K10 each round; the overlapped average
# with an fp32 and a bf16 payload: K9 + K11): cut to 2 rounds, testing at
# round 0
IMNET_COMM_ROUNDS = 2
COMM_LEGS = ("int8", "fp32+overlap", "bf16+overlap")
# each compressed leg and the fp32 leg of its averaging schedule, whose
# smoothed losses it must stay within LOSS_BAND of (the band pins what a
# compressed payload may cost against the fp32 collective).  The
# overlapped average lands one local step late, which alone moves
# round 1's smoothed loss (one iteration: average_loss 1) ~0.08 from the
# barriered default leg's on the H100 (PERF.md §6); that gap is
# printed, and held by no band
LOSS_BAND_PAIRS = (("int8", "default"), ("bf16+overlap", "fp32+overlap"))


def _close(got, want, tol, what) -> float:
    """Check ``got`` within ``tol`` (rtol/atol) of ``want``; return the
    max |got - want|."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
    err = (got - want).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements off, max "
          f"|diff| {float(err.max()):.3e}")
    return float(err.max())


def _tie_input(dev, shape, seed):
    """Constant along channels over a period-2 spatial pattern of small
    integers: every window ties between its columns 0 and 2 and rows 0
    and 2."""
    n, c, h, w = shape
    base = np.random.RandomState(seed).randint(0, 3, (n, 1, 2, 2))
    plane = np.tile(base, (1, 1, (h + 1) // 2, (w + 1) // 2))[:, :, :h, :w]
    return torch.from_numpy(np.repeat(plane, c, axis=1).astype(np.float32)).to(dev)


def check_lrn_kernels(dev, card):
    """Hold K5-K8 against their plain versions on the card; return their
    kernels-line records (without launch counts), timed per training
    step: both AlexNet sandwiches.  The cases also take GoogLeNet's
    shapes (phase 12)."""
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.ops import cuda_plp as cp

    gen = torch.Generator().manual_seed(4)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    err = dict.fromkeys(("lrn_fwd", "lrn_bwd", "lrn_pool_fwd", "lrn_pool_bwd"),
                        0.0)
    # K5 and K6 at AlexNet's and GoogLeNet's LRN inputs (train and test
    # batch), random and tied, and K5 also at AlexNet's inputs at other
    # LRN settings (its general kernel), must give the plain versions'
    # bits (every operation an explicitly rounded intrinsic); K5
    # everywhere
    net_lrn = ALEXNET_LRN + GOOGLENET_LRN
    test_lrn = tuple((IMNET_TEST_BATCH,) + s[1:] for s in net_lrn)
    cases = [(s, 5, 0.75, False) for s in net_lrn + test_lrn] + [
        (s, 5, 0.75, True) for s in net_lrn + test_lrn] + [
        (s, n, beta, False) for s in ALEXNET_LRN for n, beta in ((5, 0.6),
                                                                (3, 0.75))] + [
        (s, n, beta, False) for s, n, beta in (
            ((2, 7, 11, 13), 5, 0.75), ((2, 3, 9, 9), 5, 0.75),
            ((2, 16, 9, 9), 3, 0.75), ((2, 16, 9, 9), 5, 0.6),
            ((2, 16, 5, 7), 4, 0.75))]
    for shape, n, beta, ties in cases:
        hp = (n, 1e-4, beta, 1.0)
        x = _tie_input(dev, shape, 6) if ties else rand(*shape)
        dy = rand(*shape)
        y, dx = cl.lrn_fwd(x, *hp), cl.lrn_bwd(x, dy, *hp)
        torch.cuda.synchronize()
        what = f"{shape}{' ties' if ties else ''} n={n} beta={beta}"
        want_y = cl.lrn_across_reference(x, *hp)
        ef = _close(y, want_y, LRN_FWD_TOL, f"K5 {what}")
        check(bool(torch.equal(y, want_y)),
              f"K5 {what}: y differs from the plain version's bits")
        want = cl.lrn_across_bwd_reference(x, dy, *hp)
        eb = _close(dx, want, LRN_BWD_TOL, f"K6 {what}")
        same = bool(torch.equal(dx, want))
        if shape in net_lrn + test_lrn and (n, beta) == (5, 0.75):
            check(same, f"K6 {what}: dx differs from the plain version's bits")
        print(f"K5/K6 lrn {what}: max_abs_err fwd {ef:.3e}, bwd {eb:.3e}; K5 "
              f"bit-equal, K6 bit-equal {same}")
        err["lrn_fwd"] = max(err["lrn_fwd"], ef)
        err["lrn_bwd"] = max(err["lrn_bwd"], eb)
    # K7 and K8 at both AlexNet sandwiches and GoogLeNet's conv2/norm2 ->
    # pool2 (57x57 -> 28x28: K7's row-band tiles on an odd plane)
    plp_net = ALEXNET_LRN + GOOGLENET_LRN[1:]
    plp_cases = [(s, False, LRN_HP) for s in plp_net + (
        (2, 7, 11, 13), (1, 32, 9, 9), (2, 5, 3, 3))]
    plp_cases += [(s, True, LRN_HP) for s in plp_net + ((2, 7, 11, 13),)]
    # K7 and K8 at other LRN settings than Caffe's default (the kernels'
    # general instantiation, not FAST): local_size 3 and 7, beta 0.6 on
    # the powf path and 0.5 on the square-root path, on a plane of each
    # of K7's tile kinds (whole planes up to 32 wide, row bands above)
    plp_cases += [(s, False, (n, 1e-4, beta, 1.0))
                  for s in ((2, 16, 27, 27), (2, 24, 55, 55))
                  for n, beta in ((3, 0.75), (7, 0.75), (5, 0.6), (5, 0.5))]
    for shape, ties, hp in plp_cases:
        x = _tie_input(dev, shape, 5) if ties else rand(*shape)
        dy = rand(shape[0], shape[1], *cp.pooled_hw(*shape[2:]))
        y, dx = cp.lrn_pool_fwd(x, *hp), cp.lrn_pool_bwd(x, dy, *hp)
        routed = cp.lrn_pool_bwd(x, dy, hp[0], 0.0, *hp[2:])  # alpha 0: identity LRN
        torch.cuda.synchronize()
        what = f"{shape} n={hp[0]} beta={hp[2]}"
        ef = _close(y, cp.lrn_maxpool_reference(x, *hp), LRN_FWD_TOL,
                    f"K7 {what}")
        eb = _close(dx, cp.lrn_maxpool_bwd_reference(x, dy, *hp),
                    LRN_BWD_TOL, f"K8 {what}")
        check(bool(torch.equal(routed, cp.route_reference(x, dy))),
              f"K8 {what}: routed positions differ from the plain version")
        check(bool(torch.equal(dx, cp.lrn_maxpool_bwd_reference(x, dy, *hp))),
              f"K8 {what}: dx differs from the plain version's bits")
        check(bool(torch.equal(y, cp.lrn_maxpool_reference(x, *hp))),
              f"K7 {what}: the pooled output differs from the plain "
              "version's bits")
        print(f"K7/K8 lrn_pool {shape}{' ties' if ties else ''} n={hp[0]} "
              f"beta={hp[2]}: max_abs_err fwd {ef:.3e}, bwd {eb:.3e}; K7's "
              "output, the routing and K8's dx bit-equal")
        err["lrn_pool_fwd"] = max(err["lrn_pool_fwd"], ef)
        err["lrn_pool_bwd"] = max(err["lrn_pool_bwd"], eb)

    # times per training step: one launch per sandwich, both sandwiches
    xs = [rand(*s) for s in ALEXNET_LRN]
    dys = [rand(*s) for s in ALEXNET_LRN]
    dps = [rand(s[0], s[1], *cp.pooled_hw(*s[2:])) for s in ALEXNET_LRN]
    xg = [x.clone().requires_grad_(True) for x in xs]
    n, alpha, beta, k = LRN_HP

    def lib_lrn(v):
        return F.local_response_norm(v, n, alpha=alpha, beta=beta, k=k)

    def lib_pool(v):
        return F.max_pool2d(lib_lrn(v), 3, 2)

    def each(fn):
        return lambda: [fn(i) for i in range(len(xs))]

    def lib_bwd(fwd, cot):
        return each(lambda i: torch.autograd.grad(fwd(xg[i]), xg[i], cot[i]))

    sizes = [x.numel() * 4 for x in xs]
    pooled = [d.numel() * 4 for d in dps]
    # bytes: each input read once, each output written once; operations
    # per element (the fp32 bound is far below the byte bound): K5 n
    # products and sums for the window, 2 for the scale, 4 for
    # scale^-beta, 1 for y; K6 that plus 3 per term, n-1 per window sum
    # and 3 for dx; K7/K8 add 8 comparisons per pooled output
    elems = [x.numel() for x in xs]
    pel = [d.numel() for d in dps]
    cases = {
        "lrn_fwd": ("K5", "sparknet_tpu_torch/ops/csrc/lrn.cu",
                    "sparknet_tpu/ops/pallas_lrn.py:64",
                    each(lambda i: cl.lrn_fwd(xs[i], *LRN_HP)),
                    each(lambda i: cl.lrn_across_reference(xs[i], *LRN_HP)),
                    each(lambda i: lib_lrn(xs[i])), None,
                    sum(2 * b for b in sizes), sum((n + 7) * e for e in elems)),
        "lrn_bwd": ("K6", "sparknet_tpu_torch/ops/csrc/lrn.cu",
                    "sparknet_tpu/ops/pallas_lrn.py:70",
                    each(lambda i: cl.lrn_bwd(xs[i], dys[i], *LRN_HP)),
                    each(lambda i: cl.lrn_across_bwd_reference(xs[i], dys[i],
                                                               *LRN_HP)),
                    lib_bwd(lib_lrn, dys), each(lambda i: lib_lrn(xg[i])),
                    sum(3 * b for b in sizes), sum((3 * n + 16) * e for e in elems)),
        "lrn_pool_fwd": ("K7", "sparknet_tpu_torch/ops/csrc/lrn_pool.cu",
                         "sparknet_tpu/ops/pallas_plp.py:148",
                         each(lambda i: cp.lrn_pool_fwd(xs[i], *LRN_HP)),
                         each(lambda i: cp.lrn_maxpool_reference(xs[i], *LRN_HP)),
                         each(lambda i: lib_pool(xs[i])), None,
                         sum(sizes) + sum(pooled),
                         sum((n + 7) * e for e in elems) + sum(8 * p for p in pel)),
        "lrn_pool_bwd": ("K8", "sparknet_tpu_torch/ops/csrc/lrn_pool.cu",
                         "sparknet_tpu/ops/pallas_plp.py:166",
                         each(lambda i: cp.lrn_pool_bwd(xs[i], dps[i], *LRN_HP)),
                         each(lambda i: cp.lrn_maxpool_bwd_reference(
                             xs[i], dps[i], *LRN_HP)),
                         lib_bwd(lib_pool, dps), each(lambda i: lib_pool(xg[i])),
                         2 * sum(sizes) + sum(pooled),
                         sum((3 * n + 16) * e for e in elems)
                         + sum(16 * p for p in pel)),
    }
    records = []
    shape = " + ".join(str(s) for s in ALEXNET_LRN) + " fp32"
    for name, (tag, src, replaces, kern, plain, lib, lib_fwd, nbytes,
               ops) in cases.items():
        b, by = bound_ms(nbytes, ops)
        library = device_ms(lib) - (device_ms(lib_fwd) if lib_fwd else 0.0)
        rec = dict(name=name, route="cuda", source=src, replaces=replaces,
                   max_abs_err=err[name], bound_ms=b, bound_by=by,
                   library_ms=library, shape=shape,
                   ms=device_ms(kern), call_ms=time_ms(kern),
                   plain_ms=device_ms(plain), plain_call_ms=time_ms(plain))
        print(f"[{card}] {tag} {name} [{shape}, both sandwiches]: kernel "
              f"{rec['ms']:.4f} ms on device ({rec['call_ms']:.4f} ms "
              "per call), "
              f"plain {rec['plain_ms']:.4f} ms ({rec['plain_call_ms']:.4f}), "
              f"library {library:.4f} ms, bound {b * 1e3:.3f} us ({by}, "
              f"{nbytes} bytes) -> {b / rec['ms']:.1%} of the bound")
        for i, s in enumerate(ALEXNET_LRN):  # each sandwich alone
            one = {"lrn_fwd": lambda: cl.lrn_fwd(xs[i], *LRN_HP),
                   "lrn_bwd": lambda: cl.lrn_bwd(xs[i], dys[i], *LRN_HP),
                   "lrn_pool_fwd": lambda: cp.lrn_pool_fwd(xs[i], *LRN_HP),
                   "lrn_pool_bwd": lambda: cp.lrn_pool_bwd(xs[i], dps[i], *LRN_HP)}
            one_bytes = {"lrn_fwd": 2 * sizes[i], "lrn_bwd": 3 * sizes[i],
                         "lrn_pool_fwd": sizes[i] + pooled[i],
                         "lrn_pool_bwd": 2 * sizes[i] + pooled[i]}[name]
            ms = device_ms(one[name])
            one_bound = one_bytes / PEAK_BYTES_S * 1e3
            print(f"    {s}: kernel {ms:.4f} ms, bound {one_bound * 1e3:.3f} us "
                  f"(bytes) -> {one_bound / ms:.1%} of the bound")
        records.append(rec)
    # the unfused sandwich the fusion replaces: K5 then max_pool2d
    unfused = device_ms(each(lambda i: F.max_pool2d(cl.lrn_fwd(xs[i], *LRN_HP),
                                                    3, 2)))
    print(f"[{card}] K5 + max_pool2d (the unfused forward of both sandwiches): "
          f"{unfused:.4f} ms on device; K7 {records[2]['ms']:.4f} ms")
    return records


# ----------------------------------------------------------------------
# phase 9: the ImageNet training main path — imagenet_app's training
# function at AlexNet's full width, two legs
# ----------------------------------------------------------------------
def _imnet_args(dev, extra=(), model="alexnet"):
    """The app's arguments at phase 9's (and phase 12's) sizes.  Without
    ``--data`` the app caps a builder model's classes at 4 (its
    synthesized demo); the phases train on their own partitions at
    1,000."""
    from sparknet_tpu_torch.apps import imagenet_app

    args = imagenet_app.parse_args([
        "--model", model, "--device", dev.type,
        "--workers", str(IMNET_W), "--tau", str(IMNET_TAU),
        "--train_batch", str(IMNET_BATCH), "--test_batch", str(IMNET_TEST_BATCH),
        "--full_size", str(IMNET_FULL), "--crop", str(IMNET_CROP),
        "--rounds", str(IMNET_ROUNDS), "--test_every", str(IMNET_TEST_EVERY),
        *extra])
    args.classes = 1000
    return args


def _imnet_partitions():
    """Seeded uint8 partitions, one per worker: tau + 1 train minibatches
    and one test minibatch each, 10 of AlexNet's 1,000 classes with a
    class-dependent channel shift (learnable, as the synthetic JPEG
    shards are), and the mean image over the train partitions."""
    from sparknet_tpu_torch.data import compute_mean, reduce_mean_sums

    rs = np.random.RandomState(0)

    def part(nb, batch):
        y = rs.randint(0, 10, (nb, batch)).astype(np.int32)
        x = rs.randint(0, 100, (nb, batch, 3, IMNET_FULL, IMNET_FULL)).astype(np.uint8)
        for c in range(3):
            x[:, :, c] += np.uint8(60) * (y % 3 == c)[..., None, None].astype(np.uint8)
        return x, y

    train = [part(IMNET_TAU + 1, IMNET_BATCH) for _ in range(IMNET_W)]
    test = [part(1, IMNET_TEST_BATCH) for _ in range(IMNET_W)]
    mean = reduce_mean_sums([compute_mean(zip(x, y), return_sum=True)
                             for x, y in train])
    return train, test, mean


class _env:
    """Set environment variables for a block; put the old values back."""

    def __init__(self, env):
        self.env = env

    def __enter__(self):
        self.prior = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Log:
    """The app's log, printed; keeps each round's smoothed loss."""

    def __init__(self):
        self.smoothed = []

    def log(self, msg, i=-1):
        m = re.search(r"smoothed_loss (\S+)", msg)
        if m:
            self.smoothed.append(float(m.group(1)))
        print(f"    {msg}" if i < 0 else f"    round {i}: {msg}")


def _imnet_first_round_matches_cpu(dev, parts, mean):
    """Round 0 of the default leg on the card and on the CPU from one
    init and one set of windows (the same crops and dropout masks: both
    drawn on the CPU from the same keys), once with one local step and
    once with ``IMNET_CPU_STEPS``: each parameter blob's difference
    relative to the largest entry of its update on the CPU.  The round
    also runs on the CPU in float64 (params, momentum and the transformed
    batch cast), the referee of the card's float32 and the CPU's.
    Returns ``{steps:
    (worst, the three worst blobs, max |loss diff|)}`` and ``{("float64",
    steps): (card, cpu)}``: each side's worst blob's distance from the
    float64 run relative to its update, with the other side's there."""
    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.data import MinibatchSampler, stack_windows
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
    from sparknet_tpu_torch.utils.tree import tree_map

    batch = stack_windows([
        MinibatchSampler({"data": x, "label": y.astype(np.float32)},
                         IMNET_TAU, seed=w).next_window()
        for w, (x, y) in enumerate(parts)])
    init, out = None, {}
    for steps in (1, IMNET_CPU_STEPS):
        runs = []
        for d, f64 in ((dev, False), (torch.device("cpu"), False),
                       (torch.device("cpu"), True)):
            solver = imagenet_app.build_solver(_imnet_args(d), mean, d)
            init = init if init is not None else solver.init_state(0)
            start = init
            if f64:
                cast = solver.train_transform
                solver.train_transform = lambda mb, key: {
                    k: v.double() if v.is_floating_point() else v
                    for k, v in cast(mb, key).items()}
                start = init._replace(
                    params=tree_map(lambda t: t.double(), init.params),
                    history=tree_map(lambda t: t.double(), init.history))
            tr = ParameterAveragingTrainer(solver, IMNET_W)
            st, losses = tr.round(tr.broadcast_state(start), {
                k: torch.from_numpy(v[:, :steps]).to(d) for k, v in batch.items()})
            runs.append((st.params, losses.cpu()))
        rel, vs64 = [], []
        for name, blobs in init.params.items():
            for i, p0 in enumerate(blobs):
                g, c = runs[0][0][name][i].cpu(), runs[1][0][name][i]
                size = max(float((c - p0.cpu()[None]).abs().max()), 1e-30)
                rel.append((float((g - c).abs().max()) / size, f"{name}[{i}]"))
                x = runs[2][0][name][i]
                vs64.append((float((g.double() - x).abs().max()) / size,
                             float((c.double() - x).abs().max()) / size,
                             f"{name}[{i}]"))
        rel.sort(reverse=True)
        out[steps] = (rel[0][0], rel[:3],
                      float((runs[0][1] - runs[1][1]).abs().max()))
        out["float64", steps] = (max(vs64), max(vs64, key=lambda r: r[1]))
    return out


def imagenet_train_end_to_end(dev, card):
    """``imagenet_app.train`` at AlexNet's full width, default, fused,
    int8, fp32+overlap and bf16+overlap legs (see the module doc, phase
    9); returns the legs' summed launches of K5-K11 (the drift control's
    left out)."""
    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.ops import cuda_plp as cp
    from sparknet_tpu_torch.parallel import LOSS_BAND

    try:
        import PIL  # noqa: F401  (the JPEG decode of the data stage)
        have_pil = True
    except ImportError:
        have_pil = False
    print(f"Pillow on this machine: {'yes' if have_pil else 'no'}")
    if have_pil:  # the data stage: JPEG shards, decode, mean, binaryproto
        result = {}
        rc = imagenet_app.main(
            ["--device", dev.type, "--workers", "2", "--tau", "2", "--rounds",
             "2", "--full_size", "72", "--crop", "67", "--train_batch", "4",
             "--test_batch", "4"], result)
        check(rc == 0 and bool(np.isfinite(result["losses"]).all()),
              "imagenet_app.main on synthesized JPEG shards failed")
        print(f"imagenet_app.main on JPEG shards (full 72, crop 67, W=2): "
              f"losses {result['losses'].mean(axis=(1, 2)).round(4).tolist()}")

    # the initial weights: the JAX package's threefry recipe, drawn on the host
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.net import TorchNet

    t0 = time.perf_counter()
    params, _ = TorchNet(models.load_model("alexnet"),
                         phase="TRAIN").init(0, torch.device("cpu"))
    n_params = sum(t.numel() for bs in params.values() for t in bs)
    print(f"AlexNet init from seed 0 (the JAX package's threefry recipe, drawn "
          f"on the host): {n_params} parameters in "
          f"{time.perf_counter() - t0:.3f} s")
    del params

    train_parts, test_parts, mean = _imnet_partitions()
    n_test = sum(len(x) for x, _ in test_parts)
    no_comm = dict.fromkeys(cc.LAUNCHES, 0)

    def lrn_launches(rounds, fused):
        n_tests = len(range(0, rounds, IMNET_TEST_EVERY)) + 1  # + the final
        steps = IMNET_W * IMNET_TAU * rounds
        if fused:
            return dict(NO_BF16, lrn_fwd=2 * n_tests * n_test, lrn_bwd=0,
                        lrn_pool_fwd=2 * steps, lrn_pool_bwd=2 * steps)
        return dict(NO_BF16, lrn_fwd=2 * steps + 2 * n_tests * n_test,
                    lrn_bwd=2 * steps, lrn_pool_fwd=0, lrn_pool_bwd=0)

    expect = {
        "default": {**lrn_launches(IMNET_ROUNDS, False), **no_comm},
        "fused": {**lrn_launches(IMNET_ROUNDS, True), **no_comm},
        # the comm chunks of AlexNet's parameters (parallel/comm.py): 3,
        # each one K9 and one K10 launch a round
        "int8": {**lrn_launches(IMNET_COMM_ROUNDS, False),
                 **dict(no_comm, comm_encode=3 * IMNET_COMM_ROUNDS,
                        comm_apply_barriered=3 * IMNET_COMM_ROUNDS)},
        # one K9 a chunk a round; one K11 a chunk for each round's average,
        # landed at the next round's start or, for the last, at finalize
        "bf16+overlap": {**lrn_launches(IMNET_COMM_ROUNDS, False),
                         **dict(no_comm, comm_encode=3 * IMNET_COMM_ROUNDS,
                                comm_apply_correction=3 * IMNET_COMM_ROUNDS)},
    }
    expect["fp32+overlap"] = expect["bf16+overlap"]
    expect["default, again"] = expect["default"]
    results, total, smoothed = {}, {}, {}
    # the default leg twice: the second run is the control, how far two
    # runs of the same program drift apart on this card
    for leg, fusion, extra in (
            ("default", "0", ()), ("default, again", "0", ()),
            ("fused", "1", ()),
            ("int8", "0", ("--compress", "int8",
                           "--rounds", str(IMNET_COMM_ROUNDS))),
            ("fp32+overlap", "0", ("--overlap_avg",
                                   "--rounds", str(IMNET_COMM_ROUNDS))),
            ("bf16+overlap", "0", ("--compress", "bf16", "--overlap_avg",
                                   "--rounds", str(IMNET_COMM_ROUNDS)))):
        with _env({"SPARKNET_FUSION": fusion}):
            result, log = {}, _Log()
            for mod in (cl, cp, cc):
                mod.reset_launch_counts()
            imagenet_app.train(_imnet_args(dev, extra), train_parts, test_parts,
                               mean, dev, log, result)
            torch.cuda.synchronize()
            launches = {**cl.LAUNCHES, **cp.LAUNCHES, **cc.LAUNCHES}
        losses = result["losses"]  # (rounds, W, tau)
        per_round = losses.mean(axis=(1, 2))
        smoothed[leg] = np.array(log.smoothed)
        print(f"AlexNet leg {leg}: launches {launches}, per-round mean loss "
              + " ".join(f"{x:.6f}" for x in per_round)
              + f", smoothed {smoothed[leg].tolist()}"
              + f", accuracies {[round(a, 4) for a in result['accuracies']]}")
        if leg in COMM_LEGS:
            n_chunks = len(result["trainer"]._comm.chunk_slices)
            check(n_chunks == 3, f"AlexNet {leg}: {n_chunks} comm chunks, not 3")
        check(launches == expect[leg],
              f"AlexNet leg {leg}: launches {launches}, expected {expect[leg]}")
        check(bool(np.isfinite(losses).all()), f"AlexNet leg {leg}: non-finite loss")
        first = float(losses[0, :, 0].mean())
        check(abs(first - np.log(1000)) < 0.05,
              f"AlexNet leg {leg}: first loss {first} not within 0.05 of ln 1000")
        check(per_round[-1] < per_round[0],
              f"AlexNet leg {leg}: loss did not fall ({per_round[0]} -> "
              f"{per_round[-1]})")
        rs = np.array(result["round_seconds"][1:])  # round 0 warms up
        imgs = IMNET_W * IMNET_TAU * IMNET_BATCH
        print(f"[{card}] AlexNet leg {leg}: {1.0 / rs.mean():.3f} rounds/s, "
              f"{imgs / rs.mean():.1f} images/s (mean of rounds 1..."
              f"{len(result['round_seconds']) - 1}: {rs.mean() * 1e3:.2f} ms, "
              f"min {rs.min() * 1e3:.2f} ms)")
        results[leg] = result
        if leg != "default, again":
            for name, v in launches.items():
                total[name] = total.get(name, 0) + v
    default = results["default"]["losses"].mean(axis=(1, 2))
    gaps = {leg: np.abs(results[leg]["losses"].mean(axis=(1, 2)) - default)
            / np.abs(default) for leg in ("default, again", "fused")}
    for leg, g in gaps.items():
        print(f"AlexNet {leg} vs default, per-round losses apart (relative): "
              + " ".join(f"{x:.3e}" for x in g))
    for leg in COMM_LEGS:
        check(len(smoothed[leg]) == IMNET_COMM_ROUNDS
              and bool(np.isfinite(smoothed[leg]).all()),
              f"AlexNet {leg}: smoothed losses {smoothed[leg]}")
        gap = np.abs(smoothed[leg] - smoothed["default"][:IMNET_COMM_ROUNDS])
        print(f"AlexNet {leg} vs default, smoothed losses at rounds 0.."
              f"{IMNET_COMM_ROUNDS - 1}: gaps {gap.tolist()}")
    for leg, base in LOSS_BAND_PAIRS:
        gap = np.abs(smoothed[leg] - smoothed[base][:IMNET_COMM_ROUNDS])
        print(f"AlexNet {leg} vs {base}, smoothed losses at rounds 0.."
              f"{IMNET_COMM_ROUNDS - 1}: gaps {gap.tolist()} (limit {LOSS_BAND})")
        check(float(gap.max()) <= LOSS_BAND,
              f"AlexNet {leg} leaves the loss band of {base}: {gap}")
    vs_cpu = _imnet_first_round_matches_cpu(dev, train_parts, mean)
    for steps in (1, IMNET_CPU_STEPS):
        worst, top, gap = vs_cpu[steps]
        print(f"AlexNet first round ({steps} local step(s)) on the card vs the "
              f"CPU: worst |diff| {worst:.3e} of the update, losses {gap:.3e}; "
              + ", ".join(f"{n} {r:.3e}" for r, n in top))
    for steps in (1, IMNET_CPU_STEPS):
        (card_gap, cpu_at, name), (cpu_card_at, cpu_gap, cpu_name) = \
            vs_cpu["float64", steps]
        print(f"AlexNet first round ({steps} local step(s)) against float64 on "
              f"the CPU, relative to the update: the card lies {card_gap:.3e} "
              f"away at its worst blob {name} (the CPU's float32 there "
              f"{cpu_at:.3e}); the CPU's float32 lies {cpu_gap:.3e} away at its "
              f"worst blob {cpu_name} (the card there {cpu_card_at:.3e})")
    for leg, fusion, compress, overlap in (("default", "0", "none", False),
                                           ("fused", "1", "none", False),
                                           ("int8", "0", "int8", False),
                                           ("bf16+overlap", "0", "bf16", True)):
        where_imnet_time_goes(dev, card, leg, fusion, compress, train_parts,
                              mean, overlap)
    for steps, limit in ((1, IMNET_CPU_TOL),
                         (IMNET_CPU_STEPS, IMNET_CPU_ROUND_TOL)):
        check(vs_cpu[steps][0] <= limit,
              f"AlexNet first round ({steps} steps) on the card vs the CPU: "
              f"{vs_cpu[steps][0]:.3e} of the update (limit {limit})")
    check(gaps["fused"][0] <= FUSED_LOSS_RTOL,
          f"fused and default round-0 losses differ by {gaps['fused'][0]}")
    check(gaps["fused"].max() <= FUSED_DRIFT_RTOL,
          f"fused and default losses drift apart by {gaps['fused'].max()}")
    return total


def where_imnet_time_goes(dev, card, leg, fusion, compress, parts, mean,
                          overlap=False, model="alexnet", env=None):
    """One round of an ImageNet leg under ``torch.profiler``: wall time,
    the device's busy share, the top kernels and K5-K11's share (the
    trainer with the app's metrics, so K9 computes its readout), and the
    round's peak device memory above what the process held before the
    solver was built (earlier legs' tensors still alive).  With
    ``overlap`` the round is a steady
    one: the previous round's average lands (K11) after its first local
    step.  ``env`` is set while the net is built (``SPARKNET_FUSION`` is
    ``fusion``).  Returns ``(wall ms, device busy ms, launches)``."""
    from torch.profiler import ProfilerActivity, profile

    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.data import MinibatchSampler, stack_windows
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer

    held = torch.cuda.memory_allocated(dev)
    with _env(dict(env or {}, SPARKNET_FUSION=fusion)):
        solver = imagenet_app.build_solver(
            _imnet_args(dev, model=model), mean, dev, _deep_solver(model))
    tr = ParameterAveragingTrainer(
        solver, IMNET_W, compress=compress, overlap_avg=overlap,
        metrics=None if compress == "none" else TrainingMetrics())
    st = tr.init_state(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in stack_windows([
        MinibatchSampler({"data": x, "label": y.astype(np.float32)},
                         IMNET_TAU, seed=w).next_window()
        for w, (x, y) in enumerate(parts)]).items()}
    st, _ = tr.round(st, batch)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    st, _ = tr.round(st, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) - held
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        st, _ = tr.round(st, batch)
        torch.cuda.synchronize()
    tr.finalize(st)  # joins an overlapped round's comm thread
    rows = _kernel_rows(prof)
    busy = sum(r[0] for r in rows)
    check(busy > 0, f"{model} round ({leg}): the profiler saw no device time")
    share = {tag: sum(r[0] for r in rows if re.search(kern, r[2]))
             for tag, kern in (("K5", "lrn_fwd_kernel"), ("K6", "lrn_bwd_kernel"),
                               ("K7", "lrn_pool_fwd_kernel"),
                               ("K8", "lrn_pool_bwd_kernel"),
                               ("K9", r"encode\w*_kernel"),
                               ("K10", "apply_barriered_kernel"),
                               ("K11", "apply_correction_kernel"))}
    n_kernels = sum(r[1] for r in rows)
    print(f"[{card}] {model} round ({leg}, W={IMNET_W}, tau={IMNET_TAU}, batch "
          f"{IMNET_BATCH}): {wall_ms:.3f} ms wall, {busy:.3f} ms device busy "
          f"({busy / wall_ms:.1%}), {n_kernels} kernel launches of {len(rows)} "
          f"kinds, peak memory {peak / 2**30:.3f} GiB (above the "
          f"{held / 2**30:.3f} GiB held before); "
          + ", ".join(f"{t} {ms:.4f} ms ({ms / busy:.1%})"
                      for t, ms in share.items()))
    for ms, count, key in rows[:10]:
        print(f"    {ms:.4f} ms ({ms / busy:.1%} of device, {count} launches)  "
              f"{key[:90]}")
    return wall_ms, busy, n_kernels


# ----------------------------------------------------------------------
# phase 10: weights and snapshots on the card — lm_app resume to the bit,
# the snapshot read on the CPU, serve --weights, cli train --resume, and
# what deterministic algorithms cost
# ----------------------------------------------------------------------
SNAP_ROUNDS, SNAP_EVERY = 4, 2  # lm_app legs: 4 rounds, a snapshot every 2
CLI_TRAIN_TAU, CLI_TRAIN_ITERS, CLI_TRAIN_SNAPSHOT = 10, 40, 20


def _same_bits(a, b, what) -> None:
    from sparknet_tpu_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    check(len(la) == len(lb), f"{what}: {len(la)} vs {len(lb)} leaves")
    for x, y in zip(la, lb):
        check(x.shape == y.shape and x.dtype == y.dtype
              and torch.equal(x.cpu(), y.cpu()), f"{what}: a leaf differs")


def _lm_snapshot_leg(dev, compress, root):
    """One lm_app leg: SNAP_ROUNDS rounds straight through, then the same
    run stopped after SNAP_EVERY rounds and resumed.  Returns the three
    runs' results (uninterrupted, stopped, resumed) and the resumed
    run's launches."""
    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.ops import cuda_comm as cc

    argv = list(_lm_argv(dev))
    argv[argv.index("--rounds") + 1] = str(SNAP_ROUNDS)
    argv += ["--compress", compress, "--snapshot_every", str(SNAP_EVERY)]
    pa, pb = f"{root}/{compress}/a/lm", f"{root}/{compress}/b/lm"
    ra, rb, rc = {}, {}, {}
    check(lm_app.main(argv + ["--snapshot_prefix", pa], ra) == 0,
          f"lm_app {compress}: the uninterrupted run failed")
    stop = list(argv)
    stop[stop.index("--rounds") + 1] = str(SNAP_EVERY)
    check(lm_app.main(stop + ["--snapshot_prefix", pb], rb) == 0,
          f"lm_app {compress}: the stopped run failed")
    ca.reset_launch_counts()
    cc.reset_launch_counts()
    check(lm_app.main(argv + ["--snapshot_prefix", pb, "--resume"], rc) == 0,
          f"lm_app {compress}: the resumed run failed")
    torch.cuda.synchronize()
    launches = {**ca.LAUNCHES, **cc.LAUNCHES}
    return ra, rb, rc, launches


def lm_snapshot_end_to_end(dev, card, root):
    """lm_app at the serving width, W=2, tau 4, batch 8: per leg (no
    compression, ``--compress int8``) SNAP_ROUNDS rounds straight through
    vs SNAP_EVERY rounds, then ``--resume`` to SNAP_ROUNDS — params,
    momentum stacks, comm residuals and every smoothed loss equal bit
    for bit, K1/K3/K4 (and K9/K10 in the int8 leg) launched in the
    resumed run.  Then the uninterrupted leg's last snapshot, restored
    by a CPU solver, equals the card's state bit for bit.  Returns the
    resumed runs' launches and the snapshot's model file."""
    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.parallel import first_worker

    n = LM_MODEL["depth"] * LM_W * LM_TAU * (SNAP_ROUNDS - SNAP_EVERY)
    total, model_path = {}, None
    for compress in ("none", "int8"):
        t0 = time.perf_counter()
        ra, rb, rc, launches = _lm_snapshot_leg(dev, compress, root)
        wall = time.perf_counter() - t0
        check(rc["start_round"] == SNAP_EVERY,
              f"lm_app {compress}: resumed at round {rc['start_round']}")
        _same_bits(ra["state"], rc["state"], f"lm_app {compress}: final state")
        smoothed = rb["smoothed"] + rc["smoothed"]
        check(ra["smoothed"] == smoothed,
              f"lm_app {compress}: smoothed losses {ra['smoothed']} vs {smoothed}")
        check(np.array_equal(ra["losses"],
                             np.concatenate([rb["losses"], rc["losses"]])),
              f"lm_app {compress}: per-iteration losses differ")
        ea = ra["trainer"].export_comm_state()
        ec = rc["trainer"].export_comm_state()
        check((ea is None) == (ec is None) == (compress == "none"),
              f"lm_app {compress}: comm state {ea is None} / {ec is None}")
        if ea is not None:
            check(all(np.array_equal(ea["resid"][k], ec["resid"][k])
                      for k in ea["resid"]),
                  f"lm_app {compress}: comm residuals differ")
        chunks = len(rc["trainer"]._comm.chunk_slices) if ea is not None else 0
        k9 = chunks * (SNAP_ROUNDS - SNAP_EVERY)
        want = dict(flash_fwd=n, flash_bwd_dq=n, flash_bwd_dkv=n,
                    comm_encode=k9, comm_apply_barriered=k9)
        got = {k: launches[k] for k in want}
        print(f"lm_app resume leg {compress} ({SNAP_ROUNDS} rounds vs "
              f"{SNAP_EVERY} + --resume, snapshots every {SNAP_EVERY}; "
              f"{wall:.2f} s for the three runs): final params, momentum "
              f"stacks{', comm residuals' if ea else ''} and the smoothed "
              f"losses {[round(x, 6) for x in smoothed]} equal bit for bit; "
              f"resumed run's launches {got}")
        check(got == want, f"lm_app {compress}: resumed launches {got}, "
              f"expected {want}")
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "comm_encode",
                  "comm_apply_barriered"):
            total[k] = total.get(k, 0) + launches[k]
        if compress == "none":
            # the card's snapshot, read by a CPU solver
            snap = ra["snapshots"][-1]
            model_path = snap.replace(".solverstate.npz", ".caffemodel")
            args = lm_app._parser().parse_args(_lm_argv(torch.device("cpu")))
            _, cpu_solver = lm_app.build_lm_solver(args, torch.device("cpu"))
            restored = checkpoint.restore(cpu_solver, snap)
            card_state = first_worker(ra["state"])
            _same_bits(restored, card_state, "card snapshot restored on the CPU")
            print(f"{snap.rsplit('/', 1)[-1]}: restored by a CPU solver, equal "
                  f"bit for bit to the card's worker-0 state "
                  f"(iter {int(restored.iter)})")
    return total, model_path


def serve_weights_end_to_end(dev, card, model_path, seeded_tokens):
    """``cli serve --generate --weights`` at the CLI model on the lm_app
    snapshot's model file: phase 3's 4 streams and checks against a CPU
    engine loaded from the same file, the tokens unlike the seeded
    engine's.  Returns the launches."""
    out = {}
    launches = serve_end_to_end(dev, card, weights=model_path, out=out)
    check(out["tokens"] != seeded_tokens,
          "serve --weights streamed the seeded init's tokens")
    check(launches["flash_fwd"] > 0 and launches["decode_attention"] > 0,
          f"serve --weights: launches {launches}")
    print(f"serve --weights {model_path.rsplit('/', 1)[-1]}: tokens differ from "
          f"the seeded engine's in {sum(a != b for a, b in zip(out['tokens'], seeded_tokens))}"
          f" of {len(seeded_tokens)} streams")
    return launches


def _cifar_solver_file(root, cifar_dir):
    from sparknet_tpu_torch.models import ZOO_DIR

    path = f"{root}/cifar10_full_solver.prototxt"
    net = os.path.join(ZOO_DIR, "cifar10_full_train_test.prototxt")
    with open(path, "w") as f:
        f.write(f'net: "{net}"\nbase_lr: 0.001\n'
                'momentum: 0.9\nweight_decay: 0.004\nlr_policy: "fixed"\n'
                f'display: {CLI_TRAIN_TAU}\nsnapshot: {CLI_TRAIN_SNAPSHOT}\n'
                f'snapshot_prefix: "{root}/cli/cifar10_full"\n')
    return path


def cli_train_end_to_end(dev, card, root):
    """``cli train --solver`` on cifar10_full (batch 100) and synthesized
    CIFAR binaries, tau 10: CLI_TRAIN_ITERS iterations straight through
    vs CLI_TRAIN_SNAPSHOT, then ``--resume`` — the final states equal
    bit for bit."""
    from sparknet_tpu_torch.data import CifarLoader
    from sparknet_tpu_torch.tools import cli

    cifar = f"{root}/cifar"
    CifarLoader.write_synthetic(cifar, num_train=5000, num_test=1000)
    solver = _cifar_solver_file(root, cifar)
    base = ["train", f"--solver={solver}", f"--data={cifar}",
            f"--tau={CLI_TRAIN_TAU}", f"--device={dev.type}"]
    ra, rc = {}, {}
    t0 = time.perf_counter()
    check(cli.main(base + [f"--max_iter={CLI_TRAIN_ITERS}"], ra) == 0,
          "cli train: the uninterrupted run failed")
    wall = time.perf_counter() - t0
    shutil.rmtree(f"{root}/cli")
    check(cli.main(base + [f"--max_iter={CLI_TRAIN_SNAPSHOT}"]) == 0,
          "cli train: the stopped run failed")
    check(cli.main(base + [f"--max_iter={CLI_TRAIN_ITERS}", "--resume"],
                   rc) == 0, "cli train: the resumed run failed")
    _same_bits(ra["state"], rc["state"], "cli train --resume: final state")
    check(ra["smoothed_loss"] == rc["smoothed_loss"]
          and np.isfinite(ra["smoothed_loss"]),
          f"cli train smoothed loss {ra['smoothed_loss']} vs {rc['smoothed_loss']}")
    print(f"[{card}] cli train --solver cifar10_full (batch 100, tau "
          f"{CLI_TRAIN_TAU}): {CLI_TRAIN_ITERS} iterations in {wall:.2f} s "
          f"straight through; {CLI_TRAIN_SNAPSHOT} + --resume to "
          f"{CLI_TRAIN_ITERS} ends bit-identical (smoothed loss "
          f"{ra['smoothed_loss']:.6f})")


def _kernel_rows(prof):
    """``[(device ms, launches, name)]`` of each kind of device work in a
    CUDA-only profile, the costliest first: no CPU op is recorded, so
    the profile parses a fraction of the events a CPU+CUDA one would."""
    from torch.autograd import DeviceType

    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by.get(e.name, (0.0, 0))
            by[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return sorted(((ms, n, k) for k, (ms, n) in by.items() if ms > 0),
                  reverse=True)


def _timed(fn, card, what):
    """(wall ms, device-busy ms, {kernel: device ms}) of one call: a warm
    call, a timed call, a profiled call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {k: ms for ms, _, k in _kernel_rows(prof)}
    busy = sum(rows.values())
    check(busy > 0, f"{what}: the profiler saw no device time")
    return wall, busy, rows


def determinism_cost(dev, card, root, db_round=None):
    """One LM round (the lm_app legs' trainer), one cli train window
    (cifar10_full, tau 10, batch 100) and, given ``db_round``, one
    CaffeNet DB round (phase 11) with deterministic algorithms on and
    then off, each warm: wall and device-busy time."""
    from sparknet_tpu_torch import config
    from sparknet_tpu_torch.data import CifarLoader
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms

    _, tr = _lm_trainer(dev)
    lm_state = [tr.init_state(0)]
    lm_batch = {k: torch.from_numpy(v).to(dev) for k, v in _lm_batch(0).items()}

    def lm_round():
        lm_state[0], _ = tr.round(lm_state[0], lm_batch)

    solver = Solver(config.load_solver_prototxt(
        _cifar_solver_file(root, f"{root}/cifar")), device=dev)
    x, y = CifarLoader(f"{root}/cifar").minibatches(100)
    window = {"data": torch.from_numpy(x[:CLI_TRAIN_TAU]).to(dev),
              "label": torch.from_numpy(y[:CLI_TRAIN_TAU]).to(dev)}
    cifar_state = [solver.init_state(0)]

    def cli_window():
        cifar_state[0], _ = solver.step(cifar_state[0], window)

    programs = [("LM round", lm_round), ("cli train window", cli_window)]
    if db_round is not None:
        programs.append(("CaffeNet DB round", db_round))
    rows = {}
    for on in (True, False):
        with deterministic_algorithms(on):
            for what, fn in programs:
                rows.setdefault((what, on), []).append(_timed(fn, card, what))
    print(card)
    for what, _ in programs:
        det, nondet = rows[(what, True)], rows[(what, False)]
        fmt = lambda r: ", ".join(f"{w:.3f} ms wall / {b:.3f} ms device"
                                  for w, b, _ in r)
        print(f"[{card}] determinism cost, {what}: deterministic {fmt(det)}; "
              f"default {fmt(nondet)}")
        on, off = det[-1][2], nondet[-1][2]
        grew = sorted(((on.get(k, 0.0) - off.get(k, 0.0), k)
                       for k in set(on) | set(off)), reverse=True)
        for d, k in grew[:4]:
            print(f"    {d:+.4f} ms deterministic ({on.get(k, 0.0):.4f} vs "
                  f"{off.get(k, 0.0):.4f})  {k[:90]}")


# ----------------------------------------------------------------------
# phase 11: the two-phase ImageNet DB path — CaffeNet from record DBs,
# warm-started and resumed to the bit, the snapshot read on the CPU,
# cli test on an LMDB, and where a DB round's time goes
# ----------------------------------------------------------------------
DB_W, DB_TAU, DB_BATCH, DB_TEST_BATCH = 2, 4, 32, 16
DB_FULL, DB_CROP, DB_CLASSES = 256, 227, 1000
DB_ROUNDS, DB_SNAP_EVERY, DB_TEST_EVERY = 4, 2, 2
# train batches a worker's shard holds: 4 rounds read 16, so each
# shard wraps; the val shards hold 2 and 1 batches (padded and masked)
DB_TRAIN_BATCHES, DB_VAL_BATCHES = 10, (2, 1)
# cli test on the card vs the CPU, relative: float32 through AlexNet's
# eight layers, summed in other orders
CLI_TEST_RTOL = 1e-4
CLI_TEST_BATCH, CLI_TEST_ITERS = 50, 2  # the zoo AlexNet's TEST batch


def _write_db_dir(root):
    """The files ``imagenet_create_db_app`` writes, from seeded uint8
    arrays made with numpy (JPEG shards need Pillow): per-worker train
    and val record DBs with 2-byte labels (1,000 classes), the infoFile
    and the mean image, through the app's own ``write_dbs``."""
    from sparknet_tpu_torch.apps import imagenet_create_db_app

    rs = np.random.RandomState(1)

    def part(nb, batch):
        y = rs.randint(0, DB_CLASSES, (nb, batch)).astype(np.int32)
        x = rs.randint(0, 100, (nb, batch, 3, DB_FULL, DB_FULL)).astype(np.uint8)
        for c in range(3):  # a class-dependent channel shift, learnable
            x[:, :, c] += np.uint8(60) * (y % 3 == c)[..., None, None].astype(np.uint8)
        return x, y

    train = [part(DB_TRAIN_BATCHES, DB_BATCH) for _ in range(DB_W)]
    val = [part(nb, DB_TEST_BATCH) for nb in DB_VAL_BATCHES]
    os.makedirs(root, exist_ok=True)
    imagenet_create_db_app.write_dbs(root, train, val, {
        "workers": DB_W, "full_size": DB_FULL, "classes": DB_CLASSES,
        "train_batch": DB_BATCH, "test_batch": DB_TEST_BATCH}, _Log())


def _db_argv(dev, db_dir, prefix, rounds, *extra):
    return ["--db_dir", db_dir, "--model", "caffenet", "--device", dev.type,
            "--tau", str(DB_TAU), "--rounds", str(rounds), "--test_every",
            str(DB_TEST_EVERY), "--snapshot_every", str(DB_SNAP_EVERY),
            "--snapshot_prefix", prefix, "--seed", "0", *extra]


def _db_leg(dev, db_dir, root, compress, warm):
    """One resume pair: DB_ROUNDS rounds straight through, then the same
    run stopped after DB_SNAP_EVERY and resumed to DB_ROUNDS.  Returns
    the three runs' results, the resumed run's launches and the three
    runs' wall seconds."""
    from sparknet_tpu_torch.apps import imagenet_run_db_app
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.ops import cuda_plp as cp

    c = ("--compress", compress)
    pa, pb = f"{root}/{compress}/a/caffenet", f"{root}/{compress}/b/caffenet"
    ra, rb, rc = {}, {}, {}
    t0 = time.perf_counter()
    check(imagenet_run_db_app.main(_db_argv(dev, db_dir, pa, DB_ROUNDS, *c,
                                            "--warm_start", warm), ra) == 0,
          f"imagenet_run_db {compress}: the uninterrupted run failed")
    check(imagenet_run_db_app.main(_db_argv(dev, db_dir, pb, DB_SNAP_EVERY, *c,
                                            "--warm_start", warm), rb) == 0,
          f"imagenet_run_db {compress}: the stopped run failed")
    for mod in (cl, cp, cc):
        mod.reset_launch_counts()
    check(imagenet_run_db_app.main(_db_argv(
        dev, db_dir, pb, DB_ROUNDS - DB_SNAP_EVERY, *c, "--resume"), rc) == 0,
          f"imagenet_run_db {compress}: the resumed run failed")
    torch.cuda.synchronize()
    launches = {**cl.LAUNCHES, **cp.LAUNCHES, **cc.LAUNCHES}
    return ra, rb, rc, launches, time.perf_counter() - t0


def _reader_rates(db_dir, card, round_s):
    """Records/s of the native reader (default thread count) and the
    Python reader over one round's records, from opening the app's W
    pipes to their tau-th batch (pulled in turn, as the feed pulls them),
    beside what a round consumes."""
    import json as _json

    from sparknet_tpu_torch.apps import imagenet_run_db_app

    with open(f"{db_dir}/imagenet_db_info.json") as f:
        info = _json.load(f)
    n = DB_W * DB_TAU * DB_BATCH
    rates = {}
    for native in (True, False):
        pipes, tests = imagenet_run_db_app.open_pipes(
            db_dir, info, DB_CROP, True, 0, native=native)
        try:
            for p in tests:
                p.close()
            t0 = time.perf_counter()
            for p in pipes:
                for _ in range(DB_TAU):
                    p.next()
            rates["native" if native else "python"] = \
                n / (time.perf_counter() - t0)
        finally:
            for p in pipes + tests:
                p.close()
    need = n / round_s
    print(f"[{card}] the reader over one round ({n} records of 3x{DB_FULL}"
          f"x{DB_FULL} cropped to {DB_CROP}, float, mirror, full mean): native "
          f"({os.cpu_count()} cores, {max(1, (os.cpu_count() or 2) - 1)} "
          f"transform threads) {rates['native']:.1f} records/s, Python "
          f"{rates['python']:.1f} records/s; a round consumes {need:.1f} "
          f"records/s ({round_s * 1e3:.2f} ms a round)")


def db_round_program(dev, db_dir):
    """One CaffeNet DB round as a repeatable call: the app's solver and
    trainer (W workers, no compression) on one round's batch from the
    app's own pipes.  Returns the round function."""
    import json as _json

    from sparknet_tpu_torch.apps import imagenet_run_db_app
    from sparknet_tpu_torch.data import stack_windows
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer

    with open(f"{db_dir}/imagenet_db_info.json") as f:
        info = _json.load(f)
    solver = imagenet_run_db_app.build_solver("caffenet", info, DB_CROP, dev)
    tr = ParameterAveragingTrainer(solver, DB_W)
    pipes, tests = imagenet_run_db_app.open_pipes(db_dir, info, DB_CROP, True, 0)
    try:
        windows = []
        for p in pipes:
            bs = [p.next() for _ in range(DB_TAU)]
            windows.append({"data": np.stack([b[0] for b in bs]),
                            "label": np.stack([b[1] for b in bs])})
    finally:
        for p in pipes + tests:
            p.close()
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stack_windows(windows).items()}
    state = [tr.init_state(0)]

    def run():
        state[0], _ = tr.round(state[0], batch)

    return run


def where_db_time_goes(dev, card, run):
    """One CaffeNet DB round under ``torch.profiler``, with deterministic
    algorithms as the app trains: wall, device busy share, launches, K5
    and K6's share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sparknet_tpu_torch.utils.devices import deterministic_algorithms

    with deterministic_algorithms():
        run()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    check(busy > 0, "CaffeNet DB round: the profiler saw no device time")
    share = {tag: sum(r[0] for r in rows if re.search(kern, r[2]))
             for tag, kern in (("K5", "lrn_fwd_kernel"),
                               ("K6", "lrn_bwd_kernel"))}
    n_kernels = sum(r[1] for r in rows)
    print(f"[{card}] CaffeNet DB round (W={DB_W}, tau={DB_TAU}, batch "
          f"{DB_BATCH}, deterministic): {wall_ms:.3f} ms wall, {busy:.3f} ms "
          f"device busy ({busy / wall_ms:.1%}), {n_kernels} kernel launches of "
          f"{len(rows)} kinds; " + ", ".join(
              f"{t} {ms:.4f} ms ({ms / busy:.1%})" for t, ms in share.items()))
    for ms, count, key in rows[:10]:
        print(f"    {ms:.4f} ms ({ms / busy:.1%} of device, {count} launches)  "
              f"{key[:90]}")


def cli_test_end_to_end(dev, card, root, weights):
    """``cli test`` with the zoo AlexNet prototxt (its TEST batch 50) on
    an LMDB written by the port at the net's input size, with CaffeNet's
    snapshot as weights (the same parameter shapes): on the card and with
    ``--device cpu``, scores within CLI_TEST_RTOL; K5 launched twice a
    batch on the card.  Returns the card run's launches."""
    from sparknet_tpu_torch.io import lmdb
    from sparknet_tpu_torch.models import ZOO_DIR
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.tools import cli

    n = CLI_TEST_BATCH * CLI_TEST_ITERS
    rs = np.random.RandomState(2)
    src = f"{root}/val_lmdb"
    lmdb.write_datum_lmdb(
        src, rs.randint(0, 256, (n, 3, DB_CROP, DB_CROP)).astype(np.uint8),
        rs.randint(0, DB_CLASSES, n))
    argv = ["test", "--model", os.path.join(ZOO_DIR, "alexnet_train_val.prototxt"),
            "--weights", weights, "--data", src, "--iterations",
            str(CLI_TEST_ITERS)]
    cpu, card_res = {}, {}
    check(cli.main(argv + ["--device", "cpu"], cpu) == 0, "cli test on the CPU")
    cl.reset_launch_counts()
    t0 = time.perf_counter()
    check(cli.main(argv + ["--device", dev.type], card_res) == 0,
          "cli test on the card")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cl.LAUNCHES)
    gaps = {k: abs(card_res["scores"][k] - cpu["scores"][k])
            / max(abs(cpu["scores"][k]), 1e-12) for k in cpu["scores"]}
    print(f"[{card}] cli test (zoo AlexNet, CaffeNet's snapshot, {n} LMDB "
          f"records): {wall:.2f} s on the card; scores card "
          f"{card_res['scores']} vs CPU {cpu['scores']}, relative gaps {gaps}; "
          f"launches {launches}")
    check(set(cpu["scores"]) == {"accuracy", "loss"}
          and max(gaps.values()) <= CLI_TEST_RTOL,
          f"cli test: the card's scores leave {CLI_TEST_RTOL} of the CPU's: {gaps}")
    check(launches["lrn_fwd"] == 2 * CLI_TEST_ITERS and launches["lrn_bwd"] == 0,
          f"cli test: launches {launches}")
    return launches


def db_end_to_end(dev, card, root):
    """Phase 11 (see the module doc).  Returns the launches of the
    resumed runs and of cli test, and the CaffeNet round for
    ``determinism_cost``."""
    import json as _json

    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.apps import imagenet_create_db_app
    from sparknet_tpu_torch.io import caffemodel, checkpoint
    from sparknet_tpu_torch.net import TorchNet
    from sparknet_tpu_torch.parallel import first_worker
    from sparknet_tpu_torch.utils.devices import resolve_device

    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    if have_pil:  # the create-DB app on synthesized JPEG shards
        small = f"{root}/db_small"
        check(imagenet_create_db_app.main(["--out", small, "--workers", "2"])
              == 0, "imagenet_create_db_app.main failed")
        with open(f"{small}/imagenet_db_info.json") as f:
            info = _json.load(f)
        print(f"imagenet_create_db_app.main on JPEG shards: {info}")
    t0 = time.perf_counter()
    db_dir = f"{root}/db"
    _write_db_dir(db_dir)
    print(f"record DBs written in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{n} {os.path.getsize(f'{db_dir}/{n}')} B"
                      for n in sorted(os.listdir(db_dir))))
    # the warm start: a seeded CaffeNet's .caffemodel
    cpu = resolve_device("cpu")
    net = TorchNet(models.load_model("caffenet", classes=DB_CLASSES,
                                     image=DB_CROP), "TRAIN")
    params, stats = net.init(1, cpu)
    warm = f"{root}/caffenet_seed1.caffemodel"
    caffemodel.save_weights(caffemodel.net_blobs(net, params, stats), warm)
    del params, stats

    # the comm chunks of CaffeNet's parameters: 3, each one K9 and one
    # K10 launch a round; the resumed runs train rounds 2 and 3 and test
    # at round 2 and at the end (3 test batches each time, both LRNs)
    resumed_rounds = DB_ROUNDS - DB_SNAP_EVERY
    steps = DB_W * DB_TAU * resumed_rounds
    n_tests = len([r for r in range(DB_SNAP_EVERY, DB_ROUNDS)
                   if r % DB_TEST_EVERY == 0]) + 1
    lrn = dict(NO_BF16, lrn_fwd=2 * steps + 2 * n_tests * sum(DB_VAL_BATCHES),
               lrn_bwd=2 * steps, lrn_pool_fwd=0, lrn_pool_bwd=0)
    total, walls = {}, {}
    for compress in ("none", "int8"):
        ra, rb, rc, launches, wall = _db_leg(dev, db_dir, root, compress, warm)
        check(rc["start_round"] == DB_SNAP_EVERY,
              f"imagenet_run_db {compress}: resumed at round {rc['start_round']}")
        _same_bits(ra["state"], rc["state"],
                   f"imagenet_run_db {compress}: final state")
        smoothed = rb["smoothed"] + rc["smoothed"]
        check(ra["smoothed"] == smoothed,
              f"imagenet_run_db {compress}: smoothed {ra['smoothed']} vs "
              f"{smoothed}")
        check(np.array_equal(ra["losses"],
                             np.concatenate([rb["losses"], rc["losses"]])),
              f"imagenet_run_db {compress}: per-iteration losses differ")
        check(ra["accuracies"][-1] == rc["accuracies"][-1],
              f"imagenet_run_db {compress}: final accuracy "
              f"{ra['accuracies'][-1]} vs {rc['accuracies'][-1]}")
        ea = ra["trainer"].export_comm_state()
        ec = rc["trainer"].export_comm_state()
        check((ea is None) == (ec is None) == (compress == "none"),
              f"imagenet_run_db {compress}: comm state")
        if ea is not None:
            check(all(np.array_equal(ea["resid"][k], ec["resid"][k])
                      for k in ea["resid"]),
                  f"imagenet_run_db {compress}: comm residuals differ")
        chunks = len(rc["trainer"]._comm.chunk_slices) if ea is not None else 0
        check(compress == "none" or chunks == 3,
              f"imagenet_run_db {compress}: {chunks} comm chunks, not 3")
        want = dict(lrn, comm_encode=chunks * resumed_rounds,
                    comm_apply_barriered=chunks * resumed_rounds,
                    comm_apply_correction=0)
        losses = ra["losses"].mean(axis=(1, 2))
        rs_ = np.array(ra["round_seconds"][1:])
        walls[compress] = float(rs_.mean())
        print(f"[{card}] imagenet_run_db CaffeNet leg {compress} ({DB_ROUNDS} "
              f"rounds vs {DB_SNAP_EVERY} + --resume, warm start, snapshots "
              f"every {DB_SNAP_EVERY}; {wall:.2f} s for the three runs): final "
              f"params, momentum stacks{', comm residuals' if ea else ''}, "
              f"every loss and the final accuracy "
              f"({ra['accuracies'][-1] * 100:.2f}%) equal bit for bit; smoothed "
              f"{[round(x, 6) for x in smoothed]}; per-round mean loss "
              + " ".join(f"{x:.6f}" for x in losses)
              + f"; rounds 1..{DB_ROUNDS - 1} {rs_.mean() * 1e3:.2f} ms each; "
              f"resumed run's launches {launches}")
        check(launches == want,
              f"imagenet_run_db {compress}: resumed launches {launches}, "
              f"expected {want}")
        check(bool(np.isfinite(ra["losses"]).all()),
              f"imagenet_run_db {compress}: non-finite loss")
        for name, v in launches.items():
            total[name] = total.get(name, 0) + v
        if compress == "none":
            # the card's last snapshot, read by a CPU solver
            from sparknet_tpu_torch.apps import imagenet_run_db_app

            snap = ra["snapshots"][-1]
            model_path = snap.replace(".solverstate.npz", ".caffemodel")
            with open(f"{db_dir}/imagenet_db_info.json") as f:
                info = _json.load(f)
            cpu_solver = imagenet_run_db_app.build_solver("caffenet", info,
                                                          DB_CROP, cpu)
            restored = checkpoint.restore(cpu_solver, snap)
            _same_bits(restored, first_worker(ra["state"]),
                       "CaffeNet snapshot restored on the CPU")
            print(f"{snap.rsplit('/', 1)[-1]}: restored by a CPU solver, equal "
                  f"bit for bit to the card's worker-0 state (iter "
                  f"{int(restored.iter)})")
            del cpu_solver, restored
    for name, v in cli_test_end_to_end(dev, card, root, model_path).items():
        total[name] = total.get(name, 0) + v
    _reader_rates(db_dir, card, walls["none"])
    run = db_round_program(dev, db_dir)
    where_db_time_goes(dev, card, run)
    return total, run


# ----------------------------------------------------------------------
# phase 12: the deep nets on the main loop — GoogLeNet and ResNet-50
# through imagenet_app's training function at full width
# ----------------------------------------------------------------------
DEEP_ROUNDS = 3  # testing at rounds 0 and 2 and after the last
DEEP_COMM_ROUNDS = 2  # the overlapped legs
DEEP_CPU_BATCH = 8  # the first local step on the card vs the CPU
# GoogLeNet's first step in float32 on the card vs the CPU, of each
# blob's update (2.7e-3 measured on the H100)
DEEP_CPU_TOL = 1e-2
# ResNet-50's first step in float64 on the card vs the CPU, of each
# blob's update: in float32 BatchNorm over 8 x 7 x 7 values a channel at
# res5 (its biased E[x^2] - mean^2) puts any float32 run, the CPU's too,
# ~0.16 of an update from float64, so the card is held in float64
DEEP_F64_TOL = 1e-6
# the first step's losses on the card vs the CPU, relative: float32
# measured 9.1e-7 (ResNet-50) and 6.5e-8 (GoogLeNet) on the H100, ten
# times that as the limit; float64 to its own rounding
DEEP_LOSS_RTOL = 1e-5
DEEP_F64_LOSS_RTOL = 1e-12
# GoogLeNet's first loss at init, from the CPU's: loss3 7.19 plus 0.3 x
# the aux heads' 15.6 and 7.85 (the xavier-filled heads start far from
# ln 1000), within 15% (the card measured 14.79 with dropout on)
GOOGLENET_FIRST_LOSS = 7.19 + 0.3 * (15.6 + 7.85)
GOOGLENET_FIRST_LOSS_RTOL = 0.15
HFUSE_LOSS_RTOL = 1e-4
# ResNet-50's zoo solver starts at lr 0.1, its recipe's rate for batch
# 256 (GoogLeNet's recipe batch is 32, as here).  At the cut batch of 32,
# from scratch and without warm-up, the card measured (4 rounds, the
# worker-mean loss of each iteration): 0.1 climbs to ~100 in round 0;
# 0.0125 (0.1 scaled by 32/256) falls to 3.3 by the third iteration, then
# climbs to 12-19; 0.005 falls to ~2.0, but the int8 leg's round-end loss
# lies 0.11-0.44 from the fp32 leg's after round 1 (LOSS_BAND 0.08);
# 0.002 falls 7.53 -> ~2.4, int8 within 0.03-0.05 of fp32 through
# round 2 (PERF.md §6).
DEEP_LR = {"resnet50": 0.002}
# (model, leg, environment, extra app flags, rounds, deterministic
# algorithms).  Every leg but the last two trains under
# deterministic_algorithms(): with cuDNN's defaults two runs of
# ResNet-50's default leg drift ~0.1 apart in loss by round 2 on the card
# (BatchNorm over a batch of 32 amplifies rounding), so a compressed
# leg's gap would measure that drift.  The last two are the int8 /
# default pair under the app's own settings (torch's defaults): their gap
# is printed, not banded.
DEEP_LEGS = (
    ("googlenet", "default", {"SPARKNET_FUSION": "0"}, (), DEEP_ROUNDS, True),
    ("googlenet", "fused", {"SPARKNET_FUSION": "1"}, (), DEEP_ROUNDS, True),
    ("googlenet", "hconv off", {"SPARKNET_FUSION": "0", "SPARKNET_HFUSE": "0"},
     (), 1, True),
    ("resnet50", "default", {}, (), DEEP_ROUNDS, True),
    ("resnet50", "default, again", {}, (), DEEP_ROUNDS, True),
    ("resnet50", "int8", {}, ("--compress", "int8"), DEEP_ROUNDS, True),
    ("resnet50", "fp32+overlap", {}, ("--overlap_avg",), DEEP_COMM_ROUNDS,
     True),
    ("resnet50", "bf16+overlap", {}, ("--compress", "bf16", "--overlap_avg"),
     DEEP_COMM_ROUNDS, True),
    ("resnet50", "default, app settings", {}, (), DEEP_ROUNDS, False),
    ("resnet50", "int8, app settings", {}, ("--compress", "int8"),
     DEEP_ROUNDS, False),
)


def _deep_solver(model):
    """The model's zoo solver, at DEEP_LR's rate where it names one."""
    from sparknet_tpu_torch import models

    param = models.load_model_solver(model)
    if model in DEEP_LR:
        param.base_lr = DEEP_LR[model]
    return param


def _deep_launches(model, leg, rounds, n_test, groups):
    """The K5-K11 launches of one phase-12 leg: GoogLeNet's two LRNs run
    K5/K6 on every training step and K5 on every test batch (the TEST net
    is never fused); under SPARKNET_FUSION=1 conv2/norm2 -> pool2 (57x57,
    odd) runs K7/K8 instead.  ResNet-50 has no LRN; its comm legs launch
    K9 and K10 (int8) or K9 and K11 (the overlapped legs, the last K11 at
    finalize) once per leaf group of at most 32 a round."""
    launches = dict.fromkeys(("lrn_fwd", "lrn_bwd", "lrn_pool_fwd",
                              "lrn_pool_bwd", "comm_encode",
                              "comm_apply_barriered", "comm_apply_correction",
                              *NO_BF16), 0)
    steps = IMNET_W * IMNET_TAU * rounds
    n_tests = len(range(0, rounds, IMNET_TEST_EVERY)) + 1
    if model == "googlenet":
        fused = steps if leg == "fused" else 0
        launches.update(lrn_fwd=2 * steps - fused + 2 * n_tests * n_test,
                        lrn_bwd=2 * steps - fused, lrn_pool_fwd=fused,
                        lrn_pool_bwd=fused)
    elif leg.startswith("int8"):
        launches.update(comm_encode=groups * rounds,
                        comm_apply_barriered=groups * rounds)
    elif "overlap" in leg:
        launches.update(comm_encode=groups * rounds,
                        comm_apply_correction=groups * rounds)
    return launches


def _deep_first_step_matches_cpu(dev, model, parts, mean):
    """One local step of round 0 at batch DEEP_CPU_BATCH (the first
    images of each partition) on the card, on the CPU, and on the CPU in
    float64 (params, stats, momentum and the transformed batch cast), from
    one init and the same crops, mirrors and dropout masks; ResNet-50
    (no LRN, whose kernels take float32 only) also on the card in
    float64.  Each parameter blob's difference is taken relative to the
    largest entry of its update on the CPU.  Returns ``{"card_cpu":
    (worst, the three worst), "card_f64": (worst, blob), "cpu_f64":
    (worst, blob), "loss": max |loss diff| relative}``, and for ResNet-50
    ``"f64": (worst, the three worst)`` and ``"loss_f64"``: the card's
    float64 run against the CPU's."""
    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.data import MinibatchSampler, stack_windows
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
    from sparknet_tpu_torch.utils.tree import tree_map

    b = DEEP_CPU_BATCH
    batch = stack_windows([
        MinibatchSampler({"data": x[:, :b], "label": y[:, :b].astype(np.float32)},
                         1, seed=w).next_window()
        for w, (x, y) in enumerate(parts)])
    runs, init = [], None
    legs = [(dev, False), (torch.device("cpu"), False),
            (torch.device("cpu"), True)]
    if model == "resnet50":
        legs.append((dev, True))
    for d, f64 in legs:
        solver = imagenet_app.build_solver(_imnet_args(
            d, ("--train_batch", str(b)), model=model), mean, d,
            _deep_solver(model))
        init = init if init is not None else solver.init_state(0)
        start = init
        if f64:
            cast = solver.train_transform
            solver.train_transform = lambda mb, key: {
                k: v.double() if v.is_floating_point() else v
                for k, v in cast(mb, key).items()}
            start = init._replace(**{f: tree_map(lambda t: t.double(),
                                                 getattr(init, f))
                                     for f in ("params", "stats", "history")})
        tr = ParameterAveragingTrainer(solver, IMNET_W)
        st, losses = tr.round(tr.broadcast_state(start), {
            k: torch.from_numpy(v).to(d) for k, v in batch.items()})
        runs.append((st.params, losses.cpu().double()))
    rel = {"card_cpu": [], "card_f64": [], "cpu_f64": [], "f64": []}
    pairs = (("card_cpu", 0, 1), ("card_f64", 0, 2), ("cpu_f64", 1, 2),
             ("f64", 3, 2))[:len(runs)]
    for name, blobs in init.params.items():
        for i, p0 in enumerate(blobs):
            got = [r[0][name][i].cpu().double() for r in runs]
            size = max(float((got[1] - p0.cpu().double()[None]).abs().max()),
                       1e-30)
            for key, a, bb in pairs:
                rel[key].append((float((got[a] - got[bb]).abs().max()) / size,
                                 f"{name}[{i}]"))
    for v in rel.values():
        v.sort(reverse=True)

    def loss_rel(a, bb):
        return float(((runs[a][1] - runs[bb][1]).abs()
                      / runs[bb][1].abs()).max())

    out = {"card_cpu": (rel["card_cpu"][0][0], rel["card_cpu"][:3]),
           "card_f64": rel["card_f64"][0], "cpu_f64": rel["cpu_f64"][0],
           "loss": loss_rel(0, 1)}
    if len(runs) == 4:
        out.update(f64=(rel["f64"][0][0], rel["f64"][:3]),
                   loss_f64=loss_rel(3, 2))
    return out


def deep_nets_end_to_end(dev, card):
    """Phase 12 (see the module doc): GoogLeNet and ResNet-50 through
    ``imagenet_app.train`` at full width; returns the legs' summed
    launches of K5-K11."""
    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.ops import cuda_plp as cp
    from sparknet_tpu_torch.parallel import LOSS_BAND

    from sparknet_tpu_torch.utils.devices import deterministic_algorithms

    train_parts, test_parts, mean = _imnet_partitions()
    n_test = sum(len(x) for x, _ in test_parts)
    results, smoothed, total = {}, {}, {}
    for model, leg, env, extra, rounds, det in DEEP_LEGS:
        with _env(env), deterministic_algorithms(det):
            result, log = {}, _Log()
            for mod in (cl, cp, cc):
                mod.reset_launch_counts()
            t0 = time.perf_counter()
            imagenet_app.train(_imnet_args(dev, extra + ("--rounds", str(rounds)),
                                           model=model),
                               train_parts, test_parts, mean, dev, log, result,
                               _deep_solver(model))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {**cl.LAUNCHES, **cp.LAUNCHES, **cc.LAUNCHES}
        tr = result["trainer"]
        groups = 0
        if tr._comm is not None:
            groups = sum(-(-(sl.stop - sl.start) // cc.MAX_LEAVES)
                         for sl in tr._comm.chunk_slices)
        net = tr.solver.net
        losses = result["losses"]  # (rounds, W, tau)
        per_round = losses.mean(axis=(1, 2))
        smoothed[model, leg] = np.array(log.smoothed)
        print(f"{model} leg {leg}: {len(net.hconv_groups)} hconv groups, "
              f"{len(net._plp_fused)} fused LRN + pool, launches {launches}, "
              "per-round mean loss " + " ".join(f"{v:.6f}" for v in per_round)
              + f", smoothed {smoothed[model, leg].tolist()}, accuracies "
              f"{[round(a, 4) for a in result['accuracies']]}, {wall:.2f} s "
              "with the tests")
        want = _deep_launches(model, leg, rounds, n_test, groups)
        check(launches == want,
              f"{model} leg {leg}: launches {launches}, expected {want}")
        check(bool(np.isfinite(losses).all()), f"{model} {leg}: non-finite loss")
        if model == "googlenet":
            check(len(net.hconv_groups) == (0 if "off" in leg else 9),
                  f"googlenet {leg}: {len(net.hconv_groups)} hconv groups")
            check(len(net._plp_fused) == (1 if leg == "fused" else 0),
                  f"googlenet {leg}: {len(net._plp_fused)} fused sandwiches")
        if rounds > 1:
            check(per_round[-1] < per_round[0],
                  f"{model} {leg}: loss did not fall ({per_round[0]} -> "
                  f"{per_round[-1]})")
        rs = np.array(result["round_seconds"][1:])
        if len(rs):
            imgs = IMNET_W * IMNET_TAU * IMNET_BATCH
            print(f"[{card}] {model} leg {leg}: {1.0 / rs.mean():.3f} rounds/s, "
                  f"{imgs / rs.mean():.1f} images/s (rounds 1..{len(rs)}: "
                  f"{rs.mean() * 1e3:.2f} ms)")
        results[model, leg] = result
        if leg == "default, again":
            check(np.array_equal(losses, results[model, "default"]["losses"]),
                  f"{model}: two runs of the default leg differ")
            print(f"{model} default leg, run twice: every loss equal bit for "
                  "bit")
            continue  # the control: its launches join nothing
        for name, v in launches.items():
            total[name] = total.get(name, 0) + v
    ln = float(np.log(1000))
    first = {m: float(results[m, "default"]["losses"][0, :, 0].mean())
             for m in ("googlenet", "resnet50")}
    print(f"first losses: googlenet {first['googlenet']:.4f} (loss3 + 0.3 x two "
          f"aux heads; at init on the CPU {GOOGLENET_FIRST_LOSS:.4f}, 1.6 ln "
          f"1000 = {1.6 * ln:.4f}), resnet50 "
          f"{first['resnet50']:.4f} (ln 1000 = {ln:.4f})")
    check(abs(first["googlenet"] - GOOGLENET_FIRST_LOSS)
          <= GOOGLENET_FIRST_LOSS_RTOL * GOOGLENET_FIRST_LOSS,
          f"googlenet's first loss {first['googlenet']} not within "
          f"{GOOGLENET_FIRST_LOSS_RTOL:.0%} of {GOOGLENET_FIRST_LOSS:.4f}")
    check(abs(first["resnet50"] - ln) < 1.5, "resnet50's first loss not ~ln 1000")
    gap = np.abs(results["googlenet", "hconv off"]["losses"][0].mean()
                 - results["googlenet", "default"]["losses"][0].mean()) / abs(
        results["googlenet", "default"]["losses"][0].mean())
    print(f"googlenet round 0, hconv off vs on: mean losses {gap:.3e} apart "
          f"(relative; limit {HFUSE_LOSS_RTOL})")
    check(gap <= HFUSE_LOSS_RTOL, f"hconv changes round 0's loss by {gap}")
    default = results["googlenet", "default"]["losses"].mean(axis=(1, 2))
    fgap = np.abs(results["googlenet", "fused"]["losses"].mean(axis=(1, 2))
                  - default) / np.abs(default)
    print("googlenet fused vs default, per-round losses apart (relative): "
          + " ".join(f"{v:.3e}" for v in fgap) + f" (round 0's limit "
          f"{FUSED_LOSS_RTOL})")
    check(fgap[0] <= FUSED_LOSS_RTOL,
          f"googlenet fused and default round-0 losses differ by {fgap[0]}")
    for leg, base, n in (("int8", "default", DEEP_ROUNDS),
                         ("bf16+overlap", "fp32+overlap", DEEP_COMM_ROUNDS)):
        g = np.abs(smoothed["resnet50", leg] - smoothed["resnet50", base][:n])
        print(f"resnet50 {leg} vs {base}, smoothed losses: gaps {g.tolist()} "
              f"(limit {LOSS_BAND})")
        check(len(g) == n and float(g.max()) <= LOSS_BAND,
              f"resnet50 {leg} leaves the loss band of {base}: {g}")
    g = np.abs(smoothed["resnet50", "int8, app settings"]
               - smoothed["resnet50", "default, app settings"])
    print(f"resnet50 int8 vs default under the app's own settings (torch's "
          f"defaults), smoothed losses: gaps {g.tolist()} (not banded: "
          f"ROADMAP C.4)")
    # the averaged BatchNorm stats: every worker holds the same, the mean
    # of what the workers' local steps left
    tr = results["resnet50", "default"]["trainer"]
    st = results["resnet50", "default"]["state"]
    from sparknet_tpu_torch.data import MinibatchSampler, stack_windows

    batch = {k: torch.from_numpy(v).to(dev) for k, v in stack_windows([
        MinibatchSampler({"data": x, "label": y.astype(np.float32)},
                         IMNET_TAU, seed=w).next_window()
        for w, (x, y) in enumerate(train_parts)]).items()}
    local, _, _ = tr._local(st, batch)
    avg = tr._average(local, torch.ones(IMNET_W, device=dev))
    n_stats = 0
    for k, blobs in avg.stats.items():
        for i, s in enumerate(blobs):
            mean_w = local.stats[k][i].sum(dim=0) / IMNET_W
            check(all(torch.equal(s[w], mean_w) for w in range(IMNET_W)),
                  f"BN stats {k}[{i}] after the average are not the workers' "
                  "mean on every worker")
            n_stats += 1
    print(f"resnet50: {n_stats} BatchNorm stat blobs after a round equal on "
          "every worker and equal to the workers' mean")
    for model in ("googlenet", "resnet50"):
        vs = _deep_first_step_matches_cpu(dev, model, train_parts, mean)
        worst, top = vs["card_cpu"]
        print(f"{model} first local step (batch {DEEP_CPU_BATCH}) on the card "
              f"vs the CPU: worst |diff| {worst:.3e} of the update, losses "
              f"{vs['loss']:.3e} apart; "
              + ", ".join(f"{n} {r:.3e}" for r, n in top)
              + f"; against float64 on the CPU the card lies {vs['card_f64'][0]:.3e}"
              f" away (worst blob {vs['card_f64'][1]}), the CPU's float32 "
              f"{vs['cpu_f64'][0]:.3e} ({vs['cpu_f64'][1]})")
        check(vs["loss"] <= DEEP_LOSS_RTOL,
              f"{model} first step's losses on the card vs the CPU: "
              f"{vs['loss']:.3e} (limit {DEEP_LOSS_RTOL})")
        if "f64" in vs:
            worst, top = vs["f64"]
            print(f"{model} first local step in float64, the card vs the CPU: "
                  f"worst |diff| {worst:.3e} of the update, losses "
                  f"{vs['loss_f64']:.3e} apart; "
                  + ", ".join(f"{n} {r:.3e}" for r, n in top))
            check(worst <= DEEP_F64_TOL and vs["loss_f64"] <= DEEP_F64_LOSS_RTOL,
                  f"{model} first step in float64 on the card vs the CPU: "
                  f"{worst:.3e} of the update (limit {DEEP_F64_TOL}), losses "
                  f"{vs['loss_f64']:.3e} (limit {DEEP_F64_LOSS_RTOL})")
        else:
            check(worst <= DEEP_CPU_TOL,
                  f"{model} first step on the card vs the CPU: {worst:.3e} of "
                  f"the update (limit {DEEP_CPU_TOL})")
    walls = {}
    for hf in ("1", "0"):
        walls[hf] = where_imnet_time_goes(
            dev, card, f"hconv {'on' if hf == '1' else 'off'}", "0", "none",
            train_parts, mean, model="googlenet", env={"SPARKNET_HFUSE": hf})
    print(f"[{card}] googlenet round, hconv on vs off: {walls['1'][0]:.3f} vs "
          f"{walls['0'][0]:.3f} ms wall, {walls['1'][1]:.3f} vs "
          f"{walls['0'][1]:.3f} ms device busy ("
          f"{walls['0'][1] / walls['1'][1] - 1:+.2%} off vs on), "
          f"{walls['1'][2]} vs {walls['0'][2]} launches")
    for leg, compress in (("default", "none"), ("int8", "int8")):
        where_imnet_time_goes(dev, card, leg, "0", compress, train_parts, mean,
                              model="resnet50")
    return total


# ----------------------------------------------------------------------
# phase 13: image serving — /predict on CaffeNet at full width, the
# replica fleet with its canary, train-to-serve delivery, and the
# generation fleet

PREDICT_SIZES = (1, 3, 16, 64)  # images a request, cycled over the clients
PREDICT_CLIENTS = 16
PREDICT_POOL = 64  # distinct seeded images; each request takes a slice
# the tolerance of serve --weights: the card's prob against the CPU's
PREDICT_ATOL = 1e-4
# and, since a seeded CaffeNet's probs sit near 1e-3 (1,000 classes),
# each row's max |prob - CPU| against that row's largest CPU prob: the
# card read 7.9e-9 absolute (under 1e-5 of a row's top prob, which is at
# least 1e-3), the whole net in bf16 7.0e-5 (over 1e-2 of it); the limit
# lies between, and the bf16 leg must exceed it
PREDICT_RTOL = 1e-4
# bf16 vs fp32 on the same weights: top-1 must agree on every row whose
# fp32 top-2 margin exceeds this share of the top prob (~13 bf16 ulps)
BF16_MARGIN = 0.05
LRN_BF16_SHAPES = ((PREDICT_POOL, 96, 55, 55), (PREDICT_POOL, 256, 27, 27))
SERVE_QUEUE_SMALL = 2
DELIVERY_TIMEOUT_S = 240.0


def check_lrn_bf16(dev, card):
    """K5 in bfloat16 against its plain version (float32 math on the
    widened input, one round-to-nearest-even narrowing) at CaffeNet's two
    LRN inputs at the top bucket, random and tied, and an odd shape:
    bit-equal, as float32 at the same shapes is.  Returns
    its kernels-line record (launches filled in by the /predict bf16
    leg), timed over both LRNs beside the plain version and
    ``F.local_response_norm`` in bf16 (never called by the port)."""
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops import cuda_lrn as cl

    gen = torch.Generator().manual_seed(13)
    worst = 0.0
    for shape, ties in [(s, t) for s in LRN_BF16_SHAPES + ((3, 7, 5, 9),)
                        for t in (False, True)]:
        x = (_tie_input(dev, shape, 7) if ties
             else torch.randn(*shape, generator=gen).to(dev) * 3)
        xb = x.to(torch.bfloat16)
        y = cl.lrn_fwd(xb, *LRN_HP)
        y32 = cl.lrn_fwd(x, *LRN_HP)
        torch.cuda.synchronize()
        check(y.dtype == torch.bfloat16, f"K5 bf16 {shape}: output {y.dtype}")
        want = cl.lrn_fwd_bf16_reference(xb, *LRN_HP)
        diff = float((y.float() - want.float()).abs().max())
        check(bool(torch.equal(y, want)),
              f"K5 bf16 {shape}: y differs from the plain version's bits "
              f"(max |diff| {diff:.3e})")
        check(bool(torch.equal(y32, cl.lrn_across_reference(x, *LRN_HP))),
              f"K5 fp32 {shape}: y differs from the plain version's bits")
        worst = max(worst, diff)
        print(f"K5 bf16 lrn {shape}{' ties' if ties else ''}: max_abs_err "
              f"{diff:.3e}, bit-equal; fp32 bit-equal")
    xs = [(torch.randn(*s, generator=gen) * 3).to(dev).to(torch.bfloat16)
          for s in LRN_BF16_SHAPES]
    n, alpha, beta, k = LRN_HP

    def each(fn):
        return lambda: [fn(v) for v in xs]

    elems = sum(v.numel() for v in xs)
    nbytes = 2 * 2 * elems  # bf16 in, bf16 out
    b, by = bound_ms(nbytes, (n + 7) * elems)
    rec = dict(name="lrn_fwd_bf16", route="cuda",
               source="sparknet_tpu_torch/ops/csrc/lrn.cu",
               replaces="sparknet_tpu/ops/pallas_lrn.py:64",
               max_abs_err=worst, bound_ms=b, bound_by=by,
               shape=" + ".join(str(s) for s in LRN_BF16_SHAPES) + " bf16",
               ms=device_ms(each(lambda v: cl.lrn_fwd(v, *LRN_HP))),
               plain_ms=device_ms(each(
                   lambda v: cl.lrn_fwd_bf16_reference(v, *LRN_HP))),
               library_ms=device_ms(each(lambda v: F.local_response_norm(
                   v, n, alpha=alpha, beta=beta, k=k))))
    f32 = [v.float() for v in xs]
    f32_ms = device_ms(lambda: [cl.lrn_fwd(v, *LRN_HP) for v in f32])
    print(f"[{card}] K5 lrn_fwd_bf16 [{rec['shape']}, both LRNs]: kernel "
          f"{rec['ms']:.4f} ms on device, plain {rec['plain_ms']:.4f} ms, "
          f"F.local_response_norm (bf16) {rec['library_ms']:.4f} ms, bound "
          f"{b * 1e3:.3f} us ({by}, {nbytes} bytes) -> {b / rec['ms']:.1%} "
          f"of the bound; K5 fp32 on the same inputs {f32_ms:.4f} ms")
    return rec


def _post(host, port, path, body: bytes, timeout=600.0):
    """One POST; (status, headers, parsed JSON body, seconds)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", path, body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    dt = time.perf_counter() - t0
    conn.close()
    return resp.status, dict(resp.getheaders()), json.loads(data), dt


def _cli_server(dev, argv):
    """``cli serve`` in process (``ServeServer`` on a loopback port 0);
    returns (server, delivery, host, port)."""
    from sparknet_tpu_torch.tools import cli

    got = {}
    argv = ["serve", "--port", "0", "--device", dev.type] + argv
    check(cli.main(argv, result=got) == 0,
          f"cli serve {argv}")
    srv = got["server"]
    srv.start()
    host, port = srv.address
    return srv, got["delivery"], host, port


def _predict_body(pool, off, n):
    # integer pixel values in [-128, 128): what a client sends after
    # mean subtraction, and short in JSON
    return json.dumps({"data": pool[off:off + n].astype(np.int16).tolist()}
                      ).encode()


class _EngineForwards:
    """Counts ``InferenceEngine.run_padded`` calls of every engine in the
    process while entered: the batchers' served batches, the canary's
    mirror, and the standby and promoted engines' warmups alike (each
    forward of CaffeNet's deploy view launches K5 twice)."""

    def __enter__(self):
        from sparknet_tpu_torch.serve.engine import InferenceEngine

        self.n, self._lock = 0, threading.Lock()
        self._run = run = InferenceEngine.run_padded

        def counted(engine, x):
            with self._lock:
                self.n += 1
            return run(engine, x)

        InferenceEngine.run_padded = counted
        return self

    def __exit__(self, *exc):
        from sparknet_tpu_torch.serve.engine import InferenceEngine

        InferenceEngine.run_padded = self._run


def _row_rel_err(got, want):
    """The largest over rows of max |got - want| / max |want| in that
    row."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want).max(1) / np.abs(want).max(1)).max())


def image_serving_end_to_end(dev, card, root, seeded_tokens):
    """Phase 13; returns the main-path launches of K1, K2 and K5 (the bf16
    leg's K5 launches as ``lrn_fwd_bf16``)."""
    from sparknet_tpu_torch import models
    from sparknet_tpu_torch.io import caffemodel, checkpoint
    from sparknet_tpu_torch.net import TorchNet
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.serve import InferenceEngine, publish_snapshot
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms

    launches = {}
    t0 = time.perf_counter()
    netp = models.load_model("caffenet")
    net = TorchNet(models.deploy_variant(netp), "TEST")
    params, stats = net.init(0)
    weights = f"{root}/caffenet_seed0.caffemodel"
    caffemodel.save_weights(caffemodel.net_blobs(net, params, stats), weights,
                            net_name="CaffeNet")
    del params, stats
    pool = np.random.RandomState(13).randint(
        -128, 128, (PREDICT_POOL, 3, 227, 227)).astype(np.float32)
    cpu = InferenceEngine(netp, weights=weights, buckets=(PREDICT_POOL,),
                          device="cpu")
    ref = cpu.run_padded(pool)
    print(f"seeded CaffeNet weights ({os.path.getsize(weights)} B) and the "
          f"CPU engine's prob for {PREDICT_POOL} images in "
          f"{time.perf_counter() - t0:.2f} s")

    # --- 13.2: /predict on a 2-replica fleet (with the delivery watcher
    # idle on an empty directory), 16 concurrent clients
    watch = f"{root}/publish"
    os.makedirs(watch)
    t0 = time.perf_counter()
    srv, delivery, host, port = _cli_server(dev, [
        "--net", "caffenet", "--weights", weights, "--replicas", "2",
        "--watch", watch, "--canary_frac", "0.5", "--decision_requests", "4"])
    pool_ = srv.router.pool
    print(f"cli serve --replicas 2 --watch: fleet warmed in "
          f"{time.perf_counter() - t0:.2f} s")
    reqs = []
    for i in range(PREDICT_CLIENTS):
        n = PREDICT_SIZES[i % len(PREDICT_SIZES)]
        off = (7 * i) % (PREDICT_POOL - n + 1)
        reqs.append((off, n, _predict_body(pool, off, n)))
    results = [None] * len(reqs)

    def client(i):
        results[i] = _post(host, port, "/predict", reqs[i][2])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    cl.reset_launch_counts()
    with _EngineForwards() as fwd:
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t_start
    torch.cuda.synchronize()
    k5, forwards = cl.LAUNCHES["lrn_fwd"], fwd.n
    check(all(not t.is_alive() for t in threads), "a /predict client hung")
    worst = worst_rel = 0.0
    for (off, n, _), r in zip(reqs, results):
        check(r is not None and r[0] == 200, f"/predict failed: {r and r[:3]}")
        out = np.asarray(r[2]["outputs"], np.float32)
        check(out.shape == (n, 1000) and r[2]["batched"] == n,
              f"/predict shape {out.shape} for {n} images")
        check(bool(np.isfinite(out).all()), "non-finite prob")
        worst = max(worst, float(np.abs(out - ref[off:off + n]).max()))
        worst_rel = max(worst_rel, _row_rel_err(out, ref[off:off + n]))
    images = sum(n for _, n, _ in reqs)
    lat = sorted(r[3] for r in results)
    shapes = [rep.engine.jit_cache_size() for rep in pool_.replicas]
    print(f"/predict: {len(reqs)} clients, {images} images, {forwards} "
          f"forwards on {len(pool_.replicas)} replicas, K5 launches {k5}; "
          f"max |prob - CPU| {worst:.3e} (limit {PREDICT_ATOL}), "
          f"{worst_rel:.3e} of the row's top prob (limit {PREDICT_RTOL}); "
          f"shapes per replica {shapes}")
    print(f"[{card}] /predict under {len(reqs)} concurrent clients "
          f"(JSON bodies of 1-64 images of 3x227x227): {images / wall:.1f} "
          f"images/s over {wall:.3f} s wall; latency p50 "
          f"{lat[len(lat) // 2] * 1e3:.1f} ms, p99 "
          f"{lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3:.1f} ms")
    check(worst <= PREDICT_ATOL, f"/predict differs from the CPU by {worst}")
    check(worst_rel <= PREDICT_RTOL, f"/predict differs from the CPU by "
          f"{worst_rel:.3e} of a row's top prob")
    check(shapes == [4, 4], f"shapes per replica {shapes}, not 4 each")
    check(forwards > 0 and k5 == 2 * forwards,
          f"K5 launches {k5} for {forwards} forwards")
    launches["lrn_fwd"] = k5

    # --- 13.6 (part): one forward per bucket, profiled, on replica 0
    where_predict_time_goes(pool_.replicas[0].engine, card)

    # --- 13.4: delivery under mirrored live traffic
    solver = Solver(models.load_model_solver("caffenet"), device="cpu")
    state = solver.init_state(seed=1)
    x1 = _predict_body(pool, 0, 1)

    def drive(pred, what):
        # until the decision is recorded and the controller idle again:
        # no standby warmup, mirror or promote forward is then in flight
        def done():
            return pred() and delivery.phase == "idle"

        deadline = time.perf_counter() + DELIVERY_TIMEOUT_S
        while not done() and time.perf_counter() < deadline:
            st = _post(host, port, "/predict", x1)[0]
            check(st == 200, f"/predict during delivery: {st}")
            time.sleep(0.02)
        check(done(), f"delivery: {what} not reached: {delivery.status()}")

    def delivery_launches(fwd, leg):
        # K5 twice a forward of every engine: the replicas' served
        # requests, the canary's mirrored ones, the standby's and the
        # promoted engines' warmups
        torch.cuda.synchronize()
        k5 = cl.LAUNCHES["lrn_fwd"]
        print(f"delivery ({leg}): {fwd.n} forwards, K5 launches {k5}")
        check(fwd.n > 0 and k5 == 2 * fwd.n,
              f"delivery ({leg}): K5 launches {k5} for {fwd.n} forwards")
        launches["lrn_fwd"] += k5

    t0 = time.perf_counter()
    cl.reset_launch_counts()
    with _EngineForwards() as fwd:
        good = publish_snapshot(solver, state, watch,
                                {"passing": True, "reason": "seeded"})
        drive(lambda: delivery.promotions == 1, "the promote")
    delivery_launches(fwd, "promote")
    d = delivery.last_decision
    check(d["action"] == "promoted" and d["replicas_swapped"] == 2,
          f"delivery: {d}")
    check(pool_.incumbent_id == "published_iter_0",
          f"incumbent {pool_.incumbent_id}")
    print(f"delivery: published_iter_0 promoted in "
          f"{time.perf_counter() - t0:.2f} s (max divergence "
          f"{d['window']['max_divergence']:.3e} over "
          f"{d['window']['mirrored']} mirrored)")
    # promote bit identity: each replica's engine equals a fresh engine
    # loaded from the published file, under deterministic algorithms
    # (the check's own forwards are no main-path launches)
    with deterministic_algorithms():
        fresh = InferenceEngine(netp, weights=good[0], device=dev)
        want = fresh.run_padded(pool)
        for rep in pool_.replicas:
            check(np.array_equal(rep.engine.run_padded(pool), want),
                  f"replica {rep.index} after promote differs from a fresh "
                  "engine on the published weights")
    del fresh
    torch.cuda.synchronize()
    cl.reset_launch_counts()
    # a perturbed publish (fc8 x50: finite, far off) rolls back, then a
    # snapshot with no verdict in its manifest is rejected at verify
    params = {k: list(v) for k, v in state.params.items()}
    params["fc8"] = [params["fc8"][0] * 50.0, params["fc8"][1]]
    bad = state._replace(params=params, iter=torch.tensor(1))
    with _EngineForwards() as fwd:
        incumbent = _post(host, port, "/predict", x1)[2]["outputs"]
        t0 = time.perf_counter()
        bad_paths = publish_snapshot(solver, bad, watch,
                                     {"passing": True, "reason": "seeded x50"})
        drive(lambda: delivery.rollbacks == 1, "the rollback")
        rollback_s = time.perf_counter() - t0
        d = delivery.last_decision
        after = _post(host, port, "/predict", x1)[2]["outputs"]
        checkpoint.snapshot(solver, state._replace(iter=torch.tensor(2)),
                            f"{watch}/published")
        drive(lambda: delivery.rejected == 1
              and delivery.last_decision["action"] == "rejected",
              "the rejection")
    check(d["action"] == "rolled_back" and "divergence" in d["why"]
          and d["quarantined"], f"delivery: {d}")
    check(all(not os.path.exists(p) for p in bad_paths),
          "the condemned publish was not quarantined")
    check(pool_.incumbent_id == "published_iter_0", "the incumbent moved")
    check(np.allclose(after, incumbent, rtol=0, atol=1e-6),
          "the incumbent's answers changed after the rollback")
    print(f"delivery: published_iter_1 rolled back in {rollback_s:.2f} s "
          f"({d['why']}), quarantined "
          f"{[os.path.basename(q) for q in d['quarantined']]}")
    check(delivery.last_decision["action"] == "rejected"
          and "verdict" in delivery.last_decision["why"],
          f"delivery: {delivery.last_decision}")
    print("delivery: published_iter_2 (no verdict) rejected")
    delivery_launches(fwd, "rollback and rejection")
    srv.shutdown()
    del solver, state, bad, params

    # --- 13.2: a full queue sheds with 429
    srv, _, host, port = _cli_server(dev, [
        "--net", "caffenet", "--weights", weights, "--buckets", "1,4",
        "--queue", str(SERVE_QUEUE_SMALL), "--max_wait_ms", "3000"])
    parked = [None] * SERVE_QUEUE_SMALL
    threads = [threading.Thread(
        target=lambda i=i: parked.__setitem__(i, _post(host, port,
                                                       "/predict", x1)))
        for i in range(SERVE_QUEUE_SMALL)]
    cl.reset_launch_counts()
    with _EngineForwards() as fwd:
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 30
        while (srv.batcher.queue_depth() < SERVE_QUEUE_SMALL
               and time.perf_counter() < deadline):
            time.sleep(0.005)
        status, headers, body, _ = _post(host, port, "/predict", x1)
        for t in threads:
            t.join(120)
    torch.cuda.synchronize()
    k5, forwards = cl.LAUNCHES["lrn_fwd"], fwd.n
    launches["lrn_fwd"] += k5
    srv.shutdown()
    check(forwards > 0 and k5 == 2 * forwards,
          f"--queue leg: K5 launches {k5} for {forwards} forwards")
    check(status == 429 and headers.get("Retry-After") == "1",
          f"the extra client got {status} {headers}")
    check(all(p is not None and p[0] == 200 for p in parked),
          "the parked requests were not served")
    print(f"--queue {SERVE_QUEUE_SMALL}: the extra client got 429 "
          f"(Retry-After {headers.get('Retry-After')}, {body}); the "
          f"{SERVE_QUEUE_SMALL} queued ones 200")

    # --- 13.3: --dtype bfloat16, one request of the whole pool
    srv, _, host, port = _cli_server(dev, [
        "--net", "caffenet", "--weights", weights, "--dtype", "bfloat16"])
    cl.reset_launch_counts()
    with _EngineForwards() as fwd:
        status, _, body, dt = _post(host, port, "/predict",
                                    _predict_body(pool, 0, PREDICT_POOL))
    torch.cuda.synchronize()
    k5_bf16, forwards = cl.LAUNCHES["lrn_fwd_bf16"], fwd.n
    check(cl.LAUNCHES["lrn_fwd"] == 0,
          f"/predict bf16: {cl.LAUNCHES['lrn_fwd']} float32 K5 launches")
    srv.shutdown()
    check(status == 200, f"/predict bf16: {status}")
    bf = np.asarray(body["outputs"], np.float32)
    check(np.array_equal(bf, torch.from_numpy(bf).to(torch.bfloat16)
                         .float().numpy()),
          "/predict bf16 returned values bf16 cannot hold")
    # the fp32 engine on the same (seed-0) weights, on the card
    fp32 = InferenceEngine(netp, weights=weights, buckets=(PREDICT_POOL,),
                           device=dev).run_padded(pool)
    s32 = np.sort(fp32, axis=1)
    wide = (s32[:, -1] - s32[:, -2]) > BF16_MARGIN * s32[:, -1]
    agree = bf.argmax(1) == fp32.argmax(1)
    dprob = float(np.abs(bf - fp32).max())
    drel = _row_rel_err(bf, fp32)
    print(f"[{card}] /predict --dtype bfloat16, {PREDICT_POOL} images in "
          f"{dt * 1e3:.1f} ms: max |prob bf16 - fp32| {dprob:.3e}, "
          f"{drel:.3e} of the row's top prob; top-1 "
          f"agrees on {int(agree.sum())} of {PREDICT_POOL} rows, and on "
          f"{int((agree & wide).sum())} of the {int(wide.sum())} whose fp32 "
          f"top-2 margin exceeds {BF16_MARGIN:.0%} of the top prob; "
          f"K5 launches {k5_bf16} for {forwards} forwards")
    check(bool(wide.any()), "no row's top-2 margin exceeds the bound")
    check(bool(agree[wide].all()), "bf16 top-1 differs on a wide-margin row")
    # the fp32 /predict limit tells bf16 serving from fp32 serving
    check(drel > PREDICT_RTOL, f"bf16 lies within the fp32 limit "
          f"({drel:.3e} <= {PREDICT_RTOL}): is the net computing in bf16?")
    check(forwards > 0 and k5_bf16 == 2 * forwards,
          f"bf16 leg: K5 launches {k5_bf16} for {forwards} forwards")
    launches["lrn_fwd_bf16"] = k5_bf16

    # --- 13.5: cli serve --generate --replicas 2, 4 streams
    srv, _, host, port = _cli_server(dev, ["--generate", "--replicas", "2"])
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, size=n).tolist() for n in PROMPT_LENS]
    got = [None] * len(prompts)
    threads = [threading.Thread(target=_stream, args=(host, port, p, got, i))
               for i, p in enumerate(prompts)]
    ca.reset_launch_counts()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    torch.cuda.synchronize()
    gen = dict(ca.LAUNCHES)
    per_replica = [int(r.batcher.m_ttft.count) for r in srv.router.pool.replicas]
    srv.shutdown()
    tokens = []
    for r in got:
        check(r is not None and r["status"] == 200, f"stream failed: {r}")
        check(r["events"][-1]["event"] == "done", f"stream ended {r['events'][-1]}")
        tokens.append(r["events"][-1]["tokens"])
    same = sum(a == b for a, b in zip(tokens, seeded_tokens))
    print(f"generate fleet: streams per replica {per_replica}, launches "
          f"{gen}; {same} of {len(prompts)} streams equal the single "
          "engine's (phase 3)")
    check(same == len(prompts), "the fleet streamed other tokens")
    check(gen["flash_fwd"] >= len(prompts) * CLI_MODEL["depth"]
          and gen["decode_attention"] > 0, f"generate fleet launches {gen}")
    for name in ("flash_fwd", "decode_attention"):
        launches[name] = gen[name]
    return launches


def where_predict_time_goes(engine, card, iters: int = 10):
    """Per bucket: the wall time of one served forward (the H2D copy of
    the padded batch, the net, the D2H copy of prob), the device's busy
    share of it, its launches, and the top device rows
    (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for b in engine.buckets:
        x = np.zeros((b,) + engine.item_shape, np.float32)
        fn = lambda x=x: engine.run_padded(x)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = sorted(
            ((e.self_device_time_total / iters / 1e3, e.count // iters, e.key)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0),
            reverse=True,
        )
        busy = sum(r[0] for r in rows)
        check(busy > 0, f"bucket {b}: the profiler saw no device time")
        k5 = sum(r[0] for r in rows if "lrn_fwd_kernel" in r[2])
        # launches and copies from the raw device events, per forward
        evs = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        copies = sum(n.startswith("Memcpy") for n in evs) / iters
        print(f"[{card}] CaffeNet forward at bucket {b}: {wall_ms:.3f} ms "
              f"wall, {busy:.3f} ms device busy ({busy / wall_ms:.1%}), "
              f"{len(evs) / iters - copies:g} kernel launches and {copies:g} "
              f"copies a forward, {len(rows)} kinds; K5 {k5:.4f} ms "
              f"({k5 / busy:.1%} of device)")
        for ms, count, key in rows[:6 if b == engine.max_bucket else 3]:
            print(f"    {ms:.4f} ms ({ms / busy:.1%} of device, {count} "
                  f"launches)  {key[:90]}")


# ----------------------------------------------------------------------
# phase 14: training health and crash-consistent recovery — the kill
# sweep, the full-width DB resume, the in-round mask at the serving
# width, elastic membership over slices, and a verdict-carrying publish
# ----------------------------------------------------------------------
SWEEP_ROUNDS, SWEEP_KILL_ROUND = 4, 2
FT_DB_ROUNDS = 4
# the killed DB process snapshots after rounds 1 and 3 (a CaffeNet job
# state is ~1.5 GB, ~3 s to write): round 2's intent lands after round
# 1's snapshot and commit, so the resumed run restores round 1's
FT_SNAP_EVERY = 2
ELASTIC_ROUNDS = 8
KILL_POLL_S = 0.02


def _comm_groups(plane) -> int:
    """Launches one encode (or apply) of every chunk takes."""
    from sparknet_tpu_torch.ops import cuda_comm as cc

    return sum(-(-(sl.stop - sl.start) // cc.MAX_LEAVES)
               for sl in plane.chunk_slices)


def _subprocess_env():
    return dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))


def _journal_rounds(path):
    from sparknet_tpu_torch.io import journal

    recs, _ = journal.scan(path)
    return [(r["kind"], int(r["round"])) for r in recs]


def _restored_snapshot(solver, prefix, it):
    """The snapshot at ``iter`` under ``prefix``, restored: the state and
    its jobstate's arrays."""
    from sparknet_tpu_torch.io import checkpoint

    path = f"{prefix}_iter_{it}.solverstate.npz"
    return checkpoint.restore(solver, path), checkpoint.load_job_state(path)


def _same_jobstate(a, b, what):
    for k in ("workers", "comm"):
        fa, fb = a.get(k), b.get(k)
        check((fa is None) == (fb is None), f"{what}: jobstate {k} missing")
        if fa is None:
            continue
        sub = "history" if k == "workers" else "resid"
        for i in fa[sub]:
            check(np.array_equal(np.asarray(fa[sub][i]), np.asarray(fb[sub][i])),
                  f"{what}: jobstate {k}/{sub}/{i} differs")


def audit_cost(dev, card, solver):
    """Device ms and launches of one iteration's audit at ``solver``'s
    params, on tensors the size of one worker's params: ``health.pack``,
    and the audit's own grad norm where ClipGradients (which would share
    it) is off."""
    from torch.autograd import DeviceType

    from sparknet_tpu_torch.obs import health

    params, _ = solver.net.init(0, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    grads = {k: [torch.randn(t.shape, generator=gen, device=dev) for t in v]
             for k, v in params.items()}
    new = {k: [p - 1e-3 * g for p, g in zip(params[k], grads[k])]
           for k in params}
    loss = torch.tensor(1.0, device=dev)
    gnorm = torch.tensor(1.0, device=dev)
    clipped = solver.param.clip_gradients > 0

    def one():
        return health.pack(grads, params, new, loss,
                           gnorm if clipped else health.grad_norm(grads))

    ms = device_ms(one)
    one()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        one()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    nparams = sum(t.numel() for v in params.values() for t in v)
    print(f"[{card}] audit, one iteration at {nparams} params: {ms:.4f} device "
          f"ms, {n} kernel launches (profiler)")
    return ms, n


def journal_cost(card, root, n: int = 20):
    """Median wall of an intent (no fsync) and of a commit (fsync) on
    the run's disk."""
    from sparknet_tpu_torch.io.journal import RunJournal

    walls = {"intent": [], "commit": []}
    with RunJournal(f"{root}/cost.journal") as jr:
        for r in range(n):
            for kind in ("intent", "commit"):
                t0 = time.perf_counter()
                (jr.begin_round if kind == "intent" else jr.commit_round)(
                    r, iter=r, snapshot="x_iter_1.solverstate.npz")
                walls[kind].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"[{card}] journal: intent {med['intent']:.4f} ms, commit (fsync) "
          f"{med['commit']:.4f} ms wall, median of {n}")
    return med


def audit_ab(dev, card, runs):
    """One CaffeNet DB round with the audit off (the plain run's trainer)
    and on (the health run's, its sentry reading the stats), warm, on one
    seeded batch: wall, device-busy ms and launches of each."""
    from torch.autograd import DeviceType

    from sparknet_tpu_torch.obs.health import HealthSentry
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms

    gen = torch.Generator(device=dev).manual_seed(3)
    batch = {"data": torch.randn((DB_W, DB_TAU, DB_BATCH, 3, DB_CROP, DB_CROP),
                                 generator=gen, device=dev),
             "label": torch.randint(0, DB_CLASSES, (DB_W, DB_TAU, DB_BATCH),
                                    generator=gen, device=dev).float()}
    sentry = HealthSentry()
    out = {}
    with deterministic_algorithms():
        for leg in ("plain", "health"):
            tr, st = runs[leg]["trainer"], runs[leg]["state"]

            def one():
                got = tr.round(st, batch)
                if tr.solver.audit:
                    sentry.observe(0, got[1], got[2])

            wall, busy, rows = _timed(one, card, f"CaffeNet round, {leg}")
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                one()
                torch.cuda.synchronize()
            n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
            out[leg] = (wall, busy, n)
    (w0, b0, n0), (w1, b1, n1) = out["plain"], out["health"]
    print(f"[{card}] CaffeNet DB round, audit off / on (warm, one batch): wall "
          f"{w0:.3f} / {w1:.3f} ms, device busy {b0:.3f} / {b1:.3f} ms "
          f"(+{b1 - b0:.3f}), launches {n0} / {n1} (+{n1 - n0})")
    return out


def db_kill_resume(dev, card, root):
    """The full-width resume of phase 14 on phase 11's record DB.  Returns
    the in-process runs' launches."""
    from sparknet_tpu_torch.apps import imagenet_run_db_app
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.parallel import first_worker

    db_dir = f"{root}/db"
    common = ["--db_dir", db_dir, "--model", "caffenet", "--tau", str(DB_TAU),
              "--test_every", "100", "--seed", "0", "--compress", "int8",
              "--journal"]
    t0 = time.perf_counter()
    runs = {}
    for mod in (cl, cc):
        mod.reset_launch_counts()
    # the uninterrupted runs keep no snapshots (a CaffeNet job state is
    # ~1.5 GB to write): the resumed run's last snapshot is held to the
    # in-memory state of the health leg
    for leg, extra in (("plain", []), ("health", ["--health", "warn"])):
        r = {}
        check(imagenet_run_db_app.main(
            common + extra + ["--device", dev.type, "--rounds", str(FT_DB_ROUNDS),
                              "--snapshot_prefix", f"{root}/ft_{leg}/caffenet"],
            r) == 0, f"imagenet_run_db {leg}: failed")
        runs[leg] = r
    torch.cuda.synchronize()
    launches = {**cl.LAUNCHES, **cc.LAUNCHES}
    _same_bits(tuple(runs["health"]["state"]), tuple(runs["plain"]["state"]),
               "imagenet_run_db --health vs without: final state")
    rs = {k: np.array(v["round_seconds"][1:]) * 1e3 for k, v in runs.items()}
    print(f"[{card}] CaffeNet DB int8 4 rounds: --health equals the plain run "
          f"bit for bit; round wall mean {rs['health'].mean():.2f} ms with the "
          f"audit and sentry (run second), {rs['plain'].mean():.2f} ms without "
          f"(run first; rounds 1..3 each)")
    sentry = runs["health"]["sentry"]
    check(sentry.rounds_observed == FT_DB_ROUNDS and sentry.anomalies == 0,
          f"DB sentry: {sentry.state_dict()}")
    ams, alaunch = audit_cost(dev, card, runs["health"]["trainer"].solver)
    per_round = DB_W * DB_TAU
    print(f"[{card}] audit per CaffeNet round (W={DB_W} x tau={DB_TAU} "
          f"iterations): {ams * per_round:.3f} device ms, "
          f"{alaunch * per_round} launches")
    jc = journal_cost(card, root)

    # the killed process: SIGKILL once round 2's intent lands
    prefix = f"{root}/ft_kill/caffenet"
    ledger = f"{prefix}_run.journal"
    argv = [sys.executable, "-m", "sparknet_tpu_torch.apps.imagenet_run_db_app"]
    out_path = f"{root}/ft_kill.log"
    with open(out_path, "wb") as out:  # a file: a full pipe would stall it
        proc = subprocess.Popen(
            argv + common + ["--health", "warn", "--snapshot_every",
                             str(FT_SNAP_EVERY), "--device", dev.type,
                             "--rounds", str(FT_DB_ROUNDS),
                             "--snapshot_prefix", prefix],
            env=_subprocess_env(), stdout=out, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 300
        while ("intent", 2) not in _journal_rounds(ledger):
            if proc.poll() is not None:
                with open(out_path, errors="replace") as f:
                    check(False, f"the DB process ended before round 2 "
                          f"({proc.returncode}): {f.read()[-800:]}")
            check(time.monotonic() < deadline, "round 2's intent never landed")
            time.sleep(KILL_POLL_S)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    recs = _journal_rounds(ledger)
    committed = [r for k, r in recs if k == "commit"]
    start = (committed[-1] + 1) if committed else 0
    replayed = 2 if start == 2 else None
    done = subprocess.run(
        argv + common + ["--health", "warn", "--snapshot_every",
                         str(FT_SNAP_EVERY), "--device", dev.type, "--rounds",
                         str(FT_DB_ROUNDS - start), "--snapshot_prefix", prefix,
                         "--resume"],
        env=_subprocess_env(), capture_output=True, text=True, timeout=600)
    check(done.returncode == 0, f"the resumed DB process exited "
          f"{done.returncode}: {done.stderr[-800:]}")
    ctl = runs["health"]
    trainer = ctl["trainer"]
    (b, jb) = _restored_snapshot(trainer.solver, prefix, FT_DB_ROUNDS * DB_TAU)
    _same_bits(tuple(first_worker(ctl["state"])), tuple(b),
               "SIGKILLed + resumed DB run: final snapshot")
    _same_jobstate(trainer.export_job_state(ctl["state"], None), jb,
                   "SIGKILLed + resumed DB run")
    want_ema = ctl["sentry"].export_state()["ema"]
    check(jb["sentry"]["ema"] == want_ema,
          f"resumed sentry EMA {jb['sentry']['ema']} vs {want_ema}")
    # last: its rounds move the trainers' carried residuals
    audit_ab(dev, card, runs)
    print(f"[{card}] CaffeNet DB run SIGKILLed after round 2's intent "
          f"(ledger {recs[-3:]}), resumed at round {start}: round 2 "
          f"{'replayed' if replayed is not None else 'had committed'}; final "
          f"snapshot (params, every worker's momentum, residuals, sentry EMA) "
          f"bit-identical to the uninterrupted run; wall "
          f"{time.perf_counter() - t0:.2f} s")
    return launches, ams, alaunch, jc


def _poisoned_lm(dev, extra=()):
    """lm_app's model, solver (audit on) and trainer at the serving width;
    the net's loss takes a float ``poison`` factor from the batch, so a
    worker's window can carry NaN."""
    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer

    args = lm_app._parser().parse_args(_lm_argv(dev) + list(extra))
    lm, solver = lm_app.build_lm_solver(args, dev)
    solver.audit = True
    plain = lm.loss_fn

    def loss_fn(params, stats, batch, train=True, rng=None):
        loss, aux = plain(params, stats, batch, train, rng=rng)
        p = batch.get("poison")
        return (loss if p is None else loss * p), aux

    lm.loss_fn = loss_fn
    return lm, solver, ParameterAveragingTrainer(
        solver, LM_W, compress=args.compress, overlap_avg=args.overlap_avg)


def _lm_round_batch(dev, r, poison=()):
    host = _lm_batch(r)
    factor = np.ones((LM_W, LM_TAU), np.float32)
    for w in poison:
        factor[w] = np.nan
    host["poison"] = factor
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def lm_mask_end_to_end(dev, card, root):
    """The in-round mask at the serving width (module doc, phase 14).
    Returns the launches."""
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.obs import flight, health
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.parallel import first_worker
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms
    from sparknet_tpu_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    total = dict.fromkeys(list(cc.LAUNCHES) + list(ca.LAUNCHES), 0)

    def add():
        torch.cuda.synchronize()
        for d in (cc.LAUNCHES, ca.LAUNCHES):
            for k, v in d.items():
                total[k] += v
        cc.reset_launch_counts()
        ca.reset_launch_counts()

    cc.reset_launch_counts()
    ca.reset_launch_counts()
    with deterministic_algorithms():
        _, solver, ta = _poisoned_lm(dev, ["--compress", "int8"])
        _, _, tb = _poisoned_lm(dev, ["--compress", "int8"])
        ams, alaunch = audit_cost(dev, card, solver)
        print(f"[{card}] audit per LM round (W={LM_W} x tau={LM_TAU} "
              f"iterations): {ams * LM_W * LM_TAU:.3f} device ms, "
              f"{alaunch * LM_W * LM_TAU} launches")
        init = solver.init_state(0)
        sa, sb = ta.broadcast_state(init), tb.broadcast_state(init)
        sa = ta.round(sa, _lm_round_batch(dev, 0))[0]
        sb = tb.round(sb, _lm_round_batch(dev, 0))[0]
        sentry = health.HealthSentry(policy="warn")
        sa, _ = sentry.guarded_round(ta, sa, _lm_round_batch(dev, 1, [1]),
                                     round_index=1)
        v = sentry.verdicts[-1]
        check(v.masked_workers == [1] and v.action == "masked"
              and not sentry.halted,
              f"masked verdict {v.as_dict()}")
        sb, _, _ = tb.round(sb, _lm_round_batch(dev, 1), live_mask=[1.0, 0.0])
        hb = tuple(h.clone() for h in tree_leaves(sb.history))
        for h in hb:
            h[1].zero_()
        _same_bits(tuple(tree_leaves(sa.params)) + tuple(tree_leaves(sa.stats)),
                   tuple(tree_leaves(sb.params)) + tuple(tree_leaves(sb.stats)),
                   "NaN-masked LM round vs live_mask=[1, 0]: params")
        _same_bits(tuple(tree_leaves(sa.history)), hb,
                   "NaN-masked LM round vs live_mask=[1, 0]: history")
        for r_a, r_b in zip(ta._comm._resid, tb._comm._resid):
            check(not bool(r_a[1].any()), "K10's rejoin left worker 1's residual")
            check(torch.equal(r_a, r_b), "masked vs live_mask residuals differ")
        print(f"[{card}] LM (dim 256, int8): worker 1's NaN window masked; the "
              f"round equals live_mask=[1, 0] with its history zeroed, bit for "
              f"bit; K10 reset its residual; verdict {v.as_dict()['action']} "
              f"masked {v.masked_workers}, nonfinite {v.nonfinite_total}")
        add()

        # rollback: every worker poisoned, the newest snapshot restored
        prefix = f"{root}/lm_rb/lm"
        checkpoint.snapshot(solver, first_worker(sa), prefix, fmt="BINARYPROTO")
        rb = health.HealthSentry(policy="rollback",
                                 restore_fn=health.make_restore_fn(
                                     solver, prefix, trainer=ta))
        sr, _ = rb.guarded_round(ta, sa, _lm_round_batch(dev, 2, [0, 1]),
                                 round_index=2)
        check(rb.rollbacks == 1 and rb.verdicts[-1].action == "rollback",
              f"rollback: {rb.state_dict()}")
        _same_bits(tuple(tree_leaves(first_worker(sr.params))),
                   tuple(tree_leaves(first_worker(sa.params))),
                   "rollback: restored params")
        sr, losses = rb.guarded_round(ta, sr, _lm_round_batch(dev, 3),
                                      round_index=3)
        check(bool(torch.isfinite(losses).all())
              and all(bool(torch.isfinite(t).all())
                      for t in tree_leaves(sr.params)),
              "the round after the rollback is not finite")
        add()

        # halt: SentryHalt and a flight bundle
        bundle = f"{root}/lm_halt.json"
        rec = flight.install(flight.FlightRecorder(bundle))
        try:
            halted = False
            try:
                health.HealthSentry(policy="halt").guarded_round(
                    ta, sr, _lm_round_batch(dev, 4, [0, 1]), round_index=4)
            except health.SentryHalt:
                halted = True
        finally:
            flight.uninstall(rec)
        loaded = flight.load_bundle(bundle)
        check(halted and loaded["reason"] == "sentry_halt"
              and loaded["verdicts"][-1]["action"] == "halt",
              f"halt: raised {halted}, bundle {loaded.get('reason')}")
        add()

        # bf16 overlap: the masked round takes K10, leaves nothing pending
        _, _, tc = _poisoned_lm(dev, ["--compress", "bf16", "--overlap_avg"])
        sc = tc.round(tc.broadcast_state(init), _lm_round_batch(dev, 0))[0]
        check(tc._comm.has_pending, "the overlapped round left no average")
        add()
        sc, _, st = tc.round(sc, _lm_round_batch(dev, 1, [1]))
        torch.cuda.synchronize()
        masked_launch = dict(cc.LAUNCHES)
        groups = _comm_groups(tc._comm)
        check(st["masked"].tolist() == [0.0, 1.0] and not tc._comm.has_pending
              and masked_launch == dict(comm_encode=groups,
                                        comm_apply_barriered=groups,
                                        comm_apply_correction=groups),
              f"bf16 overlap masked round: launches {masked_launch} "
              f"({groups} a stage; K11 lands round 0's average), pending "
              f"{tc._comm.has_pending}")
        tc.finalize(sc)
        torch.cuda.synchronize()
        check(cc.LAUNCHES["comm_apply_correction"] == groups,
              "finalize after the masked round launched K11")
        add()
    print(f"[{card}] LM mask legs: rollback restored and trained on, halt left "
          f"{bundle} ({loaded['dump_index']} dump), bf16 overlap masked round "
          f"{masked_launch}; wall {time.perf_counter() - t0:.2f} s")
    return total


def elastic_end_to_end(dev, card):
    """``cifar_app`` with elastic membership over two slices (module doc,
    phase 14).  Returns the launches."""
    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.parallel import LOSS_BAND, ParameterAveragingTrainer

    plain_round = ParameterAveragingTrainer.round
    plain_k10 = cc.apply_barriered
    per_round, alive_at = [], {}
    current = {"r": None}

    def round_(self, state, batches, live_mask=None, round_index=None):
        current["r"] = round_index
        if round_index == 1:
            os.kill(os.getpid(), signal.SIGTERM)  # the preemption notice
        before = dict(cc.LAUNCHES)
        out = plain_round(self, state, batches, live_mask=live_mask,
                          round_index=round_index)
        torch.cuda.synchronize()
        per_round.append({k: cc.LAUNCHES[k] - before[k] for k in before})
        return out

    def k10(leaves, anchors, means, resids, alive, denom0):
        alive_at.setdefault(current["r"], alive.tolist())
        return plain_k10(leaves, anchors, means, resids, alive, denom0)

    r = {}
    t0 = time.perf_counter()
    cc.reset_launch_counts()
    ParameterAveragingTrainer.round = round_
    cc.apply_barriered = k10
    try:
        rc = cifar_app.main(
            ["--device", dev.type, "--workers", str(CIFAR_W), "--tau",
             str(CIFAR_TAU), "--batch", str(CIFAR_BATCH), "--rounds",
             str(ELASTIC_ROUNDS), "--slices", "2", "--cross_slice_every", "2",
             "--compress", "int8", "--elastic", "--rejoin_after", "2"], r)
    finally:
        ParameterAveragingTrainer.round = plain_round
        cc.apply_barriered = plain_k10
    torch.cuda.synchronize()
    check(rc == 0, f"elastic cifar_app exited {rc}")
    masks = [m.tolist() for m in r["masks"]]
    ctl = r["membership"]
    epochs = [(e, rr, k, list(ws)) for e, rr, k, ws in ctl.transitions]
    print(f"[{card}] elastic cifar10_full: masks {masks}; view epochs "
          f"{epochs}; K10 alive by cross round {alive_at}")
    check([k for _, _, k, _ in epochs] == ["leave", "death", "join_request",
                                           "rejoin"], f"views {epochs}")
    check(alive_at.get(3) == [1.0, 1.0, 0.0, 0.0],
          f"K10's alive while slice 1 is dead: {alive_at.get(3)}")
    check(masks[-1] == [1.0] * CIFAR_W, "slice 1 never rejoined")
    groups = _comm_groups(r["trainer"]._comm)
    for i, d in enumerate(per_round):
        cross = (i + 1) % 2 == 0
        want = dict(comm_encode=groups if cross else 0,
                    comm_apply_barriered=groups if cross else 0,
                    comm_apply_correction=0)
        check(d == want, f"elastic round {i}: launches {d}, expected {want}")
    gap = abs(r["smoothed_loss"] - TRAIN_LOSSES["none"])
    print(f"[{card}] elastic: intra rounds launched no comm kernel, cross "
          f"rounds {groups} K9 + {groups} K10; final smoothed loss "
          f"{r['smoothed_loss']:.6f} vs phase 5's uncompressed "
          f"{TRAIN_LOSSES['none']:.6f}: gap {gap:.6f} (limit {LOSS_BAND}); "
          f"wall {time.perf_counter() - t0:.2f} s")
    check(gap <= LOSS_BAND, f"the elastic leg leaves the loss band: {gap}")
    return dict(cc.LAUNCHES)


def publish_end_to_end(dev, card, root):
    """``cli train --solver`` cifar10_full ``--health warn --publish_to``:
    the publish carries a passing verdict on its CRC manifest, and the
    delivery watcher's reader (``serve/delivery.py``) lists, verifies
    and stages it."""
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.obs.metrics import MetricsRegistry
    from sparknet_tpu_torch.serve import delivery
    from sparknet_tpu_torch.tools import cli

    class _Pool:  # the reader needs only the pool's registry
        registry = MetricsRegistry()

    cifar = f"{root}/cifar"
    solver = _cifar_solver_file(root, cifar)
    pub = f"{root}/published"
    r = {}
    check(cli.main(["train", f"--solver={solver}", f"--data={cifar}",
                    f"--tau={CLI_TRAIN_TAU}", f"--device={dev.type}",
                    f"--max_iter={CLI_TRAIN_SNAPSHOT}", "--health", "warn",
                    f"--publish_to={pub}"], r) == 0,
          "cli train --publish_to failed")
    model, state = r["published"]
    manifest = checkpoint.read_manifest(checkpoint.manifest_path_for(state))
    checkpoint.verify_snapshot(state)
    check(manifest["verdict"]["passing"], f"verdict {manifest['verdict']}")
    reader = delivery.DeliveryController(_Pool(), None, pub,
                                         cache_dir=f"{root}/delivery_cache")
    found = reader._list_manifests()
    check(len(found) == 1, f"the reader lists {found}")
    staged = reader._verify_and_stage(*found[0])
    with open(staged, "rb") as a, open(model, "rb") as b:
        check(a.read() == b.read(), "the staged weights differ from the publish")
    print(f"[{card}] cli train --publish_to: {os.path.basename(model)} with "
          f"verdict {manifest['verdict']['reason']!r} (sentry observed "
          f"{r['sentry'].rounds_observed} windows), CRC manifest verified, "
          f"staged by the delivery reader")
    return model, manifest


def fault_tolerance_end_to_end(dev, card, root):
    """Phase 14 (see the module doc).  Returns the launches of its main
    paths."""
    t0 = time.perf_counter()
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    db_launch, *_ = db_kill_resume(dev, card, root)
    add(db_launch)
    add(lm_mask_end_to_end(dev, card, root))
    add(elastic_end_to_end(dev, card))
    publish_end_to_end(dev, card, root)
    print(f"[{card}] phase 14 wall {time.perf_counter() - t0:.2f} s; launches "
          f"{launches}")
    return launches


# ----------------------------------------------------------------------
# phase 15: the training data plane — object-store roots through the
# chunk cache, --shuffle_epochs, the feed's stall watchdog, the
# featurizer and the file-backed sources
# ----------------------------------------------------------------------

PLANE_ROUNDS, PLANE_EPOCHS = 4, 2
# the DB legs' seed: shuffle.permutation(2, 1, e) deals the two train DBs
# [0, 1] in epoch 0 and [1, 0] in epoch 1, so the epoch boundary moves
# every worker to the other DB (seed 0, phase 11's, deals [1, 0] twice)
PLANE_SEED = 1
# cli train: 50 minibatches of 100, tau 10, so 5 windows an epoch; 6
# windows cross into the second epoch's order
PLANE_CLI_ITERS = 60
# the featurizer on the card against --device cpu: the largest gap over
# the largest feature magnitude (as cli test's scores, CLI_TEST_RTOL)
FEAT_RTOL = 1e-4
STALL_S, STALL_TIMEOUT_S = 2.0, 1.0


class _PlaneServer:
    """A ThreadingHTTPServer on loopback serving ``root``: its bytes and
    GET requests counted by path (the autoindex lists each directory,
    so ``HTTPStore`` lists the hrefs)."""

    def __init__(self, root):
        import http.server
        import urllib.parse

        self.bytes, self.gets = {}, {}
        lock = threading.Lock()
        srv_self = self

        class Handler(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **kw):
                super().__init__(*a, directory=root, **kw)

            def log_message(self, *a):
                pass

            def do_GET(self):
                name = urllib.parse.unquote(self.path.lstrip("/"))
                path = os.path.join(root, name)
                with lock:
                    srv_self.gets[name] = srv_self.gets.get(name, 0) + 1
                    if os.path.isfile(path):
                        srv_self.bytes[name] = (srv_self.bytes.get(name, 0)
                                                + os.path.getsize(path))
                return super().do_GET()

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True, name="plane-http")
        self.thread.start()

    def fetched(self, under, suffix=""):
        return sum(n for k, n in self.bytes.items()
                   if k.startswith(under) and k.endswith(suffix))

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(5.0)
        check(not self.thread.is_alive(), "the phase-15 HTTP server did not stop")


def _kernel_counts():
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.ops import cuda_plp as cp

    return (ca, cl, cp, cc)


def _reset_counts():
    for mod in _kernel_counts():
        mod.reset_launch_counts()


def _read_counts():
    torch.cuda.synchronize()
    out = {}
    for mod in _kernel_counts():
        out.update(mod.LAUNCHES)
    return out


def _dir_bytes(d, suffix):
    return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d)
               if n.endswith(suffix))


def _plane_db_run(dev, db, rounds, *extra):
    """One imagenet_run_db_app run (CaffeNet at full width, phase 11's
    shapes, PLANE_SEED, --shuffle_epochs PLANE_EPOCHS); its result with
    the launches and the wall."""
    from sparknet_tpu_torch.apps import imagenet_run_db_app

    r = {}
    _reset_counts()
    t0 = time.perf_counter()
    check(imagenet_run_db_app.main(
        ["--db_dir", db, "--model", "caffenet", "--device", dev.type,
         "--tau", str(DB_TAU), "--rounds", str(rounds), "--test_every",
         str(DB_TEST_EVERY), "--seed", str(PLANE_SEED), "--shuffle_epochs",
         str(PLANE_EPOCHS), *extra], r) == 0,
        f"imagenet_run_db over {db} {extra} failed")
    r["launches"] = _read_counts()
    r["wall"] = time.perf_counter() - t0
    return r


def _db_launches(rounds, first_round, chunks=0):
    """K5/K6 (and K9/K10) launches of a DB run training rounds
    [first_round, first_round + rounds): two LRNs a step, tests at the
    rounds DB_TEST_EVERY divides and at the end."""
    steps = DB_W * DB_TAU * rounds
    n_tests = len([r for r in range(first_round, first_round + rounds)
                   if r % DB_TEST_EVERY == 0]) + 1
    return dict(NO_BF16, flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
                decode_attention=0,
                lrn_fwd=2 * steps + 2 * n_tests * sum(DB_VAL_BATCHES),
                lrn_bwd=2 * steps, lrn_pool_fwd=0, lrn_pool_bwd=0,
                comm_encode=chunks * rounds,
                comm_apply_barriered=chunks * rounds, comm_apply_correction=0)


def _same_db_run(a, b, what):
    _same_bits(a["state"], b["state"], f"{what}: final state")
    check(a["smoothed"] == b["smoothed"],
          f"{what}: smoothed {a['smoothed']} vs {b['smoothed']}")
    check(np.array_equal(a["losses"], b["losses"]), f"{what}: losses differ")
    check(a["accuracies"] == b["accuracies"],
          f"{what}: accuracies {a['accuracies']} vs {b['accuracies']}")


def db_over_http(dev, card, root, srv):
    """(a) imagenet_run_db_app from an HTTP --db_dir: cold cache, warm
    cache and the local directory bit-identical; the warm run fetches 0
    DB bytes; an int8 run resumed across the epoch boundary equals the
    same run straight through.  Returns the launches."""
    from sparknet_tpu_torch.data import shuffle

    e0 = shuffle.permutation(DB_W, PLANE_SEED, 0)
    e1 = shuffle.permutation(DB_W, PLANE_SEED, 1)
    print(f"--shuffle_epochs {PLANE_EPOCHS}, --seed {PLANE_SEED}: worker -> "
          f"train DB {e0} in epoch 0, {e1} in epoch 1")
    check(e0 != e1, "the shuffle seed does not re-deal the DBs")
    db_dir, url = f"{root}/db", f"{srv.url}/db"
    warm = f"{root}/caffenet_seed1.caffemodel"
    cache = f"{root}/plane/cache"
    db_bytes = _dir_bytes(db_dir, ".sndb")
    cold = _plane_db_run(dev, url, PLANE_ROUNDS, "--warm_start", warm,
                         "--cache_dir", cache)
    cold_bytes = srv.fetched("db/", ".sndb")
    warm_run = _plane_db_run(dev, url, PLANE_ROUNDS, "--warm_start", warm,
                             "--cache_dir", cache)
    warm_bytes = srv.fetched("db/", ".sndb") - cold_bytes
    local = _plane_db_run(dev, db_dir, PLANE_ROUNDS, "--warm_start", warm)
    want = _db_launches(PLANE_ROUNDS, 0)
    for name, r in (("cold cache", cold), ("warm cache", warm_run),
                    ("local", local)):
        check(r["launches"] == want,
              f"imagenet_run_db {name}: launches {r['launches']}, want {want}")
    for name, r in (("cold cache", cold), ("warm cache", warm_run)):
        _same_db_run(local, r, f"imagenet_run_db over HTTP ({name}) vs local")
    tm = warm_run["metrics"]
    check(cold_bytes == db_bytes,
          f"the cold run fetched {cold_bytes} DB bytes of {db_bytes}")
    check(warm_bytes == 0 and tm.cache_bytes.labels("miss").value == 0
          and tm.cache_hits.value > 0,
          f"the warm run fetched {warm_bytes} DB bytes, cache misses "
          f"{tm.cache_misses.value}, hits {tm.cache_hits.value}")
    print(f"[{card}] imagenet_run_db CaffeNet from {url} (W={DB_W}, tau "
          f"{DB_TAU}, batch {DB_BATCH}, {PLANE_ROUNDS} rounds, "
          f"--shuffle_epochs {PLANE_EPOCHS}): cold cache, warm cache and the "
          f"local directory equal bit for bit (final params, momentum "
          f"stacks, every smoothed loss {[round(x, 6) for x in local['smoothed']]}, "
          f"final accuracy {local['accuracies'][-1] * 100:.2f}%); the cold run "
          f"fetched {cold_bytes} B of DB files ({db_bytes} B on disk), the "
          f"warm run {warm_bytes} B (cache hits {tm.cache_hits.value:.0f}, "
          f"misses {tm.cache_misses.value:.0f}); wall cold {cold['wall']:.2f} s, "
          f"warm {warm_run['wall']:.2f} s, local {local['wall']:.2f} s; "
          f"launches each {local['launches']}")
    launches = {}
    for r in (cold, warm_run, local):
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v

    # int8 over the warm cache, snapshots every DB_SNAP_EVERY rounds;
    # the run stopped after its round-DB_SNAP_EVERY snapshot (that
    # snapshot alone, in a prefix of its own) resumed across the epoch
    # boundary to PLANE_ROUNDS
    pa, pb = f"{root}/plane/a", f"{root}/plane/b"
    c = ("--compress", "int8", "--cache_dir", cache, "--snapshot_every",
         str(DB_SNAP_EVERY))
    straight = _plane_db_run(dev, url, PLANE_ROUNDS, *c, "--warm_start", warm,
                             "--snapshot_prefix", f"{pa}/caffenet")
    os.makedirs(pb)
    it = DB_SNAP_EVERY * DB_TAU
    for n in os.listdir(pa):
        if n.startswith(f"caffenet_iter_{it}."):
            shutil.copy(os.path.join(pa, n), os.path.join(pb, n))
    resumed = _plane_db_run(dev, url, PLANE_ROUNDS - DB_SNAP_EVERY, *c,
                            "--snapshot_prefix", f"{pb}/caffenet", "--resume")
    check(resumed["start_round"] == DB_SNAP_EVERY,
          f"the int8 run resumed at round {resumed['start_round']}")
    _same_bits(straight["state"], resumed["state"],
               "imagenet_run_db int8 resumed across the epoch boundary")
    check(np.array_equal(straight["losses"][DB_SNAP_EVERY:], resumed["losses"])
          and straight["smoothed"][DB_SNAP_EVERY:] == resumed["smoothed"]
          and straight["accuracies"][-1] == resumed["accuracies"][-1],
          "imagenet_run_db int8: the resumed rounds' losses or accuracy differ")
    ea = straight["trainer"].export_comm_state()
    er = resumed["trainer"].export_comm_state()
    check(all(np.array_equal(ea["resid"][k], er["resid"][k])
              for k in ea["resid"]), "imagenet_run_db int8: residuals differ")
    chunks = len(resumed["trainer"]._comm.chunk_slices)
    want = _db_launches(PLANE_ROUNDS - DB_SNAP_EVERY, DB_SNAP_EVERY, chunks)
    check(chunks == 3 and resumed["launches"] == want,
          f"imagenet_run_db int8 resumed: {chunks} chunks, launches "
          f"{resumed['launches']}, want {want}")
    print(f"[{card}] imagenet_run_db --compress int8 over the warm cache: "
          f"{PLANE_ROUNDS} rounds straight through vs the round-"
          f"{DB_SNAP_EVERY} snapshot --resume'd into epoch 1: params, "
          f"momentum stacks, residuals, losses and accuracy equal bit for "
          f"bit; wall {straight['wall']:.2f} s + {resumed['wall']:.2f} s; "
          f"the resumed run's launches {resumed['launches']}")
    for k, v in resumed["launches"].items():
        launches[k] = launches.get(k, 0) + v
    shutil.rmtree(f"{root}/plane")  # ~2 GB of CaffeNet snapshots
    return launches


def lm_over_http(dev, card, root, srv):
    """(b) lm_app from an HTTP --corpus through the cache equals the same
    corpus read from file://, bit for bit; K1/K3/K4 launch depth x W x
    tau x rounds times each run."""
    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.data import write_synthetic_corpus

    corpus = f"{root}/corpus"
    write_synthetic_corpus(corpus, seed=0)
    m = LM_MODEL
    argv = ["--device", dev.type, "--workers", str(LM_W), "--tau", str(LM_TAU),
            "--batch", str(LM_BATCH), "--rounds", str(PLANE_ROUNDS),
            "--dim", str(m["dim"]), "--depth", str(m["depth"]),
            "--heads", str(m["heads"]), "--seq_len", str(m["seq_len"]),
            "--base_lr", str(LM_LR)]
    n = m["depth"] * LM_W * LM_TAU * PLANE_ROUNDS
    runs, launches = {}, {}
    for name, extra in (("http", ["--corpus", f"{srv.url}/corpus",
                                  "--cache_dir", f"{root}/lm_cache"]),
                        ("file", ["--corpus", "file://" + corpus])):
        r = {}
        _reset_counts()
        t0 = time.perf_counter()
        check(lm_app.main(argv + extra, r) == 0, f"lm_app over {name} failed")
        got = _read_counts()
        r["wall"] = time.perf_counter() - t0
        check(got["flash_fwd"] == got["flash_bwd_dq"] == got["flash_bwd_dkv"]
              == n, f"lm_app over {name}: launches {got}, want {n} each")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        runs[name] = r
    a, b = runs["http"], runs["file"]
    _same_bits(a["state"], b["state"], "lm_app over HTTP vs file://: state")
    check(np.array_equal(a["losses"], b["losses"]) and a["smoothed"] == b["smoothed"],
          "lm_app over HTTP vs file://: losses differ")
    print(f"[{card}] lm_app (dim {m['dim']}, depth {m['depth']}, W={LM_W}, tau "
          f"{LM_TAU}, batch {LM_BATCH}, {PLANE_ROUNDS} rounds) from "
          f"{srv.url}/corpus ({srv.fetched('corpus/', '.txt')} B fetched "
          f"through the cache) equals file:// bit for bit (smoothed "
          f"{[round(x, 6) for x in a['smoothed']]}); wall {a['wall']:.2f} s vs "
          f"{b['wall']:.2f} s; K1/K3/K4 {n} launches each run")
    shutil.rmtree(f"{root}/lm_cache")
    return launches


def cli_over_http(dev, card, root, srv):
    """(c) cli train --solver cifar10_full, --data from HTTP through the
    cache with --shuffle_epochs 2, equals the local directory bit for
    bit."""
    from sparknet_tpu_torch.models import ZOO_DIR
    from sparknet_tpu_torch.tools import cli

    cifar = f"{root}/cifar"  # phase 10's synthesized CIFAR binaries
    net = os.path.join(ZOO_DIR, "cifar10_full_train_test.prototxt")
    runs = {}
    for name, data in (("http", f"{srv.url}/cifar"), ("local", cifar)):
        solver = f"{root}/plane_cli_{name}.prototxt"
        with open(solver, "w") as f:
            f.write(f'net: "{net}"\nbase_lr: 0.001\nmomentum: 0.9\n'
                    'weight_decay: 0.004\nlr_policy: "fixed"\n'
                    f'display: {CLI_TRAIN_TAU}\n'
                    f'snapshot_prefix: "{root}/plane_cli_{name}/c"\n')
        extra = ([f"--cache_dir={root}/plane_cli_cache"] if name == "http"
                 else [])
        r = {}
        t0 = time.perf_counter()
        check(cli.main(["train", f"--solver={solver}", f"--data={data}",
                        f"--tau={CLI_TRAIN_TAU}", f"--max_iter={PLANE_CLI_ITERS}",
                        f"--shuffle_epochs={PLANE_EPOCHS}",
                        f"--device={dev.type}"] + extra, r) == 0,
              f"cli train over {name} failed")
        torch.cuda.synchronize()
        r["wall"] = time.perf_counter() - t0
        runs[name] = r
    a, b = runs["http"], runs["local"]
    _same_bits(a["state"], b["state"], "cli train over HTTP vs local: state")
    check(a["smoothed_loss"] == b["smoothed_loss"]
          and np.isfinite(a["smoothed_loss"]),
          f"cli train smoothed {a['smoothed_loss']} vs {b['smoothed_loss']}")
    fetched = srv.fetched("cifar/", ".bin")
    check(fetched == _dir_bytes(cifar, ".bin"),
          f"cli train fetched {fetched} B of CIFAR binaries")
    print(f"[{card}] cli train --solver cifar10_full (batch 100, tau "
          f"{CLI_TRAIN_TAU}, {PLANE_CLI_ITERS} iterations, --shuffle_epochs "
          f"{PLANE_EPOCHS}) from {srv.url}/cifar ({fetched} B staged through "
          f"the cache) equals the local directory bit for bit (smoothed loss "
          f"{a['smoothed_loss']:.6f}); wall {a['wall']:.2f} s vs "
          f"{b['wall']:.2f} s")
    shutil.rmtree(f"{root}/plane_cli_cache")


def feed_stall_on_card(dev, card):
    """(d) A RoundFeed on the card whose assemble blocks once, in round
    1, past stall_timeout_s: PrefetchStall, feed_stalls 1, and after
    restart(1) rounds 0-3 equal an unstalled feed's bit for bit."""
    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.data import PrefetchStall, RoundFeed
    from sparknet_tpu_torch.obs.metrics import TrainingMetrics

    def batch(r):
        rs = np.random.RandomState(1000 + r)
        return {"data": rs.randint(0, 256, (DB_W, 2, 3, 64, 64)).astype(np.uint8),
                "label": rs.randint(0, 10, (DB_W, 2)).astype(np.float32)}

    stalled = threading.Event()

    def stalling(r):
        if r == 1 and not stalled.is_set():
            stalled.set()
            time.sleep(STALL_S)
        return batch(r)

    tm = TrainingMetrics()
    with obs.installed_metrics(tm):
        feed = RoundFeed(stalling, dev, num_rounds=4,
                         stall_timeout_s=STALL_TIMEOUT_S)
        clean = RoundFeed(batch, dev, num_rounds=4)
        got = [feed.next_round(0)]
        t0 = time.perf_counter()
        raised = False
        try:
            feed.next_round(1)
        except PrefetchStall:
            raised = True
        waited = time.perf_counter() - t0
        check(raised, "the stalled feed raised no PrefetchStall")
        check(tm.feed_stalls.value == 1,
              f"feed_stalls {tm.feed_stalls.value}, want 1")
        exited = feed.restart(1)
        got += [feed.next_round(r) for r in range(1, 4)]
        want = [clean.next_round(r) for r in range(4)]
        check(feed.stop() and clean.stop(), "a feed's producer did not stop")
    obs.report_healthy()
    for r, (g, w) in enumerate(zip(got, want)):
        for k in w:
            check(g[k].device.type == "cuda" and torch.equal(g[k].cpu(), w[k].cpu()),
                  f"round {r}'s {k} after the restart differs")
    print(f"[{card}] RoundFeed on the card, stall_timeout_s "
          f"{STALL_TIMEOUT_S}: assemble blocked {STALL_S} s in round 1, "
          f"PrefetchStall after {waited:.3f} s, feed_stalls "
          f"{tm.feed_stalls.value:.0f}, the stalled producer "
          f"{'reaped' if exited else 'still in assemble'} at restart(1); "
          "rounds 0-3 equal an unstalled feed's bit for bit")


def _features_close(got, want, what):
    gap = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    check(got.shape == want.shape and np.isfinite(got).all() and gap <= FEAT_RTOL,
          f"{what}: {got.shape} vs {want.shape}, relative gap {gap:.3e}")
    return gap


def _featurize(dev, argv, what):
    """featurizer_app on the CPU and on the card: (card result, CPU
    result, card launches, relative gap)."""
    from sparknet_tpu_torch.apps import featurizer_app

    cpu, card_r = {}, {}
    check(featurizer_app.main(argv + ["--device", "cpu"], cpu) == 0,
          f"{what} on the CPU failed")
    _reset_counts()
    t0 = time.perf_counter()
    check(featurizer_app.main(argv + ["--device", dev.type], card_r) == 0,
          f"{what} on the card failed")
    launches = _read_counts()
    card_r["wall"] = time.perf_counter() - t0
    gap = _features_close(card_r["features"], cpu["features"], what)
    return card_r, cpu, launches, gap


def featurizer_end_to_end(dev, card, root):
    """(e) featurizer_app with CaffeNet at full width (fc7) on phase 11's
    seeded weights and val LMDB, card vs CPU; where h5py imports, its
    .h5 output and cli train on an HDF5Data net with an HDF5Output tap."""
    batches = 1
    out = f"{root}/feats.npz"
    argv = ["--model", "caffenet", "--blob", "fc7", "--weights",
            f"{root}/caffenet_seed1.caffemodel", "--data", f"{root}/val_lmdb",
            "--batches", str(batches), "--out", out]
    r, _, launches, gap = _featurize(dev, argv, "featurizer_app caffenet fc7")
    check(launches["lrn_fwd"] == 2 * batches and launches["lrn_bwd"] == 0,
          f"featurizer launches {launches}")
    check(np.array_equal(np.load(out)["features"], r["features"]),
          "the featurizer's .npz differs from its features")
    print(f"[{card}] featurizer_app --model caffenet --blob fc7 (phase 11's "
          f"weights and val LMDB, the builder's batch): features "
          f"{r['features'].shape}, "
          f"within {gap:.3e} of --device cpu (relative), {r['wall']:.2f} s, "
          f"K5 {launches['lrn_fwd']} launches")
    try:
        import h5py  # noqa: F401  (HDF5 outputs and the HDF5Data layer)
        have_h5py = True
    except ImportError:
        have_h5py = False
    print(f"h5py on this machine: {'yes' if have_h5py else 'no'}"
          + ("" if have_h5py else " — the featurizer's .h5 output and the "
             "HDF5Data/HDF5Output cli train leg are skipped"))
    if have_h5py:
        hdf5_end_to_end(dev, card, root, argv)
    return launches


def hdf5_end_to_end(dev, card, root, feat_argv):
    """The featurizer's .h5 output, and cli train --solver on a
    cifar10_full-shaped net whose train source is HDF5Data and that taps
    ip1 through HDF5Output: 2 windows, the file within FEAT_RTOL of a CPU
    run."""
    import h5py

    from sparknet_tpu_torch.apps import featurizer_app
    from sparknet_tpu_torch.models import ZOO_DIR
    from sparknet_tpu_torch.tools import cli

    h5 = f"{root}/feats.h5"
    r = {}
    check(featurizer_app.main(feat_argv[:-1] + [h5, "--device", dev.type], r)
          == 0, "featurizer_app --out .h5 failed")
    with h5py.File(h5, "r") as f:
        check(np.array_equal(f["fc7"][()], r["features"]),
              "the featurizer's .h5 dataset differs from its features")
    rs = np.random.RandomState(7)
    with h5py.File(f"{root}/cifar_h5.h5", "w") as f:
        f["data"] = rs.randn(200, 3, 32, 32).astype(np.float32)
        f["label"] = rs.randint(0, 10, 200).astype(np.float32)
    with open(os.path.join(ZOO_DIR, "cifar10_full_train_test.prototxt")) as f:
        text = f.read()
    files = {}
    host = ('type: "HostData"', 'java_data_param { shape { dim: 100 dim: 3 '
            'dim: 32 dim: 32 } shape { dim: 100 } }')
    check(text.count(host[1]) == 2, "cifar10_full's data layers moved")
    for name in ("cpu", "card"):
        net = f"{root}/cifar_h5_{name}.prototxt"
        tap = f"{root}/ip1_{name}.h5"
        with open(net, "w") as f:
            f.write(text.replace(host[0], 'type: "HDF5Data"').replace(
                host[1], f'hdf5_data_param {{ source: "{root}/cifar_h5.h5" '
                'batch_size: 100 }')
                + f'layer {{ name: "tap" type: "HDF5Output" bottom: "ip1" '
                f'hdf5_output_param {{ file_name: "{tap}" }} }}\n')
        solver = f"{root}/cifar_h5_{name}_solver.prototxt"
        with open(solver, "w") as f:
            f.write(f'net: "{net}"\nbase_lr: 0.001\nmomentum: 0.9\n'
                    f'lr_policy: "fixed"\nsnapshot_prefix: "{root}/h5_{name}"\n')
        res = {}
        check(cli.main(["train", f"--solver={solver}", "--tau=10",
                        "--max_iter=20", f"--device={dev.type if name == 'card' else 'cpu'}"],
                       res) == 0, f"cli train on the HDF5Data net ({name}) failed")
        check(res["hdf5_outputs"] == [tap], f"HDF5Output wrote {res['hdf5_outputs']}")
        with h5py.File(tap, "r") as f:
            files[name] = f["ip1"][()]
    gap = _features_close(files["card"], files["cpu"], "HDF5Output's ip1")
    print(f"[{card}] cli train --solver on a cifar10_full-shaped HDF5Data net, "
          f"2 windows of 10: HDF5Output's ip1 {files['card'].shape} within "
          f"{gap:.3e} of the CPU run (relative)")


def pillow_sources_end_to_end(dev, card, root, srv):
    """(f) imagenet_app over HTTP JPEG shards (--cache_dir,
    --shuffle_epochs 2, phase 9's small size) against the local shards,
    and ImageData and WindowData nets through the featurizer, card vs
    CPU."""
    from PIL import Image

    from sparknet_tpu_torch.apps import imagenet_app
    from sparknet_tpu_torch.data import write_synthetic_imagenet
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms

    jpeg = f"{root}/jpeg"
    write_synthetic_imagenet(jpeg, num_shards=2, images_per_shard=4 * 3,
                             classes=4, seed=0)
    write_synthetic_imagenet(jpeg, num_shards=2, images_per_shard=4 * 2,
                             classes=4, labels_file="val.txt",
                             shard_prefix="val.", seed=1)
    argv = ["--device", dev.type, "--workers", "2", "--tau", "2", "--rounds",
            "2", "--full_size", "72", "--crop", "67", "--train_batch", "4",
            "--test_batch", "4", "--classes", "4", "--test_every", "1",
            "--shuffle_epochs", "2"]
    runs = {}
    for name, extra in (("http", ["--data", f"{srv.url}/jpeg", "--cache_dir",
                                  f"{root}/jpeg_cache"]),
                        ("local", ["--data", jpeg])):
        r = {}
        _reset_counts()
        with deterministic_algorithms():  # so that the two runs compare
            check(imagenet_app.main(argv + extra, r) == 0,
                  f"imagenet_app over {name} JPEG shards failed")
        r["launches"] = _read_counts()
        runs[name] = r
    a, b = runs["http"], runs["local"]
    _same_bits(a["state"], b["state"], "imagenet_app over HTTP vs local: state")
    check(np.array_equal(a["losses"], b["losses"])
          and a["launches"] == b["launches"] and a["launches"]["lrn_fwd"] > 0,
          f"imagenet_app over HTTP vs local: launches {a['launches']} vs "
          f"{b['launches']}")
    print(f"[{card}] imagenet_app (AlexNet, full 72, crop 67, W=2, tau 2, 2 "
          f"rounds, --shuffle_epochs 2) from {srv.url}/jpeg "
          f"({srv.fetched('jpeg/', '.tar')} B of shards through the cache) "
          f"equals the local shards bit for bit; losses "
          f"{a['losses'].mean(axis=(1, 2)).round(4).tolist()}; launches "
          f"{a['launches']}")
    launches = dict(a["launches"])

    # an ImageData and a WindowData net, an ACROSS LRN in each (K5)
    imgs = f"{root}/imgs"
    os.makedirs(imgs)
    rs = np.random.RandomState(5)
    lines, windows = [], []
    for i in range(8):
        arr = rs.randint(0, 256, (40, 48, 3)).astype(np.uint8)
        Image.fromarray(arr).save(f"{imgs}/im{i}.png")
        lines.append(f"im{i}.png {i % 3}")
        windows.append(f"# {i}\n{imgs}/im{i}.png\n3\n40\n48\n2\n"
                       f"{1 + i % 3} 0.8 4 4 30 30\n0 0.1 20 10 46 38")
    with open(f"{imgs}/list.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(f"{imgs}/windows.txt", "w") as f:
        f.write("\n".join(windows) + "\n")
    trunk = ('layer { name: "conv" type: "Convolution" bottom: "data" '
             'top: "conv" convolution_param { num_output: 32 kernel_size: 3 '
             'weight_filler { type: "gaussian" std: 0.01 } } }\n'
             'layer { name: "norm" type: "LRN" bottom: "conv" top: "norm" '
             'lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }\n'
             'layer { name: "ip" type: "InnerProduct" bottom: "norm" '
             'top: "feat" inner_product_param { num_output: 16 '
             'weight_filler { type: "xavier" } } }\n')
    sources = {
        "ImageData": (f'layer {{ name: "data" type: "ImageData" top: "data" '
                      f'top: "label" transform_param {{ crop_size: 27 '
                      f'mean_value: 100 }} image_data_param {{ source: '
                      f'"{imgs}/list.txt" root_folder: "{imgs}/" batch_size: 4 '
                      f'new_height: 32 new_width: 32 }} }}\n'),
        "WindowData": (f'layer {{ name: "data" type: "WindowData" top: "data" '
                       f'top: "label" transform_param {{ crop_size: 27 '
                       f'mean_value: 100 }} window_data_param {{ source: '
                       f'"{imgs}/windows.txt" batch_size: 4 fg_fraction: 0.5 '
                       f'context_pad: 2 }} }}\n'),
    }
    for kind, head in sources.items():
        model = f"{imgs}/{kind}.prototxt"
        with open(model, "w") as f:
            f.write(f'name: "{kind}"\n' + head + trunk)
        r, _, got, gap = _featurize(dev, ["--model", model, "--blob", "feat",
                                          "--batches", "2"],
                                    f"featurizer_app on a {kind} net")
        check(got["lrn_fwd"] == 2, f"{kind} featurizer: launches {got}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        print(f"[{card}] featurizer_app on a {kind} net (2 batches of 4 at "
              f"27x27, an ACROSS LRN): features {r['features'].shape} within "
              f"{gap:.3e} of --device cpu (relative), K5 {got['lrn_fwd']} "
              f"launches")
    shutil.rmtree(f"{root}/jpeg_cache")
    return launches


def data_plane_end_to_end(dev, card, root):
    """Phase 15 (see the module doc): one loopback HTTP server over the
    phase's temporary directory for every leg.  Returns the launches of
    its main paths."""
    t0 = time.perf_counter()
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    try:
        import PIL  # noqa: F401  (JPEG shards, ImageData, WindowData)
        have_pil = True
    except ImportError:
        have_pil = False
    print(f"Pillow on this machine: {'yes' if have_pil else 'no'}"
          + ("" if have_pil else " — leg (f) is skipped"))
    srv = _PlaneServer(root)
    try:
        add(db_over_http(dev, card, root, srv))
        add(lm_over_http(dev, card, root, srv))
        cli_over_http(dev, card, root, srv)
        feed_stall_on_card(dev, card)
        add(featurizer_end_to_end(dev, card, root))
        if have_pil:
            add(pillow_sources_end_to_end(dev, card, root, srv))
    finally:
        srv.close()
    print(f"[{card}] phase 15 wall {time.perf_counter() - t0:.2f} s; HTTP "
          f"requests {sum(srv.gets.values())}, bytes served "
          f"{sum(srv.bytes.values())}; launches {launches}")
    return launches


# ----------------------------------------------------------------------
# phase 16: bounded staleness through the trainer, the DB app and the
# recover driver's kill sweep; the round profiler on the card; cli time;
# the chaos harness
# ----------------------------------------------------------------------
STALE_W, STALE_TAU, STALE_BOUNDARIES = 4, 4, 4
STALE_B, STALE_DISCOUNT = 2, 0.5
# an arrived worker's params against a float64 weighted mean of the
# arrived post-window replicas, relative to the largest magnitude
STALE_MEAN_RTOL = 1e-6
# the DB app's --stale_bound 2 run against its --stale_bound 0 run (the
# JAX package pins allclose: Σw·θ/Σw is not the masked mean's bits)
STALE_DB_RTOL = 1e-5
PROF_ROUNDS = 4
STRAGGLER_ROUND, STRAGGLER_WORKER, STRAGGLER_S = 2, 1, 0.4
OVERLAP_PROF_ROUNDS = 3
TIME_ITERS = 10
SWEEP_JOBS = 11  # recover runs at a time: every independent one at once


def _stale_arrivals(b: int) -> np.ndarray:
    """Worker 3 never arrives by itself; worker 1 misses boundary 1."""
    arr = np.ones((STALE_W,), bool)
    arr[3] = False
    if b == 1:
        arr[1] = False
    return arr


def _stale_rules(worker_rounds, b, arrived, slices):
    """The JAX package's arrival rules (``parallel/stale.py``), restated
    on host integers: the lag, the forced set (live and lagging by the
    bound), slices arriving together, weights ``discount ** lag``, and
    the ledger after the fold."""
    wr = [int(v) for v in worker_rounds]
    lag = [max(b - v, 0) for v in wr]
    forced = [bool(lag[w] >= STALE_B and not arrived[w]) for w in range(len(wr))]
    eff = [bool(arrived[w] or forced[w]) for w in range(len(wr))]
    if slices is not None:
        for members in slices:
            ok = all(eff[w] for w in members)
            for w in members:
                eff[w] = ok
        forced = [f and e for f, e in zip(forced, eff)]
    weights = [float(np.float32(STALE_DISCOUNT ** lag[w])) if eff[w] else 0.0
               for w in range(len(wr))]
    return dict(lag=lag, arrived=eff, forced=forced, weights=weights,
                worker_rounds=[v + int(e) for v, e in zip(wr, eff)])


def _stale_batches(dev, worker_rounds):
    """The mixed-round window of a boundary, made on the card: worker w's
    rows from round ``worker_rounds[w]``'s seeded batch."""
    per_round = {}
    for r in sorted(set(int(v) for v in worker_rounds)):
        g = torch.Generator(device=dev).manual_seed(1000 + r)
        per_round[r] = (
            torch.randn((STALE_W, STALE_TAU, DB_BATCH, 3, DB_CROP, DB_CROP),
                        generator=g, device=dev),
            torch.randint(0, DB_CLASSES, (STALE_W, STALE_TAU, DB_BATCH),
                          generator=g, device=dev).float())
    return {"data": torch.stack([per_round[int(r)][0][w]
                                 for w, r in enumerate(worker_rounds)]),
            "label": torch.stack([per_round[int(r)][1][w]
                                  for w, r in enumerate(worker_rounds)])}


def _weighted_mean_gap(post, after, weights, eff, groups) -> float:
    """The largest gap of an arrived worker's params from the float64
    weighted mean of its group's arrived post-window replicas, over the
    mean's largest magnitude."""
    from sparknet_tpu_torch.utils.tree import tree_leaves

    worst = 0.0
    for p, a in zip(tree_leaves(post.params), tree_leaves(after.params)):
        for members in groups:
            arrived = [w for w in members if eff[w]]
            if not arrived:
                continue
            num = sum(weights[w] * p[w].double() for w in arrived)
            mean = num / sum(weights[w] for w in arrived)
            scale = max(float(mean.abs().max()), 1e-30)
            for w in arrived:
                worst = max(worst, float((a[w].double() - mean).abs().max())
                            / scale)
    return worst


def stale_trainer_end_to_end(dev, card, warm):
    """(a): the stale trainer at CaffeNet's full width (W=4, tau 4,
    batch 32, crop 227, 1,000 classes, warm-started from phase 11's
    weights) under deterministic algorithms: B=0 against the
    synchronous trainer bit for bit; B=2 with the seeded arrival
    schedule, flat and two-tier (2 slices of 2, cross every 2nd).
    Returns K5/K6's launches."""
    from sparknet_tpu_torch.apps import imagenet_run_db_app
    from sparknet_tpu_torch.io import checkpoint
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.parallel import HierarchySpec, ParameterAveragingTrainer
    from sparknet_tpu_torch.parallel.stale import BoundedStalenessTrainer
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms
    from sparknet_tpu_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    total = {}
    with deterministic_algorithms():
        solver = imagenet_run_db_app.build_solver(
            "caffenet", {"classes": DB_CLASSES, "train_batch": DB_BATCH,
                         "test_batch": DB_TEST_BATCH}, DB_CROP, dev)
        st0 = checkpoint.load_weights_into_state(solver, solver.init_state(0),
                                                 warm)
        n_params = sum(t.numel() for t in tree_leaves(st0.params))
        check(n_params == 60965224, f"CaffeNet has {n_params} parameters")
        # B=0 is the synchronous round, bit for bit
        runs = {}
        for name, tr in (("sync", ParameterAveragingTrainer(solver, STALE_W)),
                         ("stale_bound=0", BoundedStalenessTrainer(
                             solver, STALE_W, stale_bound=0))):
            st, losses = tr.broadcast_state(st0), []
            for r in range(STALE_BOUNDARIES):
                st, l = tr.round(st, _stale_batches(dev, [r] * STALE_W),
                                 round_index=r)
                losses.append(l)
            runs[name] = (st, torch.stack(losses))
        (s1, l1), (s2, l2) = runs["sync"], runs["stale_bound=0"]
        _same_bits(s1, s2, "stale_bound=0 vs the synchronous trainer")
        check(torch.equal(l1, l2), "stale_bound=0: a loss differs from sync")
        print(f"[{card}] stale trainer, CaffeNet ({n_params} params) W="
              f"{STALE_W} tau {STALE_TAU} batch {DB_BATCH}, {STALE_BOUNDARIES} "
              f"boundaries: stale_bound=0 equals ParameterAveragingTrainer bit "
              f"for bit (params, stats, history, iter, every loss)")
        del runs, s1, s2
        for label, spec in (("flat", None),
                            ("two-tier", HierarchySpec.grouped(STALE_W, 2, 2))):
            tr = BoundedStalenessTrainer(solver, STALE_W, stale_bound=STALE_B,
                                         discount=STALE_DISCOUNT, hierarchy=spec)
            cap, orig = {}, tr._weighted_mean

            def hook(st, w, keep, bad, groups, orig=orig):
                cap["post"] = st  # the arrived windows, before the mean
                return orig(st, w, keep, bad, groups)

            tr._weighted_mean = hook
            state = tr.broadcast_state(st0)
            windows, gaps, readout = 0, [], []
            cl.reset_launch_counts()
            for b in range(STALE_BOUNDARIES):
                arrived = _stale_arrivals(b)
                want = _stale_rules(tr.worker_rounds, b, arrived,
                                    spec.slices if spec else None)
                before = [x.clone() for x in tree_leaves(tuple(state))]
                cap.clear()
                state, _ = tr.round(state, _stale_batches(dev, tr.worker_rounds),
                                    arrived=arrived, round_index=b)
                lb = tr.last_boundary
                got = dict(lag=lb["lag"], arrived=lb["arrived"],
                           forced=lb["forced"], weights=lb["weights"],
                           worker_rounds=[int(v) for v in tr.worker_rounds])
                check(got == want, f"stale {label} boundary {b}: {got} vs the "
                      f"JAX rules' {want}")
                eff = want["arrived"]
                after = tree_leaves(tuple(state))
                for w in range(STALE_W):
                    if not eff[w]:
                        check(all(torch.equal(x[w], y[w])
                                  for x, y in zip(before, after)),
                              f"stale {label} boundary {b}: absent worker {w}'s "
                              "replica changed")
                gap = 0.0
                if any(eff):
                    groups = (spec.slices if lb["tier"] == "intra"
                              else [tuple(range(STALE_W))])
                    gap = _weighted_mean_gap(cap["post"], state, want["weights"],
                                             eff, groups)
                    check(gap <= STALE_MEAN_RTOL, f"stale {label} boundary {b}: "
                          f"weighted mean off by {gap:.3e}")
                windows += sum(eff)
                gaps.append(gap)
                readout.append(f"b{b} {lb['tier']} arrived "
                               f"{''.join('1' if e else '0' for e in eff)} lag "
                               f"{lb['lag']} forced {sum(lb['forced'])}")
                del before, after
            torch.cuda.synchronize()
            launches = dict(cl.LAUNCHES)
            want_l = 2 * STALE_TAU * windows
            check(launches["lrn_fwd"] == want_l and launches["lrn_bwd"] == want_l,
                  f"stale {label}: LRN launches {launches}, expected {want_l} "
                  f"each ({windows} windows run)")
            for k in ("lrn_fwd", "lrn_bwd"):
                total[k] = total.get(k, 0) + launches[k]
            print(f"[{card}] stale trainer {label}, stale_bound {STALE_B}, "
                  f"discount {STALE_DISCOUNT}: {'; '.join(readout)}; ledger "
                  f"{[int(v) for v in tr.worker_rounds]} as the JAX rules give; "
                  f"absent replicas bit-unchanged; weighted-mean gap "
                  f"{max(gaps):.3e} (limit {STALE_MEAN_RTOL}); K5 and K6 "
                  f"{want_l} launches each = 2 x tau x {windows} windows run "
                  f"(a run of every window would take "
                  f"{2 * STALE_TAU * STALE_W * STALE_BOUNDARIES})")
    print(f"[{card}] (a) wall {time.perf_counter() - t0:.2f} s")
    return total


def stale_db_end_to_end(dev, card, root, warm):
    """(b): imagenet_run_db_app --stale_bound 2 --journal against the
    same run at --stale_bound 0.  Returns the stale run's K5/K6
    launches."""
    from sparknet_tpu_torch.apps import imagenet_run_db_app
    from sparknet_tpu_torch.io.journal import default_journal_path, scan
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.utils.tree import tree_leaves

    t0 = time.perf_counter()
    db_dir = f"{root}/db"
    runs = {}
    for bound in (0, 2):
        prefix = f"{root}/p16_stale{bound}/caffenet"
        res = {}
        cl.reset_launch_counts()
        check(imagenet_run_db_app.main(_db_argv(
            dev, db_dir, prefix, DB_ROUNDS, "--stale_bound", str(bound),
            "--journal", "--warm_start", warm), res) == 0,
            f"imagenet_run_db --stale_bound {bound} failed")
        torch.cuda.synchronize()
        launches = dict(cl.LAUNCHES)
        runs[bound] = (res, scan(default_journal_path(prefix))[0])
    # every window runs (every worker arrives), as at --stale_bound 0
    steps = DB_W * DB_TAU * DB_ROUNDS
    check(launches["lrn_bwd"] == 2 * steps,
          f"--stale_bound 2: K6 launches {launches}, expected {2 * steps}")
    (r0, j0), (r2, j2) = runs[0], runs[2]
    gap = 0.0
    for a, b in zip(tree_leaves(r0["state"].params), tree_leaves(r2["state"].params)):
        scale = max(1.0, float(a.abs().max()))
        gap = max(gap, float((a.double() - b.double()).abs().max()) / scale)
    check(gap <= STALE_DB_RTOL, f"--stale_bound 2 vs 0: params {gap:.3e} apart")
    check(j2 and all(r.get("worker_rounds") for r in j2),
          "--stale_bound 2: a journal record lacks worker_rounds")
    commits = [r["worker_rounds"] for r in j2 if r["kind"] == "commit"]
    # the app commits at its snapshots
    check(commits == [[k] * DB_W for k in range(DB_SNAP_EVERY, DB_ROUNDS + 1,
                                                DB_SNAP_EVERY)],
          f"--stale_bound 2: committed ledgers {commits}")
    check(not any("worker_rounds" in r for r in j0),
          "--stale_bound 0 journaled a ledger")
    print(f"[{card}] imagenet_run_db_app --stale_bound 2 --journal, CaffeNet "
          f"W={DB_W} {DB_ROUNDS} rounds: final params {gap:.3e} of the "
          f"--stale_bound 0 run's (limit {STALE_DB_RTOL}); {len(j2)} journal "
          f"records, each with worker_rounds (commits {commits}); launches "
          f"{launches}; wall {time.perf_counter() - t0:.2f} s")
    return launches


def kill_sweep(dev, card, root):
    """(c): ``chaos.run_kill_sweep`` on the card — every synchronous kill
    point, the --no_journal and journal-off controls and the stale leg
    SIGKILLed at stale_boundary:2, each a recover process SIGKILLed and
    resumed — with phase 14's checks: every point resumed at round 2 to
    the control's digest, which equals an in-process control whose comm
    launches are counted.  Returns those launches."""
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.runtime import chaos, recover
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms

    t0 = time.perf_counter()
    with deterministic_algorithms():
        ctx = recover.RecoverContext(f"{root}/sweep", device=dev)
        cc.reset_launch_counts()
        control = recover.run_driver(ctx, SWEEP_ROUNDS,
                                     run_dir=f"{root}/sweep/control")
        torch.cuda.synchronize()
        groups = _comm_groups(ctx.trainer._comm)
        launches = dict(cc.LAUNCHES)
    want = dict(comm_encode=groups * SWEEP_ROUNDS,
                comm_apply_barriered=groups * SWEEP_ROUNDS,
                comm_apply_correction=0)
    check(launches == want, f"sweep control launches {launches}, expected "
          f"{want} ({groups} a round)")
    rep = chaos.run_kill_sweep(workdir=f"{root}/sweep_proc", rounds=SWEEP_ROUNDS,
                               kill_round=SWEEP_KILL_ROUND, device=dev.type,
                               jobs=SWEEP_JOBS, timeout_s=600.0)
    check(rep["control_digest"] == control["final_digest"],
          "the recover process's control differs from the in-process one")
    for row in rep["killpoints"]:
        check(row["survived"] and row["killed"]
              and row["rounds_executed"] == [2, 3],
              f"kill sweep {row['kill_at']}: {row}")
        print(f"kill sweep {row['kill_at']}: SIGKILLed, resumed at round "
              f"{row['start_round']} (torn bytes "
              f"{row['journal_truncated_bytes']}), digest equal, restore "
              f"{row['recovery_latency_s']} s")
    check(len(rep["killpoints"]) == len(recover.KILL_POINTS) - 1,
          f"{len(rep['killpoints'])} sync kill points swept")
    check(rep["no_journal_diverged"],
          "--no_journal resume equals the control: the zero is vacuous")
    check(rep["journal_bit_neutral"], "the journal-off control differs")
    st = rep["stale"]
    check(st["survived"] and st["killed"]
          and st["resumed_worker_rounds"] == [SWEEP_KILL_ROUND, 0],
          f"kill sweep {st['kill_at']}: {st}")
    print(f"[{card}] run_kill_sweep ({SWEEP_JOBS} recover processes at a "
          f"time): {rep['killpoints_survived']} kill points SIGKILLed at round "
          f"{SWEEP_KILL_ROUND}, each resumed to the control's digest "
          f"{control['final_digest'][:16]}; --no_journal differs; journal-off "
          f"equal; stale_boundary:{SWEEP_KILL_ROUND} resumed from ledger "
          f"{st['resumed_worker_rounds']} replaying {st['replayed_rounds']} "
          f"round(s) to the stale control's digest (restore "
          f"{st['recovery_latency_s']} s); K9/K10 {groups} a round in the "
          f"control; control round ms {rep['control_round_ms']}; journal "
          f"overhead {rep['journal_overhead_pct']}%; sweep wall "
          f"{time.perf_counter() - t0:.2f} s")
    return launches


@contextlib.contextmanager
def _slept(timer, seconds):
    with timer:
        time.sleep(seconds)
        yield


def profiler_end_to_end(dev, card, root, warm):
    """(d): the round profiler on the card — the int8 DB run's phases,
    hidden fractions, per-worker execute times (CUDA events), achieved
    FLOP/s and MFU; the straggler run; the AlexNet bf16 overlap run's
    comm hidden fraction.  Returns K9-K11's launches."""
    from sparknet_tpu_torch.apps import imagenet_app, imagenet_run_db_app
    from sparknet_tpu_torch.obs import profile as prof_mod
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.ops import cuda_plp as cp

    t0 = time.perf_counter()
    db_dir = f"{root}/db"
    out = f"{root}/p16_profile.json"
    cc.reset_launch_counts()
    res = {}
    check(imagenet_run_db_app.main(_db_argv(
        dev, db_dir, f"{root}/p16_prof/caffenet", PROF_ROUNDS, "--compress",
        "int8", "--profile", "--profile_out", out, "--warm_start", warm,
        "--snapshot_every", "0"),
        res) == 0, "imagenet_run_db --profile failed")
    torch.cuda.synchronize()
    total = dict(cc.LAUNCHES)
    with open(out) as f:
        s = json.load(f)
    check(s["rounds"] == PROF_ROUNDS, f"profile: {s['rounds']} rounds")
    phases = ("assemble", "h2d", "execute", "quantize", "allreduce",
              "dequantize", "average")
    for ph in phases:
        check(ph in s["phases"] and s["phases"][ph]["p50_ms"] > 0,
              f"profile: phase {ph} missing or 0: {s['phases'].get(ph)}")
    ex = s["worker_execute_ms"]
    check(ex is not None and len(ex["p50"]) == DB_W and min(ex["p50"]) > 0,
          f"profile: per-worker execute ms {ex}")
    check(s["achieved_flops_per_s"] > 0 and s["mfu"] is not None,
          f"profile: achieved {s.get('achieved_flops_per_s')}, mfu {s.get('mfu')}")
    print(f"[{card}] imagenet_run_db --compress int8 --profile (CaffeNet W="
          f"{DB_W} tau {DB_TAU} batch {DB_BATCH}, {PROF_ROUNDS} rounds): phase "
          f"p50 ms " + ", ".join(f"{ph} {s['phases'][ph]['p50_ms']}"
                                 for ph in s["phases"])
          + f"; h2d hidden fraction {s['hidden_frac_h2d']}; per-worker execute "
          f"ms (CUDA events) p50 {ex['p50']} max {ex['max']}; round ms "
          f"{s['round_ms']}; train_flops {s['flops_per_round']:.4e} a round; "
          f"achieved {s['achieved_flops_per_s'] / 1e12:.3f} TFLOP/s; MFU "
          f"{s['mfu']} of the card's float32 peak {s['peak_flops']} FLOP/s; "
          f"straggler rounds {s['straggler_rounds']}")
    # the straggler: round 2's assembly of worker 1 sleeps under worker_timer
    orig = prof_mod.worker_timer

    def slow(r, w, n, phase="assemble"):
        t = orig(r, w, n, phase)
        return (_slept(t, STRAGGLER_S) if (r, w) == (STRAGGLER_ROUND,
                                                     STRAGGLER_WORKER) else t)

    prof_mod.worker_timer = slow
    res2 = {}
    try:
        check(imagenet_run_db_app.main(_db_argv(
            dev, db_dir, f"{root}/p16_strag/caffenet", PROF_ROUNDS, "--profile",
            "--warm_start", warm, "--snapshot_every", "0"), res2) == 0,
            "the straggler run failed")
    finally:
        prof_mod.worker_timer = orig
    s2 = res2["profile"]
    check(s2["straggler_rounds"] == 1
          and s2["last_straggler_worker"] == STRAGGLER_WORKER
          and s2["last_straggler_round"] == STRAGGLER_ROUND,
          f"straggler verdict: {s2['straggler_rounds']} round(s), last worker "
          f"{s2['last_straggler_worker']} at round {s2['last_straggler_round']}")
    print(f"[{card}] straggler run: worker {STRAGGLER_WORKER}'s round-"
          f"{STRAGGLER_ROUND} assembly slept {STRAGGLER_S} s; the verdict named "
          f"worker {s2['last_straggler_worker']} at round "
          f"{s2['last_straggler_round']} and no other round (worker skew "
          f"{s2['worker_skew']})")
    # AlexNet, bf16 payload, overlapped average
    train_parts, test_parts, mean = _imnet_partitions()
    with _env({"SPARKNET_FUSION": "0"}):
        result, log = {}, _Log()
        for mod in (cl, cp, cc):
            mod.reset_launch_counts()
        imagenet_app.train(_imnet_args(dev, (
            "--compress", "bf16", "--overlap_avg", "--rounds",
            str(OVERLAP_PROF_ROUNDS), "--profile")), train_parts, test_parts,
            mean, dev, log, result)
        torch.cuda.synchronize()
        launches = dict(cc.LAUNCHES)
    s3 = result["profile"]
    check(launches["comm_apply_correction"] == 3 * OVERLAP_PROF_ROUNDS,
          f"AlexNet overlap --profile: K11 launches {launches}")
    check(s3["hidden_frac_comm"] is not None,
          "AlexNet overlap --profile: no comm hidden fraction")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    print(f"[{card}] imagenet_app --model alexnet --compress bf16 --overlap_avg "
          f"--profile, {OVERLAP_PROF_ROUNDS} rounds: comm hidden fraction "
          f"{s3['hidden_frac_comm']}; h2d {s3['hidden_frac_h2d']}; phase p50 ms "
          + ", ".join(f"{ph} {v['p50_ms']}" for ph, v in s3["phases"].items())
          + f"; launches {launches}; (d) wall {time.perf_counter() - t0:.2f} s")
    return total


def cli_time_end_to_end(dev, card):
    """(e): ``cli time --model caffenet --iterations 10 --batch 32``.
    Returns K5/K6's launches."""
    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.tools import cli

    t0 = time.perf_counter()
    cl.reset_launch_counts()
    res = {}
    check(cli.main(["time", "--model", "caffenet", "--iterations",
                    str(TIME_ITERS), "--batch", str(DB_BATCH), "--device",
                    dev.type], result=res) == 0, "cli time failed")
    torch.cuda.synchronize()
    launches = {k: v for k, v in cl.LAUNCHES.items() if k in ("lrn_fwd", "lrn_bwd")}
    p = res["profile"]
    check(launches["lrn_fwd"] > 0 and launches["lrn_bwd"] > 0,
          f"cli time: LRN launches {launches}")
    check({"norm1", "norm2"} <= set(p["layers"]), "cli time: no norm rows")
    for name, row in p["layers"].items():
        check(row["forward_ms"] > 0, f"cli time: {name} forward 0")
    print(f"[{card}] cli time --model caffenet --iterations {TIME_ITERS} --batch "
          f"{DB_BATCH}: whole-net forward {p['total_forward_ms']:.3f} ms, "
          f"forward+backward {p['total_fwdbwd_ms']:.3f} ms; K5/K6 launches "
          f"{launches}; {time.perf_counter() - t0:.2f} s with the seeded init")
    return launches


def chaos_end_to_end(dev, card, root):
    """(f): ``run_chaos`` on the card, the default plan (its
    collector_outage included).  Returns the kernels' launches."""
    from sparknet_tpu_torch.runtime import chaos

    t0 = time.perf_counter()
    plan = chaos.FaultPlan.default()
    _reset_counts()
    rep = chaos.run_chaos(plan, workdir=f"{root}/chaos", device=dev.type)
    torch.cuda.synchronize()
    launches = _read_counts()
    for kind, v in rep["faults"].items():
        check(v["injected"] >= 1 and v["survived"] == v["injected"],
              f"chaos: {kind} {v}")
    check(rep["nan_detected_round"] == plan.nan_round,
          f"chaos: NaN flagged at {rep['nan_detected_round']}")
    check(rep["straggler_detected_worker"] == plan.straggler_worker
          and rep["straggler_detected_round"] == plan.straggler_round,
          f"chaos: straggler {rep['straggler_detected_worker']} at "
          f"{rep['straggler_detected_round']}")
    check(rep["loss_band_ok"], f"chaos: final loss {rep['final_loss']} vs "
          f"baseline {rep['baseline_final_loss']} +/- {rep['loss_band']}")
    dt = rep["decode_tokens"]
    check(dt["resumed"] == dt["expected"] == dt["after"] and dt["expected"],
          f"chaos: decode tokens {dt}")
    check(launches.get("flash_fwd", 0) > 0 and launches.get("decode_attention", 0) > 0,
          f"chaos: attention launches {launches}")
    co = rep["collector_outage"]
    check(co["events_lost"] == co["events_dropped"] == 0
          and co["push_failures"] > 0, f"chaos: collector outage {co}")
    print(f"[{card}] run_chaos (default plan, W="
          f"{plan.workers}, {plan.rounds} rounds): {rep['faults_survived']} of "
          f"{rep['faults_injected']} injected faults survived "
          f"({len(rep['faults'])} kinds); NaN flagged at round "
          f"{rep['nan_detected_round']}; straggler worker "
          f"{rep['straggler_detected_worker']} at round "
          f"{rep['straggler_detected_round']}; final loss {rep['final_loss']} "
          f"vs baseline {rep['baseline_final_loss']} (band {rep['loss_band']}); "
          f"decode kill resumed {len(dt['resumed'])} tokens identical; recovery "
          f"latency {rep['recovery_latency_s']} s; slow slice saved "
          f"{rep['slow_slice']['wallclock_saved_s']} s of "
          f"{rep['slow_slice']['tail_injected_s']}; collector outage: "
          f"{co['push_failures']} push failure(s), "
          f"{co['events_replayed_after_resume']} events replayed, 0 lost; "
          f"launches {launches}; wall "
          f"{time.perf_counter() - t0:.2f} s")
    return launches


def staleness_profile_chaos_end_to_end(dev, card, root):
    """Phase 16 (see the module doc): runs in phase 11's temporary
    directory (its record DBs and seeded CaffeNet weights).  Returns the
    launches of its main paths."""
    t0 = time.perf_counter()
    warm = f"{root}/caffenet_seed1.caffemodel"
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    add(stale_trainer_end_to_end(dev, card, warm))
    add(stale_db_end_to_end(dev, card, root, warm))
    add(kill_sweep(dev, card, root))
    add(profiler_end_to_end(dev, card, root, warm))
    add(cli_time_end_to_end(dev, card))
    add(chaos_end_to_end(dev, card, root))
    print(f"[{card}] phase 16 wall {time.perf_counter() - t0:.2f} s; launches "
          f"{launches}")
    return launches


# ----------------------------------------------------------------------
# phase 17: bf16 training through the Solver — K6, K7 and K8 in bf16,
# bench.py's protocol, the fused AlexNet round, the cifar10_full curve,
# GoogLeNet through the DB app, and debug_info
# ----------------------------------------------------------------------
# the bf16 kernels' cases: AlexNet's two LRN inputs at the training batch
# (random and tied) and an odd shape
BF16_TRAIN_LRN = ALEXNET_LRN + ((3, 7, 11, 13),)
# bench.py's training protocol (bench.py:379-415): CaffeNet at full
# width, one seeded host batch, step_repeat tau 20; the device time is
# read from a shorter window under torch.profiler
BENCH_BATCH, BENCH_TAU, BENCH_PROFILED_TAU = 256, 20, 5
# CaffeNet's two LRN inputs at that batch: where (b) launches K5 and K6
# in bf16, held bit for bit too (K7 and K8 run at AlexNet's batch 32)
BENCH_LRN = ((BENCH_BATCH, 96, 55, 55), (BENCH_BATCH, 256, 27, 27))
# the first iteration's loss in bf16 against float32 (the same weights
# and batch; CaffeNet's loss at init is ~ln 1000 = 6.9): relative, bf16
# keeps 8 bits (2^-8 = 0.4%) and the loss sums through eight layers
BENCH_LOSS_RTOL = 2e-2
# the fused AlexNet legs (W=2, tau 4, batch 32, 3 rounds)
BF16_IMNET_ROUNDS = 3
# the cifar10_full curve of the JAX slow test
# (tests/test_solver.py:329): batch 25, 200 iterations, tau 20.  Its
# asserts: both runs learn (tail window < 0.8 of the head window), the
# bf16 tail below 1.25 x float32's + 0.05, and each window of the first
# half within 10% of float32's.  Its docstring's "tail windows within
# 5%" is not among them: on this synthetic data both runs overfit and
# their tails part (on the CPU, float32 0.167 and bf16 0.052); the gap
# is printed beside 5%
CURVE_BATCH, CURVE_ITERS, CURVE_TAU = 25, 200, 20
CURVE_LEARN, CURVE_TAIL, CURVE_TAIL_ABS, CURVE_HALF_RTOL = 0.8, 1.25, 0.05, 0.10
CURVE_DOC_RTOL = 0.05
# GoogLeNet through imagenet_run_db_app on phase 11's DB
GOOGLENET_DB_ROUNDS = 2
# debug_info's values on the card against the CPU run of the same
# window: relative, float32 on both sides summed in other orders
# (convolutions through cuDNN, TF32 off), each a mean of |x| over a blob
DEBUG_RTOL = 1e-3


def check_lrn_bf16_train(dev, card):
    """K6, K7 and K8 in bfloat16 against their plain versions (the float32
    ones on the widened inputs, narrowed once), bit for bit, at
    ``BF16_TRAIN_LRN`` random and tied, and K5 and K6 so at ``BENCH_LRN``;
    then each timed over both AlexNet sandwiches beside its plain version
    and the PyTorch call for the same function in bf16, with its bound at
    2-byte I/O.  Returns the three kernels-line records (launches filled
    in by the training legs)."""
    import torch.nn.functional as F

    from sparknet_tpu_torch.ops import cuda_lrn as cl
    from sparknet_tpu_torch.ops import cuda_plp as cp

    gen = torch.Generator().manual_seed(17)
    bf = torch.bfloat16
    err = dict.fromkeys(("lrn_bwd_bf16", "lrn_pool_fwd_bf16",
                         "lrn_pool_bwd_bf16"), 0.0)
    for shape, ties in [(s, t) for s in BF16_TRAIN_LRN for t in (False, True)]:
        x = (_tie_input(dev, shape, 8) if ties
             else torch.randn(*shape, generator=gen).to(dev) * 3).to(bf)
        dy = torch.randn(*shape, generator=gen).to(dev).to(bf)
        dp = torch.randn(shape[0], shape[1], *cp.pooled_hw(*shape[2:]),
                         generator=gen).to(dev).to(bf)
        got = {"lrn_bwd_bf16": cl.lrn_bwd(x, dy, *LRN_HP),
               "lrn_pool_fwd_bf16": cp.lrn_pool_fwd(x, *LRN_HP),
               "lrn_pool_bwd_bf16": cp.lrn_pool_bwd(x, dp, *LRN_HP)}
        want = {"lrn_bwd_bf16": cl.lrn_bwd_bf16_reference(x, dy, *LRN_HP),
                "lrn_pool_fwd_bf16": cp.lrn_maxpool_bf16_reference(x, *LRN_HP),
                "lrn_pool_bwd_bf16": cp.lrn_maxpool_bwd_bf16_reference(
                    x, dp, *LRN_HP)}
        torch.cuda.synchronize()
        for name in got:
            check(got[name].dtype == bf, f"{name} {shape}: {got[name].dtype}")
            diff = float((got[name].float() - want[name].float()).abs().max())
            check(bool(torch.equal(got[name], want[name])),
                  f"{name} {shape}{' ties' if ties else ''}: differs from "
                  f"the plain version's bits (max |diff| {diff:.3e})")
            err[name] = max(err[name], diff)
        print(f"K6/K7/K8 bf16 {shape}{' ties' if ties else ''}: bit-equal "
              "to the plain versions")
    dgen = torch.Generator(device=dev).manual_seed(18)
    for shape, ties in [(s, t) for s in BENCH_LRN for t in (False, True)]:
        x = (_tie_input(dev, shape, 9) if ties else
             torch.randn(shape, generator=dgen, device=dev) * 3).to(bf)
        dy = torch.randn(shape, generator=dgen, device=dev).to(bf)
        y, dx = cl.lrn_fwd(x, *LRN_HP), cl.lrn_bwd(x, dy, *LRN_HP)
        torch.cuda.synchronize()
        for name, got, want in (
                ("lrn_fwd_bf16", y, cl.lrn_fwd_bf16_reference(x, *LRN_HP)),
                ("lrn_bwd_bf16", dx,
                 cl.lrn_bwd_bf16_reference(x, dy, *LRN_HP))):
            check(got.dtype == bf and bool(torch.equal(got, want)),
                  f"{name} {shape}{' ties' if ties else ''}: differs from the "
                  "plain version's bits (max |diff| "
                  f"{float((got.float() - want.float()).abs().max()):.3e})")
        print(f"K5/K6 bf16 {shape}{' ties' if ties else ''}: bit-equal to the "
              "plain versions")
        del x, dy, y, dx

    xs = [(torch.randn(*s, generator=gen) * 3).to(dev).to(bf)
          for s in ALEXNET_LRN]
    dys = [torch.randn(*s, generator=gen).to(dev).to(bf) for s in ALEXNET_LRN]
    dps = [torch.randn(s[0], s[1], *cp.pooled_hw(*s[2:]), generator=gen)
           .to(dev).to(bf) for s in ALEXNET_LRN]
    xg = [x.clone().requires_grad_(True) for x in xs]
    n, alpha, beta, k = LRN_HP

    def lib_lrn(v):
        return F.local_response_norm(v, n, alpha=alpha, beta=beta, k=k)

    def lib_pool(v):
        return F.max_pool2d(lib_lrn(v), 3, 2)

    def each(fn):
        return lambda: [fn(i) for i in range(len(xs))]

    def lib_bwd(fwd, cot):
        return each(lambda i: torch.autograd.grad(fwd(xg[i]), xg[i], cot[i]))

    elems = [x.numel() for x in xs]
    pel = [d.numel() for d in dps]
    # bytes at 2-byte I/O: each input read once, each output written
    # once; operations as phase 8 counts them (float32 math)
    cases = {
        "lrn_bwd_bf16": ("K6", "sparknet_tpu_torch/ops/csrc/lrn.cu",
                         "sparknet_tpu/ops/pallas_lrn.py:70",
                         each(lambda i: cl.lrn_bwd(xs[i], dys[i], *LRN_HP)),
                         each(lambda i: cl.lrn_bwd_bf16_reference(
                             xs[i], dys[i], *LRN_HP)),
                         lib_bwd(lib_lrn, dys), each(lambda i: lib_lrn(xg[i])),
                         sum(3 * 2 * e for e in elems),
                         sum((3 * n + 16) * e for e in elems)),
        "lrn_pool_fwd_bf16": ("K7", "sparknet_tpu_torch/ops/csrc/lrn_pool.cu",
                              "sparknet_tpu/ops/pallas_plp.py:148",
                              each(lambda i: cp.lrn_pool_fwd(xs[i], *LRN_HP)),
                              each(lambda i: cp.lrn_maxpool_bf16_reference(
                                  xs[i], *LRN_HP)),
                              each(lambda i: lib_pool(xs[i])), None,
                              sum(2 * e for e in elems) + sum(2 * p for p in pel),
                              sum((n + 7) * e for e in elems)
                              + sum(8 * p for p in pel)),
        "lrn_pool_bwd_bf16": ("K8", "sparknet_tpu_torch/ops/csrc/lrn_pool.cu",
                              "sparknet_tpu/ops/pallas_plp.py:166",
                              each(lambda i: cp.lrn_pool_bwd(xs[i], dps[i],
                                                             *LRN_HP)),
                              each(lambda i: cp.lrn_maxpool_bwd_bf16_reference(
                                  xs[i], dps[i], *LRN_HP)),
                              lib_bwd(lib_pool, dps),
                              each(lambda i: lib_pool(xg[i])),
                              sum(2 * 2 * e for e in elems)
                              + sum(2 * p for p in pel),
                              sum((3 * n + 16) * e for e in elems)
                              + sum(16 * p for p in pel)),
    }
    f32 = {"lrn_bwd_bf16": each(lambda i: cl.lrn_bwd(
               xs[i].float(), dys[i].float(), *LRN_HP)),
           "lrn_pool_fwd_bf16": each(lambda i: cp.lrn_pool_fwd(
               xs[i].float(), *LRN_HP)),
           "lrn_pool_bwd_bf16": each(lambda i: cp.lrn_pool_bwd(
               xs[i].float(), dps[i].float(), *LRN_HP))}
    shape = " + ".join(str(s) for s in ALEXNET_LRN) + " bf16"
    checked = {"lrn_bwd_bf16": "; bit-equal also at "
               + " + ".join(str(s) for s in BENCH_LRN)}
    records = []
    for name, (tag, src, replaces, kern, plain, lib, lib_fwd, nbytes,
               ops) in cases.items():
        b, by = bound_ms(nbytes, ops)
        library = device_ms(lib) - (device_ms(lib_fwd) if lib_fwd else 0.0)
        rec = dict(name=name, route="cuda", source=src, replaces=replaces,
                   max_abs_err=err[name], bound_ms=b, bound_by=by,
                   library_ms=library, shape=shape + checked.get(name, ""),
                   ms=device_ms(kern),
                   plain_ms=device_ms(plain))
        f32_ms = device_ms(f32[name])
        print(f"[{card}] {tag} {name} [{shape}, both sandwiches]: kernel "
              f"{rec['ms']:.4f} ms on device, plain {rec['plain_ms']:.4f} ms, "
              f"library (bf16) {library:.4f} ms, bound {b * 1e3:.3f} us ({by}, "
              f"{nbytes} bytes) -> {b / rec['ms']:.1%} of the bound; the "
              f"float32 kernel on the widened inputs {f32_ms:.4f} ms")
        records.append(rec)
    return records


def _bench_solver(dev, dtype):
    from sparknet_tpu_torch import config, models
    from sparknet_tpu_torch.solver import Solver

    shapes = [(BENCH_BATCH, 3, 227, 227), (BENCH_BATCH,)]
    netp = config.replace_data_layers(models.load_model("caffenet"), shapes,
                                      shapes)
    return Solver(models.load_model_solver("caffenet"), net_param=netp,
                  device=dev, compute_dtype=dtype)


def bench_protocol_end_to_end(dev, card):
    """(b) bench.py's training protocol on the card: CaffeNet at full
    width (1,000 classes, crop 227, batch 256), ``step_repeat`` tau 20 on
    one seeded batch, in bf16 and in float32.  Prints images/s, device
    time and busy share (``torch.profiler``) and peak memory; checks the
    masters stay float32, K5 and K6 launch in bf16 twice an iteration
    (CaffeNet's two LRNs) and the first iteration's bf16 loss lies within
    ``BENCH_LOSS_RTOL`` of float32's.  Returns the bf16 window's
    launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sparknet_tpu_torch.utils.tree import tree_leaves

    rs = np.random.RandomState(0)  # bench.py's _host_batch
    batch = {"data": rs.randn(BENCH_BATCH, 3, 227, 227).astype(np.float32),
             "label": rs.randint(0, 1000, BENCH_BATCH).astype(np.float32)}
    first, counts = {}, {}
    for dtype in ("bfloat16", None):
        label = dtype or "float32"
        solver = _bench_solver(dev, dtype)
        state = solver.init_state(seed=0)
        state, losses = solver.step_repeat(state, batch, tau=BENCH_TAU)  # warm
        first[label] = float(losses[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        t0 = time.perf_counter()
        state, losses = solver.step_repeat(state, batch, tau=BENCH_TAU)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[label] = _read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        check(all(t.dtype == torch.float32 for t in tree_leaves(state.params))
              and all(t.dtype == torch.float32
                      for t in tree_leaves(state.history)),
              f"{label}: masters or history left float32")
        check(bool(torch.isfinite(losses).all()), f"{label}: loss not finite")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = solver.step_repeat(state, batch, tau=BENCH_PROFILED_TAU)
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
        busy /= BENCH_PROFILED_TAU  # device ms an iteration
        check(busy > 0, f"{label}: the profiler saw no device time")
        print(f"[{card}] bench protocol CaffeNet batch {BENCH_BATCH} "
              f"{label}: {BENCH_BATCH * BENCH_TAU / wall:.1f} images/s "
              f"({wall * 1e3 / BENCH_TAU:.3f} ms an iteration, wall), device "
              f"{busy:.3f} ms an iteration (profiled window of "
              f"{BENCH_PROFILED_TAU}, busy "
              f"{busy * BENCH_TAU / (wall * 1e3):.1%} "
              f"of the timed window's wall an iteration), peak "
              f"memory {peak / 2**30:.2f} GiB, losses {float(losses[0]):.4f} "
              f"-> {float(losses[-1]):.4f}")
        del solver, state
    bf, f32 = counts["bfloat16"], counts["float32"]
    check(bf["lrn_fwd_bf16"] == bf["lrn_bwd_bf16"] == 2 * BENCH_TAU
          and bf["lrn_fwd"] == bf["lrn_bwd"] == 0,
          f"bench bf16 window: launches {bf}")
    check(f32["lrn_fwd"] == f32["lrn_bwd"] == 2 * BENCH_TAU
          and f32["lrn_fwd_bf16"] == f32["lrn_bwd_bf16"] == 0,
          f"bench float32 window: launches {f32}")
    gap = abs(first["bfloat16"] - first["float32"]) / first["float32"]
    print(f"[{card}] bench protocol first-iteration loss: bf16 "
          f"{first['bfloat16']:.5f}, float32 {first['float32']:.5f} "
          f"({gap:.2e} relative, band {BENCH_LOSS_RTOL})")
    check(gap <= BENCH_LOSS_RTOL, "bf16 first loss outside its band")
    return {k: v for k, v in bf.items() if k.endswith("_bf16")}


def _alexnet_fused_leg(dev, dtype):
    """AlexNet under SPARKNET_FUSION=1 through the averaging trainer,
    W=2, tau 4, batch 32, crop 227, ``BF16_IMNET_ROUNDS`` rounds on
    seeded batches made on the card, then one more round under
    ``torch.profiler``.  Returns the smoothed loss after each counted
    round, their launches and the profiled round's (wall ms, device
    busy ms, kernel launches, K7 ms, K8 ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sparknet_tpu_torch import config, models
    from sparknet_tpu_torch.parallel import ParameterAveragingTrainer
    from sparknet_tpu_torch.solver import Solver

    shapes = [(IMNET_BATCH, 3, IMNET_CROP, IMNET_CROP), (IMNET_BATCH,)]
    netp = config.replace_data_layers(models.load_model("alexnet"), shapes,
                                      shapes)
    before = os.environ.get("SPARKNET_FUSION")
    os.environ["SPARKNET_FUSION"] = "1"  # read when the net is built
    try:
        solver = Solver(models.load_model_solver("alexnet"), net_param=netp,
                        device=dev, compute_dtype=dtype)
    finally:
        if before is None:
            del os.environ["SPARKNET_FUSION"]
        else:
            os.environ["SPARKNET_FUSION"] = before
    check(len(solver.net._plp_fused) == 2, "AlexNet: both sandwiches fused")
    trainer = ParameterAveragingTrainer(solver, IMNET_W)
    state = trainer.init_state(seed=0)
    smoothed = []

    def batches(r):
        g = torch.Generator(device=dev).manual_seed(1700 + r)
        return {"data": torch.randn((IMNET_W, IMNET_TAU, IMNET_BATCH, 3,
                                     IMNET_CROP, IMNET_CROP), generator=g,
                                    device=dev),
                "label": torch.randint(0, 1000, (IMNET_W, IMNET_TAU,
                                                 IMNET_BATCH),
                                       generator=g, device=dev).float()}

    _reset_counts()
    for r in range(BF16_IMNET_ROUNDS):
        state, _ = trainer.round(state, batches(r))
        smoothed.append(solver.smoothed_loss)
    launches = _read_counts()
    extra = batches(BF16_IMNET_ROUNDS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.round(state, extra)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    check(busy > 0, "AlexNet fused round: the profiler saw no device time")
    k7, k8 = (sum(r[0] for r in rows if kern in r[2])
              for kern in ("lrn_pool_fwd_kernel", "lrn_pool_bwd_kernel"))
    return smoothed, launches, (wall, busy, sum(r[1] for r in rows), k7, k8)


def alexnet_fused_bf16_end_to_end(dev, card):
    """(c) the fused AlexNet round in bf16 and float32: K7 and K8 launch
    in bf16 once a sandwich a step, and the bf16 leg's smoothed losses lie
    within ``LOSS_BAND`` of the float32 leg's.  Returns the bf16 leg's
    launches."""
    from sparknet_tpu_torch.parallel.comm import LOSS_BAND

    steps = IMNET_W * IMNET_TAU * BF16_IMNET_ROUNDS
    legs = {}
    for dtype in ("bfloat16", None):
        t0 = time.perf_counter()
        legs[dtype or "float32"] = _alexnet_fused_leg(dev, dtype)
        print(f"[{card}] AlexNet fused {dtype or 'float32'} leg (W={IMNET_W}, "
              f"tau {IMNET_TAU}, batch {IMNET_BATCH}, {BF16_IMNET_ROUNDS} "
              f"rounds): {time.perf_counter() - t0:.2f} s wall, smoothed "
              f"losses {legs[dtype or 'float32'][0]}")
    for label, (_, _, (wall, busy, n, k7, k8)) in legs.items():
        print(f"[{card}] AlexNet fused {label} round (profiled): {wall:.3f} ms "
              f"wall, {busy:.3f} ms device busy ({busy / wall:.1%}), {n} "
              f"kernel launches; K7 {k7:.4f} ms, K8 {k8:.4f} ms")
    (s16, l16, _), (s32, l32, _) = legs["bfloat16"], legs["float32"]
    check(l16["lrn_pool_fwd_bf16"] == 2 * steps
          and l16["lrn_pool_bwd_bf16"] == 2 * steps
          and l16["lrn_pool_fwd"] == l16["lrn_pool_bwd"] == 0
          and l16["lrn_fwd"] == l16["lrn_bwd"] == 0,
          f"AlexNet fused bf16: launches {l16}")
    check(l32["lrn_pool_fwd"] == 2 * steps and l32["lrn_pool_bwd"] == 2 * steps
          and l32["lrn_pool_fwd_bf16"] == 0,
          f"AlexNet fused float32: launches {l32}")
    gap = max(abs(a - b) for a, b in zip(s16, s32))
    check(all(np.isfinite(s16)) and gap <= LOSS_BAND,
          f"AlexNet fused bf16 smoothed losses {s16} vs float32 {s32}")
    print(f"[{card}] AlexNet fused bf16 vs float32: max smoothed-loss gap "
          f"{gap:.4f} (LOSS_BAND {LOSS_BAND}); K7/K8 bf16 launches "
          f"{l16['lrn_pool_fwd_bf16']}/{l16['lrn_pool_bwd_bf16']}")
    return {k: v for k, v in l16.items() if k.endswith("_bf16")}


def cifar_curve_end_to_end(dev, card, root):
    """(d) the JAX slow test's evidence on the card: cifar10_full, batch
    25, 200 iterations, tau 20, bf16 and float32 from one init on the
    same synthesized CIFAR minibatches, held to the test's asserts
    (``CURVE_*``); the tails' relative gap printed beside its
    docstring's 5%."""
    from sparknet_tpu_torch import config, models
    from sparknet_tpu_torch.data import CifarLoader
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.utils import rngs

    d = f"{root}/cifar_curve"
    CifarLoader.write_synthetic(d, num_train=CURVE_BATCH * 10,
                                num_test=CURVE_BATCH)
    x, y = CifarLoader(d, seed=0).minibatches(CURVE_BATCH, train=True)
    shapes = [(CURVE_BATCH, 3, 32, 32), (CURVE_BATCH,)]
    curves = {}
    for dtype in (None, "bfloat16"):
        netp = config.replace_data_layers(models.load_model("cifar10_full"),
                                          shapes, shapes)
        solver = Solver(models.load_model_solver("cifar10_full"),
                        net_param=netp, device=dev, compute_dtype=dtype)
        st = solver.init_state(seed=0)
        losses = []
        t0 = time.perf_counter()
        for r in range(CURVE_ITERS // CURVE_TAU):
            idx = [(r * CURVE_TAU + t) % len(x) for t in range(CURVE_TAU)]
            st, ls = solver.step(st, {"data": np.stack([x[i] for i in idx]),
                                      "label": np.stack([y[i] for i in idx])},
                                 rng=rngs.train_key(r))
            losses.append(ls)
        curves[dtype or "float32"] = torch.cat(losses).float().cpu().numpy()
        print(f"[{card}] cifar10_full {dtype or 'float32'} curve: "
              f"{time.perf_counter() - t0:.2f} s for {CURVE_ITERS} iterations")
    f32, b16 = curves["float32"], curves["bfloat16"]
    head32, tail32 = f32[:CURVE_TAU].mean(), f32[-CURVE_TAU:].mean()
    head16, tail16 = b16[:CURVE_TAU].mean(), b16[-CURVE_TAU:].mean()
    gap = abs(tail16 - tail32) / tail32
    half = [abs(b16[w * CURVE_TAU:(w + 1) * CURVE_TAU].mean()
                - f32[w * CURVE_TAU:(w + 1) * CURVE_TAU].mean())
            / f32[w * CURVE_TAU:(w + 1) * CURVE_TAU].mean()
            for w in range(CURVE_ITERS // CURVE_TAU // 2)]
    print(f"[{card}] cifar10_full curve: float32 head {head32:.4f} tail "
          f"{tail32:.4f}, bf16 head {head16:.4f} tail {tail16:.4f}; tails "
          f"{gap:.2%} apart ({'within' if gap <= CURVE_DOC_RTOL else 'outside'}"
          f" {CURVE_DOC_RTOL:.0%}); first-half windows at most "
          f"{max(half):.2%} apart (limit {CURVE_HALF_RTOL:.0%})")
    check(tail32 < CURVE_LEARN * head32 and tail16 < CURVE_LEARN * head16,
          "cifar10_full: a run did not learn")
    check(tail16 < CURVE_TAIL * tail32 + CURVE_TAIL_ABS,
          "cifar10_full: the bf16 tail is worse than float32's")
    check(max(half) < CURVE_HALF_RTOL,
          "cifar10_full: a first-half window of bf16 is off float32's")


def googlenet_db_end_to_end(dev, card, root):
    """(e) GoogLeNet through ``imagenet_run_db_app --model googlenet`` on
    phase 11's CaffeNet DB (1,000 classes, crop 227), W=2, tau 4, 2
    rounds, profiled: finite losses, K5 and K6 launched twice a step
    (GoogLeNet's two LRNs, K5 also in the tests), each worker's window's
    device time printed.  Returns the launches."""
    from sparknet_tpu_torch.apps import imagenet_run_db_app

    r = {}
    _reset_counts()
    t0 = time.perf_counter()
    check(imagenet_run_db_app.main(
        ["--db_dir", f"{root}/db", "--model", "googlenet", "--device",
         dev.type, "--tau", str(DB_TAU), "--rounds", str(GOOGLENET_DB_ROUNDS),
         "--test_every", str(DB_TEST_EVERY), "--profile"], r) == 0,
        "imagenet_run_db --model googlenet failed")
    wall = time.perf_counter() - t0
    launches = _read_counts()
    want = _db_launches(GOOGLENET_DB_ROUNDS, 0)
    check(bool(np.isfinite(np.asarray(r["losses"], np.float64)).all()),
          f"GoogLeNet DB losses {r['losses']}")
    check(launches["lrn_fwd"] == want["lrn_fwd"]
          and launches["lrn_bwd"] == want["lrn_bwd"],
          f"GoogLeNet DB launches {launches}, expected K5 {want['lrn_fwd']} "
          f"and K6 {want['lrn_bwd']}")
    prof = r.get("profile") or {}
    print(f"[{card}] imagenet_run_db_app --model googlenet (W={DB_W}, tau "
          f"{DB_TAU}, batch {DB_BATCH}, {GOOGLENET_DB_ROUNDS} rounds): {wall:.2f} "
          f"s wall; worker window device ms {prof.get('worker_execute_ms')}; "
          f"K5 {launches['lrn_fwd']}, K6 {launches['lrn_bwd']}; final "
          f"accuracy {r['accuracies'][-1] if r.get('accuracies') else None}")
    return {k: launches[k] for k in ("lrn_fwd", "lrn_bwd")}


def debug_info_end_to_end(dev, card):
    """(f) ``debug_info`` on one cifar10_quick window on the card and on
    the CPU from the same weights and batch: the same lines in the same
    order, every value within ``DEBUG_RTOL``."""
    from sparknet_tpu_torch import config, models
    from sparknet_tpu_torch.solver import Solver, TrainState
    from sparknet_tpu_torch.utils.tree import tree_map

    shapes = [(8, 3, 32, 32), (8,)]
    netp = config.replace_data_layers(models.load_model("cifar10_quick"),
                                      shapes, shapes)
    sp = models.load_model_solver("cifar10_quick")
    sp.debug_info = True
    rs = np.random.RandomState(17)
    batch = {"data": rs.randn(2, 8, 3, 32, 32).astype(np.float32),
             "label": rs.randint(0, 10, (2, 8)).astype(np.float32)}
    lines = {}
    cpu = Solver(sp, net_param=netp, device="cpu")
    init = cpu.init_state(seed=0)
    for where in ("cpu", dev):
        solver = cpu if where == "cpu" else Solver(sp, net_param=netp,
                                                   device=dev)
        st = TrainState(*(tree_map(lambda t: t.to(where), f)
                          for f in init[:3]), init.iter)
        out = []
        solver.debug_info_pass(st, {k: v[0] for k, v in batch.items()},
                               log=out.append)
        lines[str(where)] = out
    got, want = lines[str(dev)], lines["cpu"]
    heads = [(line.rpartition(": ")[0].split(" data:")[0]) for line in got]
    check(heads == [line.rpartition(": ")[0].split(" data:")[0]
                    for line in want] and len(got) > 20,
          "debug_info: the card's lines differ from the CPU's")
    worst = 0.0
    for a, b in zip(got, want):
        va = [float(v) for v in re.findall(r": ([-\d.e+]+)", a)]
        vb = [float(v) for v in re.findall(r": ([-\d.e+]+)", b)]
        for p, q in zip(va, vb):
            rel = abs(p - q) / max(abs(q), 1e-12)
            worst = max(worst, rel)
    print(f"[{card}] debug_info on cifar10_quick: {len(got)} lines, the "
          f"CPU's names in its order; values within {worst:.2e} relative "
          f"(limit {DEBUG_RTOL})")
    check(worst <= DEBUG_RTOL, "debug_info values off the CPU's")


def bf16_training_end_to_end(dev, card, root):
    """Phase 17 (see the module doc): (a) runs before training, as the
    kernels' checks do; the rest in phase 11's temporary directory.
    Returns the launches of its main paths."""
    t0 = time.perf_counter()
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    add(bench_protocol_end_to_end(dev, card))
    add(alexnet_fused_bf16_end_to_end(dev, card))
    cifar_curve_end_to_end(dev, card, root)
    add(googlenet_db_end_to_end(dev, card, root))
    debug_info_end_to_end(dev, card)
    print(f"[{card}] phase 17 wall {time.perf_counter() - t0:.2f} s; launches "
          f"{launches}")
    return launches


# ----------------------------------------------------------------------
# phase 18: the sequence ring on K1/K3/K4, lm_app --sp, the Attention
# layer, and SparkNet's averaging loop across processes
# ----------------------------------------------------------------------
# (B, T, H, D, sp) of the stacked rings held to their plain versions
RING_SHAPES = ((2, 4096, 4, 64, 4), (2, 1024, 2, 256, 2))
# the ring against sp=1 flash_attention at the same T: float32 partials
# merged online in another order than one kernel's tiles
RING_SP1_TOL = LM_TOL
LM_SP, LM_SP_ROUNDS = 2, 2
# the Attention-layer net's gradients, card against CPU, relative to
# the largest gradient of each blob
ATTN_NET_TOL = 1e-4
ATTN_NET = """
layer { name: "d" type: "HostData" top: "x"
  java_data_param { shape { dim: 2 dim: 256 dim: 256 } } }
layer { name: "attn1" type: "Attention" bottom: "x" top: "h"
  attention_param { num_heads: 4 causal: true } }
layer { name: "attn2" type: "Attention" bottom: "h" top: "y"
  attention_param { num_heads: 4 causal: true } }
layer { name: "red" type: "Reduction" bottom: "y" top: "loss"
  loss_weight: 1.0 reduction_param { operation: SUMSQ axis: 0 } }
"""
MP_ROUNDS = 2
MP_TIMEOUT_S = 300


def _ring_run(fn, q, k, v, do):
    """``fn``'s output and q/k/v gradients under the cotangent ``do``."""
    ts = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fn(*ts)
    out.backward(do)
    return [out.detach()] + [t.grad for t in ts]


def _plain_flash_step(q, k, v, q_offset, k_offset, causal=False):
    """``flash_attention_step`` on the plain version (dense, under
    autograd), for the ring on the card without its kernels."""
    from sparknet_tpu_torch.ops import cuda_attention as ca

    o, lse = ca._flash_core_reference(q, k, v, q_offset, k_offset, causal)
    return o.permute(0, 2, 1, 3), lse


PROFILE_TRIES = 3


def _profiled_window(fn, n: int = 3):
    """``(wall ms, device-busy ms, {kernel: device ms})`` of one call, each
    the mean over ``n`` calls after a warm one, the device's from a
    CUDA-only ``torch.profiler`` window over ``n`` calls.  CUPTI can hand
    back a short window with no device activity at all; such a window is
    profiled again, up to ``PROFILE_TRIES`` times, then None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = {k: ms / n for ms, _, k in _kernel_rows(prof)}
        if rows:
            return wall, sum(rows.values()), rows
    return None


def check_ring_kernels(dev, card):
    """(a) ``ring_self_attention`` over stacked rings on K1/K3/K4, forward
    and q/k/v grads, causal and not: against the same ring on the plain
    versions and against sp=1 ``flash_attention``; K3's dlse nonzero."""
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.parallel import mesh as pm
    from sparknet_tpu_torch.parallel.ring_attention import (
        masked_pairs, ring_self_attention)

    gen = torch.Generator(device=dev).manual_seed(18)
    real_dq, real_step = ca.flash_bwd_dq, ca.flash_attention_step
    for b, t, h, d, sp in RING_SHAPES:
        q, k, v, do = (torch.randn(b, t, h, d, device=dev, generator=gen)
                       for _ in range(4))
        mesh = pm.make_mesh({"sp": sp}, workers_per_process=sp, device=dev)
        for causal in (True, False):
            fn = ring_self_attention(mesh, "sp", causal=causal)
            norms = []

            def dq_spy(*a, **kw):
                norms.append(float(a[6].norm()))  # dlse
                return real_dq(*a, **kw)

            ca.reset_launch_counts()
            ca.flash_bwd_dq = dq_spy
            try:
                got = _ring_run(fn, q, k, v, do)
            finally:
                ca.flash_bwd_dq = real_dq
            torch.cuda.synchronize()
            n = dict(ca.LAUNCHES)
            check(n["flash_fwd"] == n["flash_bwd_dq"] == n["flash_bwd_dkv"]
                  == sp * sp, f"ring sp={sp}: launches {n}, expected {sp * sp}"
                  " each of K1/K3/K4")
            ca.flash_attention_step = _plain_flash_step
            try:
                plain = _ring_run(fn, q, k, v, do)
            finally:
                ca.flash_attention_step = real_step
            sp1 = _ring_run(lambda q_, k_, v_, c=causal: ca.flash_attention(
                q_, k_, v_, causal=c), q, k, v, do)
            names = ("out", "dq", "dk", "dv")
            e_plain = {nm: max_err(g, p) for nm, g, p in zip(names, got, plain)}
            lim = {nm: max(KERNEL_ATOL, BWD_RTOL * float(p.abs().max()))
                   for nm, p in zip(names, plain)}
            e_sp1 = {nm: max_err(g, s) for nm, g, s in zip(names, got, sp1)}
            what = f"ring sp={sp} B={b} T={t} H={h} D={d} causal={causal}"
            print(f"{what}: vs plain ring " + ", ".join(
                f"{nm} {e_plain[nm]:.3e} (limit {lim[nm]:.1e})" for nm in names)
                + "; vs sp=1 flash_attention " + ", ".join(
                f"{nm} {e_sp1[nm]:.3e}" for nm in names)
                + f" (limit {RING_SP1_TOL}); K3 dlse norm max {max(norms):.4e}")
            for nm in names:
                check(e_plain[nm] <= lim[nm], f"{what}: {nm} vs the plain ring "
                      f"{e_plain[nm]:.3e} > {lim[nm]:.1e}")
                check(e_sp1[nm] <= RING_SP1_TOL, f"{what}: {nm} vs sp=1 "
                      f"{e_sp1[nm]:.3e} > {RING_SP1_TOL}")
            check(max(norms) > 0, f"{what}: K3 saw no nonzero dlse")
            if causal:
                pairs = masked_pairs(sp, True)
                print(f"{what}: {len(pairs)} fully masked (query shard, ring "
                      f"step) pairs, computed not skipped: {pairs}")
            ring_ms = time_ms(lambda: _ring_run(fn, q, k, v, do), iters=5,
                              warm=2)
            sp1_ms = time_ms(lambda c=causal: _ring_run(
                lambda q_, k_, v_: ca.flash_attention(q_, k_, v_, causal=c),
                q, k, v, do), iters=5, warm=2)
            print(f"[{card}] {what}: forward+backward {ring_ms:.4f} ms the "
                  f"ring ({sp * sp} steps), {sp1_ms:.4f} ms sp=1 "
                  "flash_attention (CUDA events; a reading, not a claim)")
            # where the ring's time goes: a window of calls of each under
            # the profiler, the device's busy share and K1/K3/K4's part
            for leg, call in (("ring", lambda: _ring_run(fn, q, k, v, do)),
                              ("sp=1", lambda c=causal: _ring_run(
                                  lambda q_, k_, v_: ca.flash_attention(
                                      q_, k_, v_, causal=c), q, k, v, do))):
                got = _profiled_window(call)
                if got is None:
                    print(f"[{card}] {what} {leg}: the profiler recorded no "
                          f"device work in {PROFILE_TRIES} windows; device "
                          "busy not measured")
                    continue
                wall, busy, rows = got
                kern = sum(ms for name, ms in rows.items() if any(
                    s in name for s in ("flash_fwd_kernel",
                                        "flash_bwd_dq_kernel",
                                        "flash_bwd_dkv_kernel")))
                top = sorted(rows.items(), key=lambda r: -r[1])[:3]
                print(f"[{card}] {what} {leg}: {wall:.3f} ms wall, {busy:.3f} "
                      f"ms device busy ({busy / wall:.1%}), K1/K3/K4 "
                      f"{kern:.3f} ms ({kern / busy:.1%} of busy), "
                      f"{len(rows)} kinds of device work; top "
                      + "; ".join(f"{ms:.3f} ms {name[:60]}"
                                  for name, ms in top))


def lm_sp_end_to_end(dev, card):
    """(b) ``lm_app --sp 2`` at the CLI width against the sp=1 flash leg
    of the same seed; K1/K3/K4 launch depth x W x tau x rounds x sp^2
    each.  Returns the sp leg's launches."""
    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.utils.tree import tree_leaves

    argv = _lm_argv(dev)
    argv[argv.index("--rounds") + 1] = str(LM_SP_ROUNDS)
    res = {}
    for sp in (1, LM_SP):
        res[sp] = {}
        ca.reset_launch_counts()
        rc = lm_app.main(argv + ["--sp", str(sp)], res[sp])
        torch.cuda.synchronize()
        res[sp]["launches"] = dict(ca.LAUNCHES)
        check(rc == 0, f"lm_app --sp {sp} exited {rc}")
    n = LM_MODEL["depth"] * LM_W * LM_TAU * LM_SP_ROUNDS * LM_SP * LM_SP
    got = res[LM_SP]["launches"]
    loss_gap = float(np.abs(res[1]["losses"] - res[LM_SP]["losses"]).max())
    param_gap = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(res[1]["state"].params),
        tree_leaves(res[LM_SP]["state"].params)))
    ring_bytes = res[LM_SP]["metrics"].lm_ring_bytes.value
    print(f"lm_app --sp {LM_SP} (dim {LM_MODEL['dim']}, depth "
          f"{LM_MODEL['depth']}, W={LM_W}, tau {LM_TAU}, {LM_SP_ROUNDS} rounds):"
          f" launches {got} (expected {n} each = depth x W x tau x rounds x "
          f"sp^2), per-round mean loss "
          f"{res[LM_SP]['losses'].mean(axis=(1, 2)).round(4).tolist()}; vs "
          f"sp=1: losses {loss_gap:.3e}, params {param_gap:.3e} (limit "
          f"{LM_TOL}); sparknet_lm_ring_hop_bytes_total {ring_bytes:.0f}")
    for sp in (1, LM_SP):
        rs = np.array(res[sp]["round_seconds"][1:])
        print(f"[{card}] lm_app --sp {sp}: round {rs.mean() * 1e3:.2f} ms "
              f"(round 1), {res[sp]['tokens_per_round'] / rs.mean():.1f} "
              "tokens/s")
    check(got == dict(flash_fwd=n, flash_bwd_dq=n, flash_bwd_dkv=n,
                      decode_attention=0), f"lm_app --sp: launches {got}")
    check(bool(np.isfinite(res[LM_SP]["losses"]).all()), "lm --sp: NaN loss")
    check(loss_gap <= LM_TOL and param_gap <= LM_TOL,
          f"lm_app --sp {LM_SP} left the sp=1 trajectory: losses {loss_gap}, "
          f"params {param_gap}")
    check(ring_bytes == res[LM_SP]["lm"].ring_hop_bytes_per_iter(LM_BATCH)
          * LM_TAU * LM_W * LM_SP_ROUNDS, "ring hop bytes counter")
    return got


def attention_layer_end_to_end(dev, card):
    """(c) A two-layer ``Attention`` net (E=256, 4 heads, causal): its
    forward and gradients on the card (K1/K3/K4) against the CPU
    (``blockwise_attention``) from one init.  Returns the launches."""
    from sparknet_tpu_torch import config
    from sparknet_tpu_torch.net import TorchNet
    from sparknet_tpu_torch.ops import cuda_attention as ca

    x = torch.from_numpy(np.random.RandomState(18).randn(2, 256, 256)
                         .astype(np.float32) * 0.5)
    runs = {}
    for d in (dev, torch.device("cpu")):
        net = TorchNet(config.parse_net_prototxt(ATTN_NET), phase="TRAIN")
        params, stats = net.init(0, device=d)
        leaves = [b.requires_grad_() for k in sorted(params)
                  for b in params[k]]
        ca.reset_launch_counts()
        loss = net.loss_fn(params, stats, {"x": x.to(d)})[0]
        loss.backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            launches = dict(ca.LAUNCHES)
        runs[d.type] = (float(loss.detach()), [b.grad.cpu() for b in leaves])
    worst = max(float((g - c).abs().max()) / max(float(c.abs().max()), 1e-30)
                for g, c in zip(runs["cuda"][1], runs["cpu"][1]))
    print(f"Attention-layer net (2 layers, E=256, 4 heads, causal, B=2, "
          f"T=256): loss card {runs['cuda'][0]:.6f} cpu {runs['cpu'][0]:.6f};"
          f" gradients within {worst:.3e} of each blob's largest (limit "
          f"{ATTN_NET_TOL}); launches {launches}")
    check(launches == dict(flash_fwd=2, flash_bwd_dq=2, flash_bwd_dkv=2,
                           decode_attention=0),
          f"the Attention net's launches {launches}")
    check(worst <= ATTN_NET_TOL, f"Attention net card vs CPU: {worst:.3e}")
    return launches


def _mp_specs(compress_modes):
    return [dict(net="cifar10_full", workers=2, tau=CIFAR_TAU,
                 batch=CIFAR_BATCH, rounds=MP_ROUNDS, deterministic=True,
                 compress=c) for c in compress_modes]


def _same_as_stacked(ranks, ref, what):
    for r in ranks:
        lo, hi = r["rows"]
        for got, want in zip(r["all_rows"], ref["all_rows"]):
            check(np.array_equal(got, want[lo:hi]),
                  f"{what}: rank rows {lo}:{hi} differ from the stacked run "
                  f"(max {np.abs(got - want[lo:hi]).max():.3e})")
        check(np.array_equal(r["losses"], np.stack(ref["losses"])),
              f"{what}: losses differ from the stacked run")


def multiprocess_end_to_end(dev, card):
    """(d) Two ranks on the one card over gloo, one averaging worker a
    rank (cifar10_full, tau 10, batch 100, 2 rounds, deterministic),
    default and int8, bit for bit against the one-process W=2 stacked
    run (made in the process that then runs (f)); (f) the same rounds with the dp group over NCCL at world size
    1.  Returns the ranks' K9/K10 launches."""
    from sparknet_tpu_torch.utils import procs

    repo = os.path.dirname(os.path.abspath(__file__))
    specs = _mp_specs(("none", "int8"))
    launches = {"comm_encode": 0, "comm_apply_barriered": 0}
    # (f), and the reference: one process runs both W stacked with no
    # group, then joins NCCL at world size 1 and runs them over the group
    nccl, ref, logs = procs.run_averaging_processes(
        specs, repo, nprocs=1, device="cuda", timeout=MP_TIMEOUT_S,
        stacked_first=True)
    print("NCCL at world size 1: " + "; ".join(
        ln for o in logs for ln in o.splitlines() if "joined" in ln))
    check("over nccl" in logs[0], "the world-size-1 rank did not join NCCL")
    for spec, ranks, r in zip(specs, nccl, ref):
        _same_as_stacked(ranks, r, f"NCCL world 1, W=2, {spec['compress']}")
        for k in launches:
            launches[k] += ranks[0]["launches"][k]
    print(f"[{card}] NCCL at world size 1, W=2 stacked, dp group over NCCL: "
          f"bit for bit the run with no group (none and int8); bytes a round "
          f"{nccl[1][0]['group_bytes']}")
    got, _, logs = procs.run_averaging_processes(
        specs, repo, nprocs=2, device="cuda:0", backend="gloo",
        timeout=MP_TIMEOUT_S)
    joined = [ln for o in logs for ln in o.splitlines() if "joined" in ln]
    print("two ranks on one card: " + "; ".join(joined))
    check(all("over gloo" in ln for ln in joined) and len(joined) == 2,
          f"the ranks did not join over gloo: {joined}")
    for spec, ranks, r in zip(specs, got, ref):
        what = f"2 ranks x 1 worker, {spec['compress']}"
        _same_as_stacked(ranks, r, what)
        chunks = ranks[0]["chunks"]
        want = chunks * MP_ROUNDS if spec["compress"] != "none" else 0
        for rk in ranks:
            n = rk["launches"]
            check(n["comm_encode"] == want and n["comm_apply_barriered"] == want
                  and n["comm_apply_correction"] == 0,
                  f"{what}: rank launches {n}, expected {want} K9 and K10 "
                  f"({chunks} chunks x {MP_ROUNDS} rounds)")
            for k in launches:
                launches[k] += n[k]
        print(f"[{card}] {what}: bit for bit the one-process W=2 run; K9/K10 "
              f"{[rk['launches']['comm_encode'] for rk in ranks]}/"
              f"{[rk['launches']['comm_apply_barriered'] for rk in ranks]} a "
              f"rank; bytes that crossed the group a round "
              f"{ranks[0]['group_bytes']}; host staging "
              f"{[round(rk['staging_ms'], 3) for rk in ranks]} ms over "
              f"{MP_ROUNDS} rounds ({ranks[0]['staging_bytes']} bytes a rank); "
              f"round wall {[round(s * 1e3, 2) for s in ranks[0]['round_s']]}"
              f" ms vs stacked {[round(s * 1e3, 2) for s in r['round_s']]} ms")
    return launches


def launch_end_to_end(dev, card):
    """(e) ``tools/launch.py --nprocs 2 --backend gloo cifar`` on the card,
    2 rounds: finite losses, only rank 0 logging, the smoothed losses
    within LOSS_BAND of the one-process W=2 leg's."""
    import io

    from sparknet_tpu_torch.apps import cifar_app
    from sparknet_tpu_torch.parallel import LOSS_BAND

    app = ["--device", "cuda:0", "--workers", "2", "--rounds", str(MP_ROUNDS),
           "--tau", str(CIFAR_TAU), "--batch", str(CIFAR_BATCH)]
    pat = re.compile(r"round (\d+) trained, smoothed_loss (\S+)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as d:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "sparknet_tpu_torch.tools.launch",
             "--nprocs", "2", "--backend", "gloo", "--coordinator",
             f"file://{d}/store", "cifar", *app], capture_output=True,
            text=True, timeout=MP_TIMEOUT_S, env=_subprocess_env(), cwd=d)
        wall = time.perf_counter() - t0
    check(out.returncode == 0, f"launch exited {out.returncode}:\n"
          f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    text = out.stdout
    two = {int(r): float(v) for r, v in pat.findall(text)}
    host1 = [ln for ln in text.splitlines()
             if re.match(r"\[host 1\] \d+\.\d+", ln)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cifar_app.main(["--device", "cuda", "--workers", "2", "--rounds",
                             str(MP_ROUNDS), "--tau", str(CIFAR_TAU),
                             "--batch", str(CIFAR_BATCH)])
    one = {int(r): float(v) for r, v in pat.findall(buf.getvalue())}
    gaps = [abs(two[r] - one[r]) for r in sorted(one)]
    print(f"[{card}] launch --nprocs 2 --backend gloo cifar (W=2, tau "
          f"{CIFAR_TAU}, {MP_ROUNDS} rounds, {wall:.1f} s wall): "
          + " ".join(ln for ln in text.splitlines() if "joined over" in ln)
          + f"; smoothed losses {two} vs one process {one}: gaps "
          f"{[round(g, 5) for g in gaps]} (band {LOSS_BAND}); rank 1 log "
          f"lines echoed: {len(host1)}")
    check(rc == 0 and sorted(two) == sorted(one) == list(range(MP_ROUNDS)),
          f"launch/one-process rounds {two} {one}")
    check(all(np.isfinite(v) for v in two.values()), "launch: non-finite loss")
    check(not host1, f"rank 1 echoed its log: {host1[:3]}")
    check(max(gaps) <= LOSS_BAND, f"launch vs one process: gaps {gaps}")


def multiprocess_ring_end_to_end(dev, card):
    """Phase 18; returns the main-path launches of (b)-(d) and (f)."""
    check_ring_kernels(dev, card)
    launches = dict(lm_sp_end_to_end(dev, card))
    for got in (attention_layer_end_to_end(dev, card),
                multiprocess_end_to_end(dev, card)):
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    launch_end_to_end(dev, card)
    return launches


# phase 19: Caffe's all-reduce data parallelism and the LM's sp ring
# across processes, two ranks sharing the card over gloo
P19_RANK_BATCH = 16  # CaffeNet images a rank in (a): a global batch of 32
P19_IMAGE, P19_RESNET_IMAGE = 227, 224  # the nets' full input widths
P19_TAU, P19_WINDOWS = 2, 2  # (a): 2 windows of 2 iterations
P19_RESNET_BATCH = 8  # ResNet-50 images a rank in (b): a global batch of 16
P19_LM_ROUNDS = 2
# the JAX AllReduceTrainer test's tolerances (tests/test_parallel.py:
# losses rtol 1e-5; params rtol 2e-4, atol 2e-6)
P19_LOSS_RTOL, P19_RTOL, P19_ATOL = 1e-5, 2e-4, 2e-6
# (b): ResNet-50's float32 step is ill-conditioned (BatchNorm's
# E[x^2] - mean^2 over few rows: a CPU rehearsal at 64 px put the
# one-process float32 step's second loss 0.4% from float64's, and the
# two-rank step 0.08% from it), so both float32 runs are held to a
# float64 one-process step: the ranks' update within twice the
# one-process float32 update's distance from it, or 1e-5 of its norm
P19_F64_FACTOR, P19_F64_FLOOR = 2.0, 1e-5
P19_TIMEOUT_S = 600

# The phase's rank script: joins the two ranks on cuda:0 over gloo once,
# then runs (a) cli train --devices 2 on CaffeNet, (e) the same cut at
# its first window and --resume'd, (b) ResNet-50 under AllReduceTrainer
# and (c) lm_app --sp 2, each with the launch counts reset just before
# and read just after; saves what the parent compares (argv: pid,
# store, the config as JSON, the output prefix).
P19_WORKER = r"""
import hashlib
import json
import sys
import time

import numpy as np
import torch

pid, address, cfg, out = int(sys.argv[1]), sys.argv[2], json.loads(
    sys.argv[3]), sys.argv[4]
from sparknet_tpu_torch import models
from sparknet_tpu_torch.apps import lm_app
from sparknet_tpu_torch.ops import cuda_attention, cuda_lrn
from sparknet_tpu_torch.parallel import AllReduceTrainer, make_mesh, mesh
from sparknet_tpu_torch.solver import Solver
from sparknet_tpu_torch.tools import cli
from sparknet_tpu_torch.utils.devices import deterministic_algorithms
from sparknet_tpu_torch.utils.tree import tree_leaves

dev = mesh.initialize_distributed(address, 2, pid, backend="gloo",
                                  device="cuda:0")
print(f"joined rank {pid} of 2 on {dev} over {mesh.joined_backend()}",
      flush=True)
meta = {}


def digest(tree):
    h = hashlib.sha256()
    for x in tree_leaves(tree):
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def leg(name, fn):
    cuda_lrn.reset_launch_counts()
    cuda_attention.reset_launch_counts()
    mesh.reset_staging()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arrays, info = fn()
    torch.cuda.synchronize()
    info.update(wall_s=time.perf_counter() - t0,
                launches={**cuda_lrn.LAUNCHES, **cuda_attention.LAUNCHES},
                staging=dict(mesh.STAGING))
    meta[name] = info
    if pid == 0 and arrays:
        np.savez(f"{out}.{name}.npz", **arrays)


def flat(tree):
    return {f"p{i}": x.detach().cpu().numpy()
            for i, x in enumerate(tree_leaves(tree))}


def train(solver_file, *extra):
    res = {}
    rc = cli.main(["train", f"--solver={solver_file}", "--devices=2",
                   "--device=cuda", f"--tau={cfg['tau']}", *extra], res)
    assert rc == 0, rc
    return res


def caffenet():
    res = train(cfg["caffenet"], f"--max_iter={cfg['iters']}")
    st, solver = res["state"], res["solver"]
    return flat(st.params), dict(
        digests=mesh.all_gather_objects(digest(st)),
        smoothed=res["smoothed_loss"], iters=int(st.iter),
        grad_bytes_per_iter=solver.grad_reduce_bytes / int(st.iter))


def resumed():
    # a kill after the first window leaves on disk what (a) wrote at its
    # end: that snapshot alone, under (e)'s prefix
    if pid == 0:
        import glob
        import os
        import shutil

        os.makedirs(os.path.dirname(cfg["prefix_e"]), exist_ok=True)
        for f in glob.glob(f"{cfg['prefix_a']}_iter_{cfg['tau']}.*"):
            shutil.copy(f, os.path.dirname(cfg["prefix_e"]))
    res = train(cfg["caffenet_e"], f"--max_iter={cfg['iters']}", "--resume")
    return {}, dict(digests=mesh.all_gather_objects(digest(res["state"])),
                    iters=int(res["state"].iter))


def resnet():
    param = models.load_model_solver("resnet50")
    param.base_lr = cfg["resnet_lr"]
    solver = Solver(param, net_param=models.load_model(
        "resnet50", batch=2 * cfg["resnet_batch"], image=cfg["resnet_image"]),
        device=dev)
    tr = AllReduceTrainer(solver, make_mesh({"dp": 2}, workers_per_process=1))
    window = {k: np.load(cfg["resnet_window"])[k] for k in ("data", "label")}
    with deterministic_algorithms():
        st = tr.init_state(0)
        st, losses = tr.step(st, window)
    return ({**flat(st.params), **{f"s{i}": v for i, v in
                                   enumerate(flat(st.stats).values())}},
            dict(digests=mesh.all_gather_objects(digest(st)),
                 losses=losses.cpu().tolist(),
                 grad_bytes_per_iter=solver.grad_reduce_bytes / 2))


def lm():
    res = {}
    assert lm_app.main(cfg["lm_argv"], result=res) == 0
    return ({k: v for k, v in flat(res["state"].params).items()},
            dict(digests=mesh.all_gather_objects(digest(res["state"])),
                 losses=res["losses"].tolist(),
                 round_s=res["round_seconds"],
                 grad_bytes_per_iter=res["trainer"].solver.grad_reduce_bytes
                 / (cfg["lm_rounds"] * cfg["lm_tau"])))


for name, fn in (("a", caffenet), ("e", resumed), ("b", resnet), ("c", lm)):
    leg(name, fn)
    print(f"leg {name}: {meta[name]['wall_s']:.2f} s", flush=True)
with open(f"{out}.rank{pid}.json", "w") as f:
    json.dump(meta, f)
mesh.shutdown()
print(f"P19_OK p{pid}", flush=True)
"""

# (d): NCCL at world size 1: the plain Solver's two iterations of
# cifar10_full first, then AllReduceTrainer over the joined group
P19_NCCL_WORKER = r"""
import hashlib
import json
import sys

import numpy as np
import torch

pid, address = int(sys.argv[1]), sys.argv[2]
from sparknet_tpu_torch import models
from sparknet_tpu_torch.data.source import synthetic_batches
from sparknet_tpu_torch.parallel import AllReduceTrainer, make_mesh, mesh
from sparknet_tpu_torch.solver import Solver
from sparknet_tpu_torch.utils.devices import deterministic_algorithms
from sparknet_tpu_torch.utils.tree import tree_leaves


def digest(tree):
    h = hashlib.sha256()
    for x in tree_leaves(tree):
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run(group):
    solver = Solver(models.load_model_solver("cifar10_full"), device="cuda")
    step = solver if not group else AllReduceTrainer(
        solver, make_mesh({"dp": 1}, workers_per_process=1))
    window = synthetic_batches(solver.net, 2)
    with deterministic_algorithms():
        st = solver.init_state(0)
        st, losses = step.step(st, window)
    return digest(st), losses.cpu().tolist(), solver.grad_reduce_bytes


plain = run(False)
mesh.initialize_distributed(address, 1, 0, device="cuda")
assert mesh.joined_backend() == "nccl", mesh.joined_backend()
joined = run(True)
mesh.shutdown()
print("NCCL_W1 " + json.dumps({"plain": plain, "joined": joined}), flush=True)
print(f"P19_NCCL_OK p{pid}", flush=True)
"""


def _p19_files(root):
    """The rank script's inputs: CaffeNet at full width as per-rank and
    global solver files (the printer writes the zoo model's net inline),
    and ResNet-50's seeded window of the global batch."""
    from sparknet_tpu_torch import config, models

    def solver_file(name, batch):
        param = models.load_model_solver("caffenet")
        param.net_param = config.replace_data_layers(
            models.load_model("caffenet", image=P19_IMAGE),
            [(batch, 3, P19_IMAGE, P19_IMAGE), (batch,)])
        param.snapshot = P19_TAU
        param.snapshot_prefix = f"{root}/{name}/caffenet"
        param.display = P19_TAU
        path = f"{root}/{name}.prototxt"
        with open(path, "w") as f:
            f.write(config.dumps(param))
        return path

    rng = np.random.RandomState(19)
    g = 2 * P19_RESNET_BATCH
    window = f"{root}/resnet_window.npz"
    np.savez(window, data=rng.randn(P19_TAU, g, 3, P19_RESNET_IMAGE,
                                    P19_RESNET_IMAGE).astype(
        np.float32), label=rng.randint(0, 1000, (P19_TAU, g)).astype(
        np.float32))
    lm_argv = _lm_argv(torch.device("cuda"))
    lm_argv[lm_argv.index("--workers") + 1] = "1"
    lm_argv[lm_argv.index("--rounds") + 1] = str(P19_LM_ROUNDS)
    return dict(
        caffenet=solver_file("a", P19_RANK_BATCH),
        caffenet_e=solver_file("e", P19_RANK_BATCH),
        caffenet_one=solver_file("one", 2 * P19_RANK_BATCH),
        prefix_a=f"{root}/a/caffenet", prefix_e=f"{root}/e/caffenet",
        tau=P19_TAU, iters=P19_TAU * P19_WINDOWS,
        resnet_lr=DEEP_LR["resnet50"], resnet_batch=P19_RESNET_BATCH,
        resnet_image=P19_RESNET_IMAGE,
        resnet_window=window, lm_argv=lm_argv + ["--sp", "2"],
        lm_rounds=P19_LM_ROUNDS, lm_tau=LM_TAU)


def _p19_resnet_step(dev, cfg, dtype):
    """(b)'s one-process reference: ResNet-50's two iterations on the
    global batch in ``dtype`` under deterministic algorithms.  Returns
    the initial params and stats, the losses and the final ones, as
    float64 numpy."""
    from sparknet_tpu_torch.models import load_model, load_model_solver
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms
    from sparknet_tpu_torch.utils.tree import tree_leaves, tree_map

    param = load_model_solver("resnet50")
    param.base_lr = cfg["resnet_lr"]
    solver = Solver(param, net_param=load_model(
        "resnet50", batch=2 * cfg["resnet_batch"], image=cfg["resnet_image"]),
        device=dev)
    win = np.load(cfg["resnet_window"])
    window = {k: win[k].astype(np.float64 if dtype == torch.float64
                                else np.float32) for k in ("data", "label")}
    with deterministic_algorithms():
        st = tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                      solver.init_state(0))

        def host(s):
            return [np.float64(x.cpu().numpy())
                    for x in tree_leaves(s.params) + tree_leaves(s.stats)]

        init = host(st)
        st, losses = solver.step(st, window)
    return init, losses.cpu().tolist(), host(st)


def _p19_gap(got, want) -> float:
    """The largest |got - want| beyond the JAX test's allowance, over
    blobs (0 when every element lies within rtol/atol)."""
    worst = 0.0
    for a, b in zip(got, want):
        b = np.asarray(b)
        excess = np.abs(a - b) - (P19_ATOL + P19_RTOL * np.abs(b))
        worst = max(worst, float(excess.max()))
    return max(worst, 0.0)


def _p19_params(z):
    return [z[k] for k in sorted((k for k in z if k.startswith("p")),
                                 key=lambda k: int(k[1:]))]


def allreduce_end_to_end(dev, card):
    """Phase 19: all-reduce DP and the LM across processes.  Two ranks
    share the card over gloo (their backend printed): (a) ``cli train
    --devices 2`` on CaffeNet at full width (16 images a rank, 2 windows
    of tau 2) against the one-process run on the scaled batch of 32;
    (e) the same cut at its first window and ``--resume``d, to the bit;
    (b) ResNet-50 (8 images a rank, lr 0.002) under AllReduceTrainer for
    2 iterations under deterministic algorithms against the one-process
    global-batch step; (c) ``lm_app --sp 2`` at phase 18 (b)'s width as
    2 ranks against the one-process ``--sp 2``; every leg's ranks
    bit-identical.  (d) AllReduceTrainer over NCCL at world size 1, bit
    for bit the plain Solver.  Returns the ranks' main-path launches."""
    import io

    from sparknet_tpu_torch.apps import lm_app
    from sparknet_tpu_torch.models import load_model, load_model_solver
    from sparknet_tpu_torch.solver import Solver
    from sparknet_tpu_torch.tools import cli
    from sparknet_tpu_torch.utils import procs
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms
    from sparknet_tpu_torch.utils.tree import tree_leaves

    repo = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()  # the ranks share the card with this process
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p19_") as root:
        cfg = _p19_files(root)
        out = f"{root}/p19"
        t0 = time.perf_counter()
        logs = procs.run_worker_processes(
            P19_WORKER, "P19_OK", repo, nprocs=2,
            args=[json.dumps(cfg), out], timeout=P19_TIMEOUT_S, workdir=root,
            env_extra={"SPARKNET_LOG_DIR": root})
        ranks_wall = time.perf_counter() - t0
        joined = [ln for o in logs for ln in o.splitlines() if "joined" in ln]
        print(f"[{card}] phase 19 ranks ({ranks_wall:.1f} s): "
              + "; ".join(joined))
        check(len(joined) == 2 and all("over gloo" in ln for ln in joined),
              f"the ranks did not join over gloo: {joined}")
        meta = []
        for pid in range(2):
            with open(f"{out}.rank{pid}.json") as f:
                meta.append(json.load(f))
        for name in "aebc":
            dig = [set(m[name]["digests"]) for m in meta]
            check(all(len(d) == 1 for d in dig) and dig[0] == dig[1],
                  f"leg {name}: the ranks' states differ: {dig}")
            for pid, m in enumerate(meta):
                for k, n in m[name]["launches"].items():
                    launches[k] = launches.get(k, 0) + n
        # (d) runs beside this process's references: its own process,
        # the card's work is small
        nccl = {}
        d_thread = threading.Thread(target=lambda: nccl.update(
            logs=procs.run_worker_processes(
                P19_NCCL_WORKER, "P19_NCCL_OK", repo, nprocs=1, timeout=300,
                workdir=root, env_extra={"SPARKNET_LOG_DIR": root})),
            daemon=True)
        d_thread.start()
        walls = {}
        # (a) against one process on the scaled batch
        t0 = time.perf_counter()
        one = {}
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["train", f"--solver={cfg['caffenet_one']}",
                           "--device=cuda", f"--tau={P19_TAU}",
                           f"--max_iter={cfg['iters']}"], one)
        check(rc == 0, f"cli train --devices 1 exited {rc}")
        walls["a"] = time.perf_counter() - t0
        a = dict(np.load(f"{out}.a.npz"))
        gap = _p19_gap(_p19_params(a), [x.cpu().numpy() for x in
                                        tree_leaves(one["state"].params)])
        ma = [m["a"] for m in meta]
        lgap = abs(ma[0]["smoothed"] - one["smoothed_loss"]) / abs(
            one["smoothed_loss"])
        n_lrn = 2 * cfg["iters"]  # CaffeNet's two LRNs an iteration
        for pid, m in enumerate(ma):
            st = m["staging"]
            print(f"[{card}] (a) rank {pid}: cli train --devices 2, CaffeNet "
                  f"{P19_RANK_BATCH} a rank, {cfg['iters']} iterations: "
                  f"{m['wall_s']:.2f} s; K5/K6 {m['launches']['lrn_fwd']}/"
                  f"{m['launches']['lrn_bwd']} (expected {n_lrn} each); grad "
                  f"bytes a rank an iteration {m['grad_bytes_per_iter']:.0f}; "
                  f"host staging {st['ms'] / cfg['iters']:.2f} ms an iteration"
                  f" ({st['bytes']} bytes over the leg, state broadcast "
                  "included)")
            check(m["launches"]["lrn_fwd"] == n_lrn
                  and m["launches"]["lrn_bwd"] == n_lrn,
                  f"(a) rank {pid}: K5/K6 launches {m['launches']}")
        print(f"[{card}] (a) vs one process on the batch of "
              f"{2 * P19_RANK_BATCH}: smoothed loss {ma[0]['smoothed']:.6f} "
              f"vs {one['smoothed_loss']:.6f} (rel {lgap:.2e}, limit "
              f"{P19_LOSS_RTOL}); params beyond rtol {P19_RTOL} / atol "
              f"{P19_ATOL}: {gap:.3e}")
        check(lgap <= P19_LOSS_RTOL and gap == 0.0,
              f"(a) left the one-process run: loss {lgap}, params {gap}")
        # (e) the resumed run's bits are the uninterrupted run's
        check(meta[0]["e"]["digests"][0] == meta[0]["a"]["digests"][0]
              and meta[0]["e"]["iters"] == cfg["iters"],
              "(e) --resume left the uninterrupted run's bits")
        print(f"[{card}] (e) killed after iteration {P19_TAU} (its snapshot "
              f"alone left) and --resume'd to {cfg['iters']}: bit for bit (a)"
              f" ({meta[0]['e']['wall_s']:.2f} s)")
        # (b) ResNet-50 against the one-process global-batch step, both
        # held to the same step in float64
        b = dict(np.load(f"{out}.b.npz"))
        n_par = len(_p19_params(b))
        ranks_b = _p19_params(b) + [b[f"s{i}"] for i in range(
            sum(1 for k in b if k.startswith("s")))]
        t0 = time.perf_counter()
        one_b = {}
        for dtype in (torch.float32, torch.float64):
            one_b[dtype] = _p19_resnet_step(dev, cfg, dtype)
        walls["b"] = time.perf_counter() - t0
        init, l64, want = one_b[torch.float64]
        _, l32, got32 = one_b[torch.float32]

        def far(xs):
            """The update's distance from float64's, over its norm."""
            num = sum(float(((np.float64(x) - w) ** 2).sum())
                      for x, w in zip(xs, want))
            den = sum(float(((w - i) ** 2).sum()) for w, i in zip(want, init))
            return float(np.sqrt(num / den))

        mb = meta[0]["b"]
        far_ranks, far_one = far(ranks_b), far(got32)
        far_p = (far(ranks_b[:n_par] + want[n_par:]),
                 far(got32[:n_par] + want[n_par:]))
        limit = max(P19_F64_FACTOR * far_one, P19_F64_FLOOR)
        print(f"[{card}] (b) ResNet-50 under AllReduceTrainer, "
              f"{P19_RESNET_BATCH} a rank, 2 iterations: {mb['wall_s']:.2f} s;"
              f" losses {mb['losses']}, one process float32 {l32}, float64 "
              f"{l64}; the update's distance from float64's: ranks "
              f"{far_ranks:.3e} (params {far_p[0]:.3e}), one process "
              f"{far_one:.3e} (params {far_p[1]:.3e}), limit {limit:.3e}; "
              f"grad bytes a rank an iteration {mb['grad_bytes_per_iter']:.0f};"
              f" host staging {mb['staging']['ms'] / 2:.2f} ms an iteration")
        check(far_ranks <= limit and all(np.isfinite(mb["losses"])),
              f"(b) the ranks' step is {far_ranks:.3e} from float64's, the "
              f"one-process float32 step {far_one:.3e}")
        # (c) lm_app --sp 2 as two ranks against one process
        t0 = time.perf_counter()
        res = {}
        with contextlib.redirect_stdout(io.StringIO()):
            rc = lm_app.main(cfg["lm_argv"], res)
        check(rc == 0, f"lm_app --sp 2 exited {rc}")
        walls["c"] = time.perf_counter() - t0
        c = dict(np.load(f"{out}.c.npz"))
        mc = meta[0]["c"]
        c_loss = float(np.abs(np.array(mc["losses"]) - res["losses"]).max())
        c_par = max(float(np.abs(x - y.cpu().numpy()).max()) for x, y in zip(
            _p19_params(c), tree_leaves(res["state"].params)))
        n_att = LM_MODEL["depth"] * LM_TAU * P19_LM_ROUNDS * 2
        for pid, m in enumerate(meta):
            got = m["c"]["launches"]
            print(f"[{card}] (c) rank {pid}: lm_app --sp 2 (dim "
                  f"{LM_MODEL['dim']}, depth {LM_MODEL['depth']}, tau "
                  f"{LM_TAU}, {P19_LM_ROUNDS} rounds): {m['c']['wall_s']:.2f}"
                  f" s, rounds {[round(x * 1e3, 1) for x in m['c']['round_s']]}"
                  f" ms; K1/K3/K4 {got['flash_fwd']}/{got['flash_bwd_dq']}/"
                  f"{got['flash_bwd_dkv']} (expected {n_att} each); grad bytes"
                  f" a rank an iteration {m['c']['grad_bytes_per_iter']:.0f}; "
                  f"host staging {m['c']['staging']['ms']:.1f} ms over the leg")
            check(got["flash_fwd"] == got["flash_bwd_dq"]
                  == got["flash_bwd_dkv"] == n_att,
                  f"(c) rank {pid}: launches {got}")
        print(f"[{card}] (c) vs one process --sp 2: losses {c_loss:.3e}, "
              f"params {c_par:.3e} (limit {LM_TOL})")
        check(c_loss <= LM_TOL and c_par <= LM_TOL,
              f"(c) left the one-process ring: {c_loss}, {c_par}")
        # (d) NCCL at world size 1
        t0 = time.perf_counter()
        d_thread.join(timeout=P19_TIMEOUT_S)
        check("logs" in nccl, "(d) the NCCL world-1 rank did not finish")
        walls["d (after the references)"] = time.perf_counter() - t0
        d = json.loads(next(ln for ln in nccl["logs"][0].splitlines()
                            if ln.startswith("NCCL_W1 "))[len("NCCL_W1 "):])
        print(f"[{card}] (d) AllReduceTrainer over NCCL at world size 1: "
              f"losses {d['joined'][1]} vs the plain Solver {d['plain'][1]}; "
              f"grad bytes summed {d['joined'][2]}")
        check(d["joined"][:2] == d["plain"][:2] and d["joined"][2] > 0,
              f"(d) NCCL world 1 left the plain Solver's bits: {d}")
        print(f"[{card}] phase 19 walls: the ranks {ranks_wall:.1f} s, the "
              "one-process references "
              + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    return launches


# phase 20: SparkNet's failure and straggler machinery across processes,
# two ranks sharing the card over gloo, W=4 (two cifar10_full workers a
# rank); legs (a)-(d) held to the one-process stacked run bit for bit
P20_W, P20_ROUNDS = 4, 3
P20_LEGS = {
    "a": dict(compress="int8", slices=2, cross_slice_every=2),
    "b": dict(compress="int8", slices=2, elastic=True, preempt=[1, 1],
              rounds=P20_ROUNDS + 1),  # the rejoin lands at round 3
    "c": dict(stale_bound=2),
    "d": dict(journal=True, profile=True),
}
# (e): SIGTERM to slice 1 once the ranks train (their set-up took ~20 s
# alone on the card's host; (e) runs beside (a)-(d)), the hard kill 2 s
# later; the survivors' group timeout, and the launcher's deadline past
# which a hang would show
P20_PREEMPT_AT_S, P20_RELAUNCH_AFTER_S = 35.0, 2.0
P20_LAUNCH_TIMEOUT_S = 180
P20_TIMEOUT_S = 600
# (f): the real entry point with (a)'s and (b)'s flags, 2 rounds (an
# intra round, then a cross round)
P20_APP = ["cifar", "--device", "cuda:0", "--workers", str(P20_W), "--tau",
           str(CIFAR_TAU), "--batch", str(CIFAR_BATCH), "--rounds", "2",
           "--test_every", "1000000", "--slices", "2", "--cross_slice_every",
           "2", "--compress", "int8", "--elastic"]


def _p20_spec(leg):
    return {"net": "cifar10_full", "workers": P20_W, "tau": CIFAR_TAU,
            "batch": CIFAR_BATCH, "rounds": P20_ROUNDS,
            "deterministic": True, **P20_LEGS[leg]}


def _p20_same(ranks, ref, what):
    _same_as_stacked(ranks, ref, what)
    for r in ranks:
        for key in ("masks", "epochs", "states", "transitions", "tiers"):
            check(r[key] == ref[key], f"{what}: {key} {r[key]} differ from "
                  f"the stacked run's {ref[key]}")


def machinery_legs(dev, card):
    """(a)-(d): each leg over two ranks on the card, held to the stacked
    run; the bytes that crossed the group, against the prediction, and
    K9/K10 by the chunk arithmetic in each rank.  Returns the ranks'
    K9/K10 launches."""
    from sparknet_tpu_torch.utils import procs

    repo = os.path.dirname(os.path.abspath(__file__))
    legs = sorted(P20_LEGS)
    t0 = time.perf_counter()
    got, ref, logs = procs.run_averaging_processes(
        [_p20_spec(leg) for leg in legs], repo, nprocs=2, device="cuda:0",
        backend="gloo", timeout=P20_TIMEOUT_S, stacked_first=True)
    wall = time.perf_counter() - t0
    joined = [ln for o in logs for ln in o.splitlines() if "joined" in ln]
    check(len(joined) == 2 and all("over gloo" in ln for ln in joined),
          f"the ranks did not join over gloo: {joined}")
    launches = {"comm_encode": 0, "comm_apply_barriered": 0}
    run = dict(zip(legs, zip(got, ref)))
    nparam = sum(p.size for p in run["a"][0][0]["params"])
    nleaf = len(run["a"][0][0]["params"])
    other = P20_W // 2  # the other rank's rows
    want = {"none": other * 4 * nparam, "int8": other * (nparam + 4 * nleaf)}
    print(f"[{card}] phase 20 (a)-(d): cifar10_full W={P20_W} as 2 ranks x 2 "
          f"on the card over gloo, tau {CIFAR_TAU}, batch {CIFAR_BATCH}, "
          f"{nparam} params in {nleaf} leaves; {wall:.2f} s wall with the "
          "stacked references")
    for leg in legs:
        ranks, r = run[leg]
        what = f"phase 20 ({leg}) {P20_LEGS[leg]}"
        _p20_same(ranks, r, what)
        spec = procs._spec(_p20_spec(leg))
        cross = [i for i, t in enumerate(ranks[0]["tiers"]) if t == "cross"]
        mode = spec["compress"]
        for rk in ranks:
            gb = rk["group_bytes"]
            for i, t in enumerate(rk["tiers"]):
                exp = 0 if t == "intra" else want[mode]
                check(gb[i] == exp, f"{what}: round {i} ({t}) moved {gb[i]} "
                      f"B to rank {rk['rows']}, expected {exp}")
            n = rk["launches"]
            k = rk["chunks"] * len(cross) if mode != "none" else 0
            check(n["comm_encode"] == k and n["comm_apply_barriered"] == k
                  and n["comm_apply_correction"] == 0,
                  f"{what}: launches {n}, expected {k} K9 and K10")
            for name in launches:
                launches[name] += n[name]
        print(f"[{card}] ({leg}) bit for bit the stacked run ({len(gb)} rounds,"
              f" tiers {ranks[0]['tiers']}); bytes to a rank a round "
              f"{ranks[0]['group_bytes']} (predicted {want['int8']} int8, "
              f"{want['none']} none on a cross round, 0 on a rank-aligned "
              f"intra round); K9/K10 a rank "
              f"{[rk['launches']['comm_encode'] for rk in ranks]}/"
              f"{[rk['launches']['comm_apply_barriered'] for rk in ranks]}; "
              f"round wall {[round(x * 1e3, 2) for x in ranks[0]['round_s']]}"
              f" ms vs stacked {[round(x * 1e3, 2) for x in r['round_s']]} ms"
              " (host clock; (e) and (f) train on the card meanwhile)")
    ranks, r = run["b"]
    check(ranks[0]["epochs"] == [0, 1, 2, 4] and [
        t[2] for t in ranks[0]["transitions"]] == [
        "leave", "death", "join_request", "rejoin"],
        f"(b) views {ranks[0]['epochs']} {ranks[0]['transitions']}")
    print(f"[{card}] (b) SIGTERM to rank 1 alone at round 1: masks "
          f"{ranks[0]['masks']}, epochs {ranks[0]['epochs']} on both ranks")
    ranks, r = run["d"]
    check(ranks[0]["journal"] == r["journal"] and ranks[1]["journal"] is None
          and len(r["journal"]) == 2 * P20_ROUNDS,
          f"(d) journal: rank 0 {ranks[0]['journal']}, rank 1 "
          f"{ranks[1]['journal']}, stacked {r['journal']}")
    prof = [rk["profile"] for rk in ranks]
    check(all(len(p["execute_ms_p50"]) == P20_W for p in prof)
          and [p["written"] for p in prof] == [True, False]
          and prof[0]["execute_ms_p50"] == prof[1]["execute_ms_p50"],
          f"(d) profile {prof}")
    print(f"[{card}] (d) journal: {len(r['journal'])} records, rank 0's equal "
          f"the stacked run's, rank 1 none; profile: each worker's execute "
          f"p50 {prof[0]['execute_ms_p50']} ms (CUDA events, gathered), "
          f"FLOPs a round {prof[0]['flops_per_round']}, written by rank 0")
    return launches


def preemption_end_to_end(dev, card):
    """(e) ``launch --nprocs 2 --slices 2 --preempt_slice 1`` over the
    card (gloo, ``--elastic``): the SIGTERM is a notice the ranks agree
    on (the leave shows in rank 0's log), the launcher kills and reaps
    rank 1 and relaunches it; rank 0 stops in its next collective with
    ``PeerLost`` naming rank 1 inside its group timeout
    (``mesh.JOIN_TIMEOUT_S``), and nothing hangs until the launcher's
    deadline."""
    app = ["--device", "cuda:0", "--workers", "2", "--rounds", "100000",
           "--tau", str(CIFAR_TAU), "--batch", str(CIFAR_BATCH),
           "--test_every", "1000000", "--slices", "2", "--elastic",
           "--rejoin_after", "1"]
    env = _subprocess_env()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_preempt_") as d:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "sparknet_tpu_torch.tools.launch",
             "--nprocs", "2", "--backend", "gloo", "--coordinator",
             f"file://{d}/store", "--slices", "2", "--preempt_slice", "1",
             "--preempt_at", str(P20_PREEMPT_AT_S), "--relaunch_after",
             str(P20_RELAUNCH_AFTER_S), "--timeout",
             str(P20_LAUNCH_TIMEOUT_S), "cifar", *app],
            capture_output=True, text=True, timeout=P20_LAUNCH_TIMEOUT_S + 60,
            env=env, cwd=d)
        wall = time.perf_counter() - t0
    text = out.stdout
    life = [ln for ln in text.splitlines() if ln.startswith("launch:")]
    lost = [ln for ln in text.splitlines()
            if ln.startswith("[host 0]") and "PeerLost" in ln]
    leave = [ln for ln in text.splitlines() if "membership: epoch" in ln]
    trained = re.findall(r"\[host 0\] .*round (\d+) trained", text)
    print(f"[{card}] (e) launch --slices 2 --preempt_slice 1 --preempt_at "
          f"{P20_PREEMPT_AT_S} --relaunch_after {P20_RELAUNCH_AFTER_S} cifar "
          f"--elastic: rc {out.returncode} after {wall:.2f} s (deadline "
          f"{P20_LAUNCH_TIMEOUT_S} s); {len(trained)} rounds trained on rank "
          f"0; lifecycle {life}; membership {leave[:4]}; rank 0: "
          f"{lost[-1][:400] if lost else None}")
    check(any("slice 1 preempted (SIGTERM to host(s) [1])" in ln
              for ln in life), f"(e) no preemption line: {life}")
    check(any("slice 1 relaunched" in ln or "slice 1 relaunch skipped" in ln
              for ln in life), f"(e) no relaunch line: {life}")
    check(any("leave [1]" in ln for ln in leave),
          f"(e) the SIGTERM was not an agreed notice: {leave[:4]}")
    check(lost and "lost rank 1 (pid" in lost[-1],
          f"(e) rank 0 did not stop naming rank 1:\n{text[-3000:]}")
    check(out.returncode != 0 and wall < P20_LAUNCH_TIMEOUT_S,
          f"(e) rc {out.returncode} after {wall:.1f} s")


def launched_app_bits(dev, card):
    """(f) ``launch --nprocs 2 --devices_per_host 2 --backend gloo cifar
    --slices 2 --cross_slice_every 2 --compress int8 --elastic`` on the
    card against ``cifar_app --workers 4`` in one process with the same
    flags, both observed (``utils/procs.observed_launch``: the real
    launcher, children's environment and app, each process saving what
    it computed): every rank's rows of the final params and stats, every
    round's losses and live masks, the smoothed loss and the accuracy,
    bit for bit.  Returns the ranks' K9/K10 launches."""
    from sparknet_tpu_torch.utils import procs

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launched_") as d:
        t0 = time.perf_counter()
        runs = {}
        for name, launcher in (
                ("one", []),
                ("launched", ["--nprocs", "2", "--devices_per_host", "2",
                              "--backend", "gloo", "--coordinator",
                              f"file://{d}/store", "--timeout",
                              str(P20_LAUNCH_TIMEOUT_S)])):
            done, ranks = procs.observed_launch(
                [*launcher, *P20_APP], os.path.join(d, name), repo,
                timeout=P20_LAUNCH_TIMEOUT_S + 60)
            check(done.returncode == 0 and len(ranks) == (2 if launcher
                                                          else 1),
                  f"(f) {name} run: rc {done.returncode}, {len(ranks)} "
                  f"rank(s) saved\n{done.stdout[-2000:]}{done.stderr[-2000:]}")
            runs[name] = ranks
        wall = time.perf_counter() - t0
    (one,), ranks = runs["one"], runs["launched"]
    for r in ranks:
        lo, hi = r["rows"]
        check(len(r["leaves"]) == len(one["leaves"]) > 0 and all(
            np.array_equal(got, want[lo:hi])
            for got, want in zip(r["leaves"], one["leaves"])),
            f"(f) rank rows {lo}:{hi} differ from the one-process run")
        check(np.array_equal(r["losses"], one["losses"]),
              f"(f) rank rows {lo}:{hi}: losses differ")
        for key in ("masks", "smoothed_loss", "accuracy"):
            check(r[key] == one[key], f"(f) {key}: {r[key]} vs {one[key]}")
        check(np.isfinite(r["losses"]).all(), "(f) non-finite losses")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ("comm_encode", "comm_apply_barriered")}
    print(f"[{card}] (f) launch --nprocs 2 --devices_per_host 2 "
          f"{' '.join(P20_APP)}: bit for bit the one-process run (rows, "
          f"losses {one['losses'].shape}, masks, smoothed loss "
          f"{one['smoothed_loss']!r}, accuracy {one['accuracy']!r}); K9/K10 a "
          f"rank {[r['launches']['comm_encode'] for r in ranks]}/"
          f"{[r['launches']['comm_apply_barriered'] for r in ranks]}; "
          f"{wall:.2f} s wall for both runs")
    return launches


def averaging_machinery_across_processes(dev, card):
    """Phase 20; returns the main-path K9/K10 launches of (a)-(d) and
    (f).  (e) and (f) run beside (a)-(d), each on a thread: (e)'s ranks
    train cifar10_full on the card until the preemption, and (f) is two
    more runs of it, so (a)-(d)'s round walls come from a card shared
    with them; the bits do not depend on the card's load."""
    t0 = time.perf_counter()
    failed, got = [], {}

    def beside(fn):
        try:
            got[fn.__name__] = fn(dev, card)
        except BaseException as e:  # re-raised below, on this thread
            failed.append(e)

    threads = [threading.Thread(target=beside, args=(fn,),
                                name=f"phase20-{fn.__name__}")
               for fn in (preemption_end_to_end, launched_app_bits)]
    for t in threads:
        t.start()
    try:
        launches = machinery_legs(dev, card)
    finally:
        for t in threads:
            t.join()
    if failed:
        raise failed[0]
    for name, n in got["launched_app_bits"].items():
        launches[name] += n
    print(f"[{card}] phase 20 wall {time.perf_counter() - t0:.2f} s")
    return launches


# ----------------------------------------------------------------------
# phase 21: the run's telemetry plane on the card — cifar_app with every
# telemetry flag, a launched two-rank run under the launcher's fleet
# collector, cli serve --generate under --slo
# ----------------------------------------------------------------------
P21_ROUNDS = 3
P21_STREAMS = 16
P21_PROMPT_LENS = (5, 23)
P21_FLAGS = ["--obs", "--obs_port", "0", "--slo", "--fleet_collector",
             "127.0.0.1:0", "--profile"]
P21_LAUNCH_TIMEOUT_S = 180
P21_SCRAPES = ("/metrics", "/healthz",
               "/query?series=sparknet_rounds_total&range=300", "/slo",
               "/signals")


def _p21_app(dev):
    return ["--device", dev.type, "--workers", str(CIFAR_W), "--tau",
            str(CIFAR_TAU), "--batch", str(CIFAR_BATCH), "--rounds",
            str(P21_ROUNDS), "--test_every", "1000000", "--compress", "int8",
            "--seed", "0"]


def _get(url):
    """``(status, body, ms)`` of one GET, with a timeout."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=10) as r:
        body = r.read().decode()
        return r.status, body, (time.perf_counter() - t0) * 1e3


def _sample(text, name):
    m = re.search(r"^%s (\S+)$" % re.escape(name), text, re.M)
    return None if m is None else float(m.group(1))


def telemetry_cifar(dev, card):
    """(a) ``cifar_app --compress int8`` at cifar10_full's width, W=4,
    tau 10, batch 100, P21_ROUNDS rounds, with ``--obs --obs_port 0 --slo
    --trace_out --fleet_collector 127.0.0.1:0 --profile``, and the same
    run with no telemetry, both under ``deterministic_algorithms``.  At
    the last round's commit (the run alive) the sidecar's endpoints are
    scraped and the collector's ``/fleet`` read.  Returns K9/K10's
    launches of the telemetry run."""
    from sparknet_tpu_torch import obs
    from sparknet_tpu_torch.apps import cifar_app, guards
    from sparknet_tpu_torch.ops import cuda_comm as cc
    from sparknet_tpu_torch.utils.devices import deterministic_algorithms
    from sparknet_tpu_torch.utils.tree import tree_leaves

    R = P21_ROUNDS
    live, losses = {}, []
    real_start = obs.start
    real_commit, real_round = guards.RoundGuards.commit, guards.RoundGuards.round

    def start(**kw):
        run = real_start(**kw)
        live["run"] = run
        close = run.collector.close

        def closing():  # the view after the shipper's final push
            live["final_fleet"] = run.collector.fleet_view()
            close()

        run.collector.close = closing
        return run

    def commit(self, r, **meta):
        real_commit(self, r, **meta)
        if "run" in live and r == R - 1:
            run = live["run"]
            run.sampler.sample_once()
            h, p = run.address
            live["scrapes"] = {path: _get(f"http://{h}:{p}{path}")
                               for path in P21_SCRAPES}
            deadline = time.time() + 10  # the shipper pushes every 0.5 s
            while True:
                fleet = json.loads(_get(run.collector.url + "/fleet")[1])
                rounds = [st["round"] for st in fleet["hosts"].values()]
                if rounds == [R - 1] or time.time() > deadline:
                    break
                time.sleep(0.05)
            live["fleet"] = fleet

    def round_(self, *a, **k):
        out = real_round(self, *a, **k)
        losses[-1].append(out[1].detach().cpu().numpy())
        return out

    legs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as d:
        trace = os.path.join(d, "trace.json")
        for leg, extra in (("off", []), ("on", P21_FLAGS + ["--trace_out",
                                                             trace])):
            losses.append([])
            guards.RoundGuards.round = round_
            if leg == "on":
                obs.start, guards.RoundGuards.commit = start, commit
                cc.reset_launch_counts()
            r = {}
            try:
                with deterministic_algorithms():
                    rc = cifar_app.main(_p21_app(dev) + extra, result=r)
                torch.cuda.synchronize()
            finally:
                obs.start = real_start
                guards.RoundGuards.commit = real_commit
                guards.RoundGuards.round = real_round
            check(rc == 0, f"(a) cifar_app {leg} exited {rc}")
            if leg == "on":
                launches = dict(cc.LAUNCHES)
            legs[leg] = r
        with open(trace) as f:
            spans = [e for e in json.load(f)["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") == "phase"]
    on, off = legs["on"], legs["off"]
    # the telemetry changes nothing the run computes
    check(all(np.array_equal(a, b) for a, b in zip(losses[0], losses[1]))
          and len(losses[1]) == R, "(a) losses differ with telemetry on")
    for name in ("params", "stats", "history"):
        check(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(getattr(on["state"], name)),
            tree_leaves(getattr(off["state"], name)))),
            f"(a) final {name} differ with telemetry on")
    check(on["smoothed_loss"] == off["smoothed_loss"],
          "(a) smoothed loss differs with telemetry on")
    check(launches["comm_encode"] == 3 * R
          and launches["comm_apply_barriered"] == 3 * R,
          f"(a) K9/K10 launches {launches}, expected {3 * R} each")
    # the phase spans of every round, each count its histogram's count
    text = on["metrics"].registry.render()
    counts = {}
    for e in spans:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    hist = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^sparknet_phase_latency_seconds_count\{phase="(\w+)"\} (\S+)$',
        text, re.M)}
    check(hist == {k: float(v) for k, v in counts.items()},
          f"(a) span counts {counts} vs the phase histogram {hist}")
    want = dict(assemble=R, h2d=R, execute=R, average=R, quantize=R,
                dequantize=R, allreduce=3 * R)
    check(counts == want, f"(a) phase spans {counts}, expected {want}")
    check(sorted(e["args"]["round"] for e in spans
                 if e["name"] == "assemble") == list(range(R)),
          "(a) a round's assemble span is missing")
    for k in ("sparknet_rounds_total", "sparknet_ship_dropped_total"):
        print(f"[{card}] (a) {k} = {_sample(text, k)}")
    check(_sample(text, "sparknet_rounds_total") == R, "(a) rounds_total")
    check(_sample(text, "sparknet_ship_dropped_total") == 0,
          "(a) the shipper dropped events")
    check(_sample(text, "sparknet_device_bytes") > 0,
          "(a) sparknet_device_bytes read 0 on the card")
    # the endpoints, scraped while the run was alive
    sc = live["scrapes"]
    check(all(code == 200 for code, _, _ in sc.values()),
          f"(a) a scrape failed: { {k: v[0] for k, v in sc.items()} }")
    check(_sample(sc["/metrics"][1], "sparknet_rounds_total") == R,
          "(a) /metrics rounds_total")
    health = json.loads(sc["/healthz"][1])
    check(health["status"] == "ok" and "slo" in health and "profile" in health,
          f"(a) /healthz {health}")
    check(json.loads(sc["/query?series=sparknet_rounds_total&range=300"][1])
          ["points"], "(a) /query has no points")
    check({"train-round-time", "train-straggler-free"} <= {
        row["name"] for row in json.loads(sc["/slo"][1])["slos"]},
        "(a) /slo rows")
    check("round_rate_per_s" in json.loads(sc["/signals"][1]),
          "(a) /signals")
    fleet, final = live["fleet"], live["final_fleet"]
    (host,) = fleet["hosts"].values()
    check(fleet["fleet"]["hosts_live"] == 1 and host["round"] == R - 1,
          f"(a) /fleet at the last round: {fleet['fleet']}, round "
          f"{host['round']}")
    (end,) = final["hosts"].values()
    check(end["state"] == "finished" and end["lost_events"] == 0
          and end["reported_dropped_total"] == 0,
          f"(a) the collector's view at the end: {end['state']}, lost "
          f"{end['lost_events']}, dropped {end['reported_dropped_total']}")
    walls = {leg: np.array(legs[leg]["round_seconds"][1:]) * 1e3
             for leg in legs}
    print(f"[{card}] (a) cifar_app --compress int8 {' '.join(P21_FLAGS)} "
          f"--trace_out: {R} rounds, losses and final params bit for bit the "
          f"run without telemetry, K9/K10 {launches['comm_encode']}/"
          f"{launches['comm_apply_barriered']}, phase spans {counts} = the "
          f"histogram's counts; /fleet: 1 live host at round {R - 1}, "
          f"{end['received_events']} events shipped, 0 lost, 0 dropped")
    print(f"[{card}] (a) round wall (host clock, mean of rounds 1..{R - 1}; "
          f"reported, not claimed): telemetry off "
          f"{walls['off'].mean():.2f} ms, on {walls['on'].mean():.2f} ms; "
          "scrape latency " + ", ".join(
              f"{k.split('?')[0]} {v[2]:.2f} ms" for k, v in sc.items()))
    return {k: launches[k] for k in ("comm_encode", "comm_apply_barriered")}


def telemetry_launch(dev, card):
    """(b) ``tools/launch.py --nprocs 2 --devices_per_host 2
    --fleet_collector 127.0.0.1:0 cifar --compress int8``, two gloo
    ranks on ``cuda:0`` (2 rounds): the launcher's summary reads 2
    hosts, 0 late, 0 dead (each finished: a clean exit sends the final
    push), the merged ``sparknet_rounds_total`` is the sum of the
    hosts', and each rank shipped its epilogue kernels' chunk counts
    with ``kernel_path{kernel="epilogue"}`` 1."""
    from sparknet_tpu_torch.tools import launch

    seen = {}
    summary = launch.print_fleet_summary

    def capture(collector):
        seen["view"] = collector.fleet_view()
        summary(collector)

    device = "cuda:0" if dev.type == "cuda" else "cpu"
    launch.print_fleet_summary = capture
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as d:
            rc = launch.main([
                "--nprocs", "2", "--devices_per_host", "2", "--backend",
                "gloo", "--coordinator", f"file://{d}/store", "--timeout",
                str(P21_LAUNCH_TIMEOUT_S), "--fleet_collector", "127.0.0.1:0",
                "cifar", "--device", device, "--workers", str(CIFAR_W),
                "--tau", str(CIFAR_TAU), "--batch", str(CIFAR_BATCH),
                "--rounds", "2", "--test_every", "1000000", "--compress",
                "int8"])
    finally:
        launch.print_fleet_summary = summary
    wall = time.perf_counter() - t0
    check(rc == 0, f"(b) the launch exited {rc}")
    view = seen["view"]
    f = view["fleet"]
    check(f["hosts_total"] == 2 and f["hosts_late"] == 0
          and f["hosts_dead"] == 0 and f["hosts_finished"] == 2,
          f"(b) fleet summary {f}")
    per_host = [st["counters"].get("sparknet_rounds_total", 0.0)
                for st in view["hosts"].values()]
    merged = f["counters"].get("sparknet_rounds_total")
    check(merged == sum(per_host) == 4.0,
          f"(b) merged rounds_total {merged} vs the hosts' {per_host}")
    for h, st in view["hosts"].items():
        enc = st["counters"].get(
            'sparknet_kernel_fused_chunks_total{stage="encode"}', 0)
        app = st["counters"].get(
            'sparknet_kernel_fused_chunks_total{stage="apply"}', 0)
        path = st["gauges"].get('sparknet_kernel_path{kernel="epilogue"}')
        check(enc > 0 and app > 0 and path == 1.0 and st["lost_events"] == 0,
              f"(b) {h}: epilogue chunks {enc}/{app}, kernel_path {path}, "
              f"lost {st['lost_events']}")
    print(f"[{card}] (b) launch --nprocs 2 --devices_per_host 2 "
          f"--fleet_collector: 2 hosts, 0 late, 0 dead, 2 finished; merged "
          f"rounds_total {merged} = {per_host}; each rank's K9/K10 chunks "
          "shipped; " + f"{wall:.2f} s wall (host clock)")


def telemetry_serve(dev, card):
    """(c) ``cli serve --generate`` at its default LM width, with ``--obs
    --obs_port 0 --slo`` and without, P21_STREAMS streams each: the
    telemetry run's ``/slo`` row ``serve-ttft-p99`` counts good + bad =
    P21_STREAMS, ``/signals`` answers, and K1 and K2 launched.  Returns
    the telemetry run's K1/K2 launches."""
    from sparknet_tpu_torch.ops import cuda_attention as ca
    from sparknet_tpu_torch.tools import cli

    rs = np.random.RandomState(21)
    # prompts of 5 and 23 tokens: with MAX_NEW new ones, 3 and 4 KV
    # blocks a stream, so all 16 reservations fit the CLI's 64 blocks
    prompts = [rs.randint(0, 256, size=P21_PROMPT_LENS[i % 2]).tolist()
               for i in range(P21_STREAMS)]
    walls = {}
    for leg, flags in (("off", []), ("on", ["--obs", "--obs_port", "0",
                                            "--slo"])):
        r = {}
        check(cli.main(["serve", "--generate", "--port", "0", "--device",
                        dev.type] + flags, result=r) == 0, "(c) cli serve")
        server, run = r["server"], r["obs"]
        server.start()
        try:
            if leg == "on":
                run.sampler.sample_once()  # the baseline sample
                ca.reset_launch_counts()
            t_base = time.time()
            host, port = server.address
            out = [None] * len(prompts)
            threads = [threading.Thread(target=_stream,
                                        args=(host, port, p, out, i))
                       for i, p in enumerate(prompts)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            walls[leg] = time.perf_counter() - t0
            if dev.type == "cuda":
                torch.cuda.synchronize()
            check(all(o is not None and o["status"] == 200
                      and o["events"][-1]["event"] == "done" for o in out),
                  f"(c) {leg}: a stream failed")
            if leg != "on":
                continue
            launches = dict(ca.LAUNCHES)
            # the next sample lands in a later 1 s bucket than the baseline
            time.sleep(max(0.0, 1.05 - (time.time() - t_base)))
            run.sampler.sample_once()
            h, p = run.address
            code, body, slo_ms = _get(f"http://{h}:{p}/slo")
            row = {x["name"]: x for x in json.loads(body)["slos"]}[
                "serve-ttft-p99"]
            ev = run.sampler.evaluator
            slo = next(x for x in ev.slos if x.name == "serve-ttft-p99")
            bad, total = slo.indicator(ev.tsdb, 300.0, time.time())
            sig = _get(f"http://{h}:{p}/signals")
            check(code == 200 and row["status"] != "no_data"
                  and total == P21_STREAMS and sig[0] == 200,
                  f"(c) /slo serve-ttft-p99 {row}, good + bad {total}, "
                  f"/signals {sig[0]}")
            depth = CLI_MODEL["depth"]
            check(launches["flash_fwd"] >= P21_STREAMS * depth
                  and launches["decode_attention"] > 0,
                  f"(c) K1/K2 launches {launches}")
            print(f"[{card}] (c) cli serve --generate --obs --slo: "
                  f"{P21_STREAMS} streams, /slo serve-ttft-p99 {row['status']}"
                  f" (good {total - bad:.0f} + bad {bad:.0f} = {total:.0f}), "
                  f"/slo {slo_ms:.2f} ms, /signals {sig[2]:.2f} ms; K1 "
                  f"{launches['flash_fwd']}, K2 {launches['decode_attention']}")
        finally:
            server.shutdown()
            run.close()
    print(f"[{card}] (c) {P21_STREAMS} streams' wall (host clock; reported, "
          f"not claimed): telemetry off {walls['off']:.3f} s, on "
          f"{walls['on']:.3f} s")
    return {k: launches[k] for k in ("flash_fwd", "decode_attention")}


def telemetry_end_to_end(dev, card):
    """Phase 21: (b)'s two ranks run on a thread beside (a) and (c), so
    the walls (a) and (c) print come from a card shared with them.
    Returns (a)'s K9/K10 and (c)'s K1/K2 launches."""
    t0 = time.perf_counter()
    failed = []

    def beside():
        try:
            telemetry_launch(dev, card)
        except BaseException as e:  # re-raised below, on this thread
            failed.append(e)

    thread = threading.Thread(target=beside, name="phase21-launch")
    thread.start()
    try:
        launches = telemetry_cifar(dev, card)
        launches.update(telemetry_serve(dev, card))
    finally:
        thread.join()
    if failed:
        raise failed[0]
    print(f"[{card}] phase 21 wall {time.perf_counter() - t0:.2f} s")
    return launches


def cudnn_failure_report(exc: BaseException) -> None:
    """On a failed run: cuDNN's version and flags, the device's free
    memory, the tensors of the port's innermost frame on the failing
    stack (a convolution's input and weight), and the tail of cuDNN's
    error log."""
    print(f"chip_smoke failed: {type(exc).__name__}: {str(exc)[:400]}",
          file=sys.stderr)
    cudnn = torch.backends.cudnn
    free, total = torch.cuda.mem_get_info()
    print(f"cuDNN {cudnn.version()}, benchmark {cudnn.benchmark}, "
          f"deterministic {cudnn.deterministic}; device memory free "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB, allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", file=sys.stderr)
    frame, tb = None, exc.__traceback__
    while tb is not None:
        if "sparknet_tpu_torch" in tb.tb_frame.f_code.co_filename:
            frame = tb.tb_frame
        tb = tb.tb_next
    if frame is not None:
        layer = frame.f_locals.get("self")
        lp = getattr(layer, "lp", None)
        print(f"innermost port frame: {frame.f_code.co_filename}:"
              f"{frame.f_lineno} {frame.f_code.co_name}"
              + (f" (layer {lp.name!r}, {lp.type})" if lp is not None else ""),
              file=sys.stderr)
        for name, v in frame.f_locals.items():
            for i, t in enumerate(v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(t, torch.Tensor):
                    print(f"  {name}[{i}]: {tuple(t.shape)} {t.dtype} on "
                          f"{t.device}, strides {t.stride()}", file=sys.stderr)
    if os.path.exists(CUDNN_ERROR_LOG):
        with open(CUDNN_ERROR_LOG, errors="replace") as f:
            lines = f.readlines()
        print(f"cuDNN error log {CUDNN_ERROR_LOG}: {len(lines)} lines; the "
              "last 60:", file=sys.stderr)
        sys.stderr.writelines(lines[-60:])


# wall seconds and calls of each function of this script, callees
# included (``tally_functions``), printed by ``run_all`` at the end: what
# a slice that must cut depth reads first
WALLS = {}
_WALLS_LOCK = threading.Lock()


def tally_functions() -> None:
    """Wrap every function of this script so that each call adds its
    wall time to ``WALLS``."""
    me = sys.modules[__name__]
    for name, fn in list(vars(me).items()):
        if (inspect.isfunction(fn) and fn.__module__ == __name__
                and name not in ("main", "run_all", "tally_functions")):
            setattr(me, name, _tallied(fn))


def _tallied(fn):
    @functools.wraps(fn)
    def tallied(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            with _WALLS_LOCK:
                wall, n = WALLS.get(fn.__name__, (0.0, 0))
                WALLS[fn.__name__] = (wall + time.perf_counter() - t, n + 1)
    return tallied


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs on the card",
              file=sys.stderr)
        return 2
    tally_functions()
    try:
        return run_all()
    except BaseException as e:
        cudnn_failure_report(e)
        raise


def run_all() -> int:
    from sparknet_tpu_torch.ops import _build
    from sparknet_tpu_torch.utils.devices import card_name_and_power_limit

    card = card_name_and_power_limit(0)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    start = t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(p.name for p in libs.values()))
    for p in libs.values():  # ptxas: registers and spills of each kernel
        entry, spill = "?", ""
        for line in p.with_suffix(".log").read_text().splitlines():
            m = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)"
                          r"(I\w+?EE)?", line)
            if m:  # the kernel's name and its mangled template arguments
                entry = f"{m.group(1)} {m.group(2) or ''}"
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"  {p.stem}: {entry}: {regs} registers; {spill}")

    kernels = check_kernels(dev)
    padded_decode_step(dev)
    kernels += check_bwd_kernels(dev)
    time_wide_head(dev)
    comm_kernels = check_comm_kernels(dev)
    lrn_kernels = check_lrn_kernels(dev, card) + [check_lrn_bf16(dev, card)]
    lrn_kernels += check_lrn_bf16_train(dev, card)
    seeded = {}
    launches = serve_end_to_end(dev, card, out=seeded)
    for leg in (lm_train_end_to_end, train_end_to_end,
                imagenet_train_end_to_end):
        for name, n in leg(dev, card).items():
            launches[name] = launches.get(name, 0) + n
    with tempfile.TemporaryDirectory(prefix="chip_smoke_snap_") as root:
        resumed, model_path = lm_snapshot_end_to_end(dev, card, root)
        served = serve_weights_end_to_end(dev, card, model_path,
                                          seeded["tokens"])
        for got in (resumed, served):
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
        cli_train_end_to_end(dev, card, root)
        db_launches, db_round = db_end_to_end(dev, card, root)
        for name, n in db_launches.items():
            launches[name] = launches.get(name, 0) + n
        determinism_cost(dev, card, root, db_round)
        for name, n in fault_tolerance_end_to_end(dev, card, root).items():
            launches[name] = launches.get(name, 0) + n
        for name, n in data_plane_end_to_end(dev, card, root).items():
            launches[name] = launches.get(name, 0) + n
        for name, n in staleness_profile_chaos_end_to_end(dev, card,
                                                          root).items():
            launches[name] = launches.get(name, 0) + n
        for name, n in bf16_training_end_to_end(dev, card, root).items():
            launches[name] = launches.get(name, 0) + n
    for name, n in deep_nets_end_to_end(dev, card).items():
        launches[name] = launches.get(name, 0) + n
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as root:
        for name, n in image_serving_end_to_end(dev, card, root,
                                                seeded["tokens"]).items():
            launches[name] = launches.get(name, 0) + n
    for name, n in multiprocess_ring_end_to_end(dev, card).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in allreduce_end_to_end(dev, card).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in averaging_machinery_across_processes(dev, card).items():
        launches[name] = launches.get(name, 0) + n
    for name, n in telemetry_end_to_end(dev, card).items():
        launches[name] = launches.get(name, 0) + n
    slow = sorted(((w, n, k) for k, (w, n) in WALLS.items() if w >= 1.0),
                  reverse=True)
    print(f"[{card}] wall seconds by function ({time.perf_counter() - start:.2f}"
          " s in all; callees included; calls): "
          + ", ".join(f"{k} {w:.2f} ({n})" for w, n, k in slow))
    kernels += comm_kernels + lrn_kernels
    for r in kernels:
        r["launches"] = launches[r["name"]]
        check(r["launches"] > 0, f"{r['name']} never ran on the main path")
    n_err = 0
    if os.path.exists(CUDNN_ERROR_LOG):
        with open(CUDNN_ERROR_LOG, errors="replace") as f:
            n_err = sum(1 for _ in f)
    print(f"cuDNN error log: {n_err} lines over the run")
    print(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + (("shape",) if "shape" in r else ())}
        for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
