#!/usr/bin/env python3
"""Drive avenir_tpu_torch on one CUDA card and hold its kernels against
their plain PyTorch versions.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero):

1. card and build: the ``nvidia-smi`` name and power limit,
   ``torch.version.cuda``, the time to build ``avenir_tpu_torch/csrc/*.cu``
   with nvcc for sm_90a, each kernel's registers and spills (ptxas), and
   the HMMA instructions of each bf16 tensor-core sweep kernel of K6 and
   K7, which K9 shares through its strides, and of K10's raw mode, and
   the IMMA instructions of the int8 sweeps of K11 and K12 (``cuobjdump
   -sass``; a sweep without them fails the run);
2. each kernel against its plain version on the card, with times:
   K1 (NB joint counts) at 1,048,576 churn-shaped rows — unweighted and
   0/1-weighted counts exactly equal, float weights within rtol 1e-5 — plus
   the global-atomics variant, the 200,000-row churn CLI shape, N not a
   multiple of 4 with the bins off 16-byte alignment, N = 1, F = 1, F = 64
   with C·B = 4, C·B = 51 and F = 1,500 (two launches); K4 (pair
   contingency counts) for one pair on two separate columns at 1,048,576
   and 16,777,216 rows of (9, 18) ids, the widest hospital MI pair, with
   ids -1 and n_a / n_b that drop out — unweighted and 0/1-weighted counts
   exactly equal, float weights within rtol 1e-5 — plus N = 0 and a pair
   of 256 x 512 cells (the global-atomics group); K4 for many pairs in one
   launch, held against
   its plain version and each pair against the one-pair wrapper, at the
   MI job's shape (100 pairs of (9, 18), 100,000 rows) and at 1,048,576
   rows, one pair at 200,000 and 1,048,576 rows, mixed cardinalities and
   shared columns, 64 pairs of 32 x 64 cells (three or more groups), a
   pair in the global-atomics group, and N = 0,
   1, 5, 4,098 and 100,003 off 16-byte alignment; K2 (staged top-k) at 8,192
   test x 65,536 train x 9 (the bench shape) and 65,536 test x 1,048,576
   train x 9, with small k=128 and width-512 cases; K3 (fused top-k)
   bit-identical to K2 on the normalized rows; K5 (top-k over
   feature-major operands) bit-identical to K2 at every top-k shape, plus
   a ragged shape that takes its scalar loads, and driven once through
   ``pairwise_topk_cuda(layout="tpose")``, its entry point; K2's two
   ablations at the bench shape (``csrc/topk.cu``: without the product,
   bit-identical to its plain version; without the selection, row minima
   within 1e-5 relative). The top-k gate
   (``compare_topk``): the ids are distinct train rows carrying the
   metrics reported, the metrics equal the plain version's within 1e-5
   relative, every id that differs sits in a near-tie of the plain list
   (the (k+1)-th included), and the scaled ints are within 1. The exact-tie
   hold: K2, K5 and K3 on integer features in [0, 4) (D = 9, metrics exact
   in any sum order, train rows repeated) at 8,192 × 65,536 and 16,384 ×
   1,048,576 must equal the plain version's metrics and ids position by
   position, with no near-tie allowance. K1, K2, K3, K4 and K5 are timed
   per call with CUDA events around it (the wrapper's host work
   included), and as device time by the chained timing of
   ``avenir_tpu_torch/scripts/_timing.py``, which the kernels line
   reports as ``ms``. K1 and K4, whose wrappers' host work outlasts their
   device work, are also timed from replays of a CUDA graph that holds
   one call on each of enough copies of the inputs to fill the L2 twice
   over, so that the inputs are read from HBM (``graph_ms`` in the
   kernels line). K6-K9, the fold
   kernels of the KNN experiments (``csrc/fold.cu``), against their
   plain versions at the bench shape
   (K6 at each of the five (n_acc, tile_n) configurations of the JAX
   experiment, bf16 rounding on and off), at a ragged N below the bucket
   count (1,000 × 300), at 2,051 × 16,383 and at k = 128. The fold gate
   (``compare_fold``): empty slots (BIG, -1) where the plain version has
   them, metrics within 1e-5 relative, the kernel's columns distinct and
   carrying the metrics reported, so that a column that differs from the
   plain one is a near-tie of it. K8 is held bit for bit instead, values
   and columns, at every shape. K6 with bf16 rounding, K7 and K9 run on
   the tensor cores, K8 on their tile with an add for the product: they
   are also held at their edges (d from 1 to 48 across the k-step
   boundaries, n_acc 1 and 8, 1,000 test rows, no multiple of a block's
   128, 50 train rows, below a block's 64 buckets, and k = 128), and on
   integer features in [0, 4), where every metric is exact, equal to the
   plain version position by position, columns included; the CUDA-core
   body they replaced (kept for K6 with bf16 off) is timed against them in
   turns (K6 at each n_acc of the JAX experiment, K7, K8, K9 at n_acc 4
   and 8), the packed train rows are held bit for bit against
   ``cuda_fold.tc_packed``, and K9's, packed from ``y.T``, against K6's
   of y. K10-K12, the fold kernels of the
   kernel-restructure sweeps (``csrc/fold.cu``, ``csrc/fold_int8.cu``), at
   every configuration the sweeps launch, on operands their encoders make
   from seeded data at 8,192 × 65,536 × 9: sweep 16's ``augbf16`` (K10),
   ``int8epi`` and ``int8aug`` (K11); 16b's ``tagfold`` (K6 on operands
   cast by the caller), ``augv2`` (K10), ``int8rr`` (K11, 16 candidates)
   and ``int8pk`` (K12); 16c's ``int8pk8`` and ``int8pk16`` (K12, centered,
   n_acc 8 and 16); 18's ``tpose_tag``, ``tpose_tag8`` (K9) and
   ``tpose_aug`` (K10 feature-major); sweep 11's six tile configurations
   (K6) and sweep 14's ``tpose`` (K9); plus 2,051 × 16,383 and 1,000 × 300
   (N below every bucket count). K11 and K12 must equal their plain
   versions exactly, ids included; K10, K6 and K9 pass the fold gate.
   K10 runs on the bf16 tensor cores (the raw mode of K6's body), K11 and
   K12 on the int8 tensor cores: at the sweeps' shape their former
   CUDA-core body (kept to be timed) is held exactly and timed beside
   them, with ``torch.profiler``'s split of the new body into pack, sweep
   and extraction. K10 is also held by the fold gate at widths 1 to 48
   across every k-step edge, at every n_acc, row-major and feature-major,
   at N below B and one past a whole round of steps on positive operands,
   and at k = 128, and on augmented integer operands with duplicated rows
   (exact ties) equal to its plain version position by position. K11 and
   K12 are also held exactly at every width edge
   of one 32-byte k-step (1, 4, 9, 16, 17, 19, 32) at every n_acc (16 for
   K12), with and without y2, at N below B and one past a whole number of
   steps on positive operands (where a zero pad row would win), on
   duplicated rows of small integers at 2,051 × 65,536 (ties, negative
   metrics), with operands at ±127 and with K12's metrics at
   ±(2^18 − 1); and their packed train rows equal
   ``cuda_fold.int8_tc_packed`` bit for bit;
3. the CLI path, in-process through ``avenir_tpu_torch.cli.main.main`` on
   CSVs written from the port's generators: BayesianDistribution +
   BayesianPredictor on churn (200,000 train / 50,000 test), NearestNeighbor
   on elearn (100,000 / 20,000) staged (K2) and chunked (K3) with
   byte-identical outputs, the same with ``knn.quantized=true`` and with
   ``knn.ann=true`` (the IVF index, K1 counting its lists), each one-shot
   and chunked with byte-identical outputs and no K2 or K3 launch,
   NearestNeighbor on churn with class-conditional
   weighting (K1 + K2); the elearn test rows of a part dir (200,000 rows,
   written also as one file) through the native C++ encoder at 1 thread
   and at the host's default and through the port's Python path,
   bit-identical tables, each one's host time; NearestNeighbor over that
   part dir (8 part files of 25,000 rows and ``_SUCCESS``) on its
   shard-by-shard path (each shard featurized and staged on a worker
   thread, K2 exactly once a shard) with output and Validation JSON
   byte-identical to the merged path (``shard.prefetch=false``, one K2
   call), then once more under ``torch.profiler`` for the device's busy
   share; a copy of the dir with 1% of its rows made bad (ragged,
   non-numeric, unseen class) under ``on.bad.row=quarantine``, whose
   shard report counts exactly the planted rows, whose sidecars list
   exactly them and whose surviving rows' output equals the clean run's;
   a run with ``shard.journal.keep=true`` whose records of 3 shards are
   deleted, resumed with ``--resume``: output byte-identical, 5 shards
   resumed and 3 computed (K2 exactly 3 times), the 5 kept records'
   nonces unchanged; MutualInformation on 100,000 hospital-readmission
   rows with all five selection algorithms (K4, one launch for the F² =
   100 pairs), CramerCorrelation and HeterogeneityReductionCorrelation on
   the churn train file (K4, one launch each), and small card-vs-CPU runs
   that must agree (MI count families equal and MI values within rtol
   1e-5, correlation files byte-identical). Each job must clear the
   tutorials' planted-signal bar
   (validation accuracy, MI and Cramér rankings), and each kernel of the
   path must have launched in this phase. Every kernel call a job makes is
   recorded and held against its plain version on the same operands — the
   job's own shapes, each 4,096-row chunk and the ragged tail, each MI
   call of many pairs — and timed there. The MI job runs once more under
   ``torch.profiler`` for its device time, busy share and copies;
4. the KNN experiment slice, in-process on the card at the JAX
   experiments' shape (8,192 test × 65,536 train × 9):
   ``avenir_tpu_torch.scripts.exp_fold.main`` (K6 at five
   configurations, recall against K2's exact top-k with and without bf16
   rounding, and the time of each arm: the f32 one, on the CUDA cores,
   beside the bound of its f32 product and its fold's floor) and ``avenir_tpu_torch.scripts.roofline_knn.main`` (K2 beside
   its two ablations, K7, K8, K9, the plain path and cdist + topk, each
   against the ceilings of the units that do its work, then the fold
   variants' device time split kernel by kernel). K2's ablations and
   K6-K9 must each have launched in this phase;
5. the kernel-restructure sweeps, in-process on the card at the same
   shape: ``avenir_tpu_torch.scripts.sweep11_vmem``, ``sweep14_tpose``,
   ``sweep17_tpose_protocol``, ``sweep16_kernels``, ``sweep16b_kernels``,
   ``sweep16c_kernels`` and ``sweep18_tpose_fold``, each gating its arms on
   recall against the exact top-k and timing those it keeps against K2 by
   the interleaved differential protocol. K6, K9, K10, K11 and K12 must
   each have launched in this phase, and K2 must pass its own gate;
6. the quantized and IVF KNN paths (``ops/quantized.py``, ``ops/ivf.py``:
   plain torch ops around K1) at the bench shape: ``quantized_topk`` int8
   and bf16 held to ``bench.py``'s parity gate (recall ≥ 0.985 of K2's
   exact top-k, matched scaled distances within 25, vote agreement ≥ 0.99)
   and timed chained, in rows/s beside K2's whole function; the IVF index
   (defaults nlist 256, nprobe 64) built twice and identical, full probing
   equal to ``quantized_topk`` int8 position by position, the default
   probe held to the gate and timed; every K1 launch of the builds held
   exactly against its plain version on its own operands and K1 timed
   there (chained and from graph replays reading HBM) beside its bytes
   bound; then the IVF at 1,048,576 train rows (nlist 1,024, nprobe 256):
   its build time, 8,192 queries' rows/s and the gate on a 512-row slice
   against K2, its K1 launches held and timed the same way;
7. the decision-tree family (``models/tree.py``: plain torch ops around
   K1, which counts each tree level's (node, feature, bin, class)
   histogram, weighted, one launch for each chunk of 8,192 // 10 nodes):
   ``grow_tree_device`` with giniIndex at depths 4 and 8 on the repo's
   tree workload, 1,048,576 rows (``retarget_rows(4096, seed=1)`` tiled
   256 times; 3 attributes of 10, 4 and 3 bins, 140 candidate splits,
   level widths 1, 4, 16, 64 and on to 2,048, the budget, so K1 runs at
   combined bins 10, 40, 160, 640, 2,560 and in chunks of 8,190, 2,050
   and 4,100: 4 and 13 launches a tree), each tree equal to the same
   port's growth on the CPU, every K1 launch held exactly against its
   plain version on its own operands, a tree's seconds on the host clock
   (its one readback included), the split statistics of every algorithm
   on 200,000 seeded candidates equal to the CPU's bit for bit, the
   depth-8 growth under ``torch.profiler``, and K1 at every level shape (chained, from graph
   replays reading HBM, plain, ``bincount`` of the weights over the same
   combined ids, bytes bound); then the five tree verbs on 200,000
   retarget train and 50,000 test rows, each on the card and with
   ``--device cpu``: TreeBuilder (max.depth=4), TreePredictor with
   validation (host walk and device routing), the tutorial's
   ClassPartitionGenerator at.root → SplitGenerator → DataPartitioner
   round and DataPartitioner with tree.levels.per.invocation=3, every
   file and stdout line of the card's jobs byte-identical to the CPU's,
   the root split on cartValue or loyalty and validation accuracy at
   least 0.70 (the planted rule caps it near 0.725), K1 launched (and
   each launch held) in TreeBuilder and the batched DataPartitioner;
8. the sequence models (``models/markov.py``: K4 counts the transitions,
   ``a = class·S + src`` by ``b = dst``, in launches of fewer than 2^24
   transitions; ``models/hmm.py``, ``ops/scanops.py``: plain torch ops):
   Markov training on 1,048,576 class-conditional sequences of 5-30 of
   the email-marketing tutorial's 9 states, 2 classes, drawn vectorized
   from planted matrices (about 17.3M transitions, 2 launches), each
   launch held exactly against its plain version, the int64 counts equal
   to the CPU's, the planted matrices recovered within 0.01, the
   training's seconds, K4 timed at the launch's shape (chained, from
   graph replays reading HBM, plain, ``bincount``, bytes bound), then the
   same sequences classified, labels equal to the CPU's and log odds
   within rtol 1e-6; ``predict_states`` on 1,048,576 sequences of the
   loyalty tutorial's HMM (3 states, 9 observations, 8-40 steps), the
   paths equal to the CPU's on 65,536 rows, its time, the decode's, and
   the decode under ``torch.profiler``; Baum-Welch on 8,192 (the
   associative E-step) and 81,920 (the sequential) loyalty sequences, 10
   iterations each, the LL never falling by more than 1e-2, within rtol
   1e-5 of the CPU's at every iteration, the log-parameters within 1e-4,
   a checkpointed run stopped after one chunk and resumed equal to the
   uninterrupted one, seconds an iteration and 3 iterations under
   ``torch.profiler``; then the four verbs, each on the card and with
   ``--device cpu``: MarkovStateTransitionModel on 200,000 rows (in
   memory and ``streaming.train``, K4 launched and held),
   MarkovModelClassifier (validation) on 50,000 held-out rows,
   HiddenMarkovModelBuilder on 100,000 tagged rows and untagged
   (checkpointed) on 8,192, ViterbiStatePredictor on the tagged rows'
   observations: every file and stdout line equal to the CPU's but the
   float fields (log odds within rtol 1e-6, the BaumWelch LL within rtol
   1e-5, the untagged model within 1e-4 in log space and its six printed
   digits), classifier accuracy at least 0.95 and Viterbi accuracy
   against the planted states at least 0.45;
9. forests and bandits (``models/forest.py``: K1 counts each tree's level
   histogram, one launch for each tree and chunk of nodes, with the tree
   axis leading the selection and routing; ``models/bandits``: numpy):
   the forest tutorial's forest (50 trees, ``random.split.set.size=3``,
   depth 6, bagging, seed 7, ``auto`` growth) on phase 7's 1,048,576
   retarget rows and a 16-tree forest on 1,048,576 hospital rows tiled
   alike, every K1 launch held exactly against its plain version and
   their count one for each real tree and chunk, the batched forest equal
   to the serial one tree by tree, the bootstrap draws, the batched growth
   from the drawn plans and the serial growth each timed (host clock), the
   batched growth under ``torch.profiler``, each forest equal to the
   CPU's on 65,536 of its
   rows; the device vote on 1,048,576 rows timed and equal to the host
   walk on 65,536; K1 at every level shape of both forests (chained, from
   graph replays reading HBM, plain, ``bincount``, bytes bound);
   ``grow_forest_streaming`` over 8 part files of 16,384 retarget rows (10
   trees), without bagging equal to ``grow_forest_batched`` over the same
   rows and with bagging equal to the CPU's streamed forest; then
   RandomForestBuilder (200,000 rows, 10 trees) and RandomForestPredictor
   (50,000 rows, validation, host walk and device vote) and the four
   bandit verbs on a round of 100 price-optimization groups with
   ``group.item.count.path``, each on the card and with ``--device cpu``:
   every file and stdout line equal, forest accuracy at least 0.65;
10. gradient boosting (``models/boost.py``: K1's integer mode sums each
   level's hessian and gradient quanta, two launches a chunk of nodes):
   8 rounds at depth 3 (the churn tutorial's setting) and 10 at depth 6
   on phase 7's 1,048,576 retarget rows, every K1 integer-mode launch held
   exactly against its plain version (an int64 ``index_add_``) and their
   count the expected one, the same fits on the CPU with the trees, leaf
   values and artifact bytes equal; the device margins of the deeper
   model against the host walk on every row (within 1e-5, the classes
   equal); a round at each depth timed (host clock) and under
   ``torch.profiler``; K1's integer mode at every level shape (chained,
   from graph replays reading HBM, plain, ``bincount``, bytes bound);
   K1's integer mode split across launches, exact against plain (a
   level's operands under a weight bound of 2^12; 3,145,728 rows with a
   cell past 2^31); ``grow_boosted_streaming`` over 8 part files of
   16,384 retarget rows byte-identical to in-core growth; then
   GradientBoostBuilder (200,000 rows, in core, early-stopped, and
   streamed over 8 part files) and
   GradientBoostPredictor (50,000 rows, validation, host walk and device
   route), each on the card and with ``--device cpu``: every file and
   stdout line equal, the streamed artifact equal to the in-core one,
   accuracy at least 0.65;
11. the main path's remaining modes (``text/``: K1 counts the (class,
   token) occurrences, one feature, the vocabulary as its bins;
   ``models/knn.regress`` and ``classify_from_neighbors``;
   ``ops/distance.pairwise_full``): on two seeded corpora of 50,000
   training and 12,500 test documents (5-40 tokens, two classes with
   planted class-skewed Zipf frequencies) over 30,000 words (C·V = 60,000,
   K1's global-atomics instantiation) and 4,096 (its shared-memory one),
   BayesianDistribution and BayesianPredictor with ``tabular.input=false``
   and WordCounter, each on the card and with ``--device cpu``: model
   file, predictions, validation JSON and word counts byte-identical,
   validation accuracy at least 0.9, every K1 launch held exactly against
   its plain version; K1 at the token shape (16,777,216 token ids, C = 2,
   both vocabularies: chained, from graph replays reading HBM, plain,
   ``bincount`` over ``class · V + id``, bytes bound); NearestNeighbor
   regression at the elearn CLI shape (100,000 / 20,000 rows, 9 features,
   a schema whose class attribute is a planted numeric score) with all
   four ``regression.method``s, staged (K2) and with
   ``feed.chunk.rows=4096`` (K3), every K2 and K3 call held by
   ``compare_topk``, staged and chunked byte-identical, each method's mean
   absolute error below half the mean predictor's, for
   ``multiLinearRegression`` the ``--device cpu`` output equal but for
   rows at a near tie of their neighbors (counted, each held in float64);
   SameTypeSimilarity self-matching on 1,024 elearn rows and
   ``inter.set.matching`` on 128 × 4,096, files byte-identical to
   the CPU's; ``pairwise_full`` at 8,192 × 65,536 × 9 (its first 256 rows
   equal to the CPU's), timed beside its bytes bound and ``torch.cdist``;
   the replay pipeline on those rows: BayesianDistribution,
   BayesianPredictor ``output.feature.prob.only=true`` (its continuous
   probabilities from XLA's exp and log, equal card to CPU: ROADMAP C9,
   repaired), FeatureCondProbJoiner, NearestNeighbor
   ``neighbor.data.path`` on the 6-field class-conditional records with
   validation and on the 3-field distance file, files byte-identical card
   to CPU at every step, the 3-field replay agreeing with the fused
   NearestNeighbor on at least 0.97 of rows;
12. the last batch verbs and the streamed and per-shard Naive Bayes and
   MI paths (``explore/sampling.py`` with ``utils/jrandom.py``'s threefry
   draws, ``models/logistic.py``, ``models/fisher.py``,
   ``utils/projection.py``, ``naive_bayes.train_streamed``, the CLI's
   ``_run_nb_sharded`` and ``_run_mi_sharded``), each job on the card and
   with ``--device cpu``, stdout and files byte-identical:
   BayesianDistribution ``streaming.train`` over 1,048,576 churn rows
   (phase 3's tiled) in
   8 MiB windows, one K1 launch a window, and over 262,144 elearn rows
   (continuous: no K1), each model equal to the card's in-memory train;
   ``shard.parts`` over 8 part files of 131,072 of those churn rows (K1
   once a shard) and MutualInformation over 8 of 131,072 hospital rows
   (K4 once a shard), equal to the merged jobs, then ``--resume`` after
   dropping one shard's commit (7 resumed, 1 computed, one launch, the
   same bytes); LogisticRegressionJob on 262,144 elearn rows, 100
   iterations of the f32 device loop and of the float64 loop
   (``convergence.threshold=1e-5``), and a run split at iteration 40 and
   resumed from its history equal to the uninterrupted one;
   FisherDiscriminant on those rows; UnderSamplingBalancer (exact and
   ``streaming.bootstrap``) and BaggingSampler over 262,144 churn
   lines; Projection of ~1,000,000 purchase rows, the native pass equal
   to the Python pass. Every K1 and K4 call held against its plain
   version; K1 timed at the window and shard shapes, K4 at the shard
   shape;
13. the plan path the CLI runs by default (``plan_phase``, also
   runnable alone): BayesianDistribution then NearestNeighbor in one
   process on 1,048,576 churn train rows and 50,000 test rows,
   ``ingest.split.bytes`` cutting each table into at least 8 splits and
   ``ingest.workers`` = min(8, CPUs), with ``--metrics-out``: the files
   and stdout equal the ``plan.enable=false`` run's byte for byte, K1's
   and K2's launches equal on both paths, KNN's ``last_run()`` skips
   ``encode:train`` and hits ``stage:train``, and the reports hold the
   ``plan.*``, ``feed.h2d``, ``ingest.*`` and ``job.*`` names; the host
   wall of NB's encode in parallel against ``ingest.parallel=false``;
   KNN with ``feed.chunk.rows`` at ``feed.depth=2`` (K3 through the
   threaded ``DeviceFeed``) equal to ``feed.depth=1``, with its
   ``feed.overlap_fraction``; NB with ``--device cpu``, then NB and KNN
   on the card with ``--profile-dir``, in this process and each in a
   fresh one: the card's NB misses the CPU's staged table and launches
   K1, KNN launches K2, every trace holds the job's host ops, and each
   fresh trace names ``cfb_counts_kernel`` or ``topk_kernel``;
   ``--explain`` printing the plan with no launch;
14. the online bandit loop (``online_phase``, also runnable alone), which
   launches none of the port's kernels (the learners are torch ops):
   ReinforcementLearnerTopology over 4,096 tutorial session ids and a
   reward file of ``LeadGenSimulator`` rewards for a quarter of them, for
   each of the ten learners on the card and with ``--device cpu`` (in
   processes side by side), actions files and JSON lines byte-identical,
   with each leg's host wall; ``run()`` alone on the card for each
   learner over 1,024 of the events (its decisions/s); ``step()`` driven
   by ``LeadGenSimulator`` for 256 events on the card and on the CPU, the
   same picks and state, the most picked action the simulator's best;
   one loop over ``RedisQueues`` on an in-process MiniRedis (pending
   ledger armed) whose actions equal the in-process queues'; a
   ``checkpoint.dir`` resume on the card whose state equals the saved
   one, no reward folded twice; and, in a fresh process, one 64-event
   ``run()`` batch of three learners under ``torch.profiler``: its torch
   ops, the card's kernels and copies, and the busy share.
15. the serving engine and the snapshot lifecycle (``engine_phase``, also
   runnable alone, ``python3 chip_smoke.py engine_phase``), which launch
   none of the port's kernels: ReinforcementLearnerTopology with
   ``serving.engine=true`` on the first 1,024 of phase 14's ids for each
   of the ten learners on the card (UCB1's and UCB2's in processes of
   their own), each actions file byte-equal to the first 1,024 lines of
   phase 14's loop file, the JSON lines' counts the loop's; the engine over ``RedisQueues`` on an in-process MiniRedis
   equal to its in-process file; each learner's
   ``next_action_batch_async`` at 1, 64, 256 and 64 + 9 decisions under
   ``torch.cuda.set_sync_debug_mode("error")`` (a synchronizing call
   fails the phase), its actions equal to the CPU's; a ``lifecycle.dir``
   round trip (a card run publishes v1, a second restores it and
   publishes v2, equal to a ``--device cpu`` run over a copy of the
   card's registry), ``Lifecycle retrain`` (its payload equal card to
   CPU), ``list``, ``show`` and ``prune``; the admission gate
   (``engine.admission.high``), shed + served = produced, card equal to
   CPU; and the engine's decisions/s against ``OnlineLearnerLoop.run()``
   on the same prefilled 1,024 events (UCB1, UCB2 256), its
   ``overlap_fraction`` and its host ms a batch waiting for the card and
   queueing its work.
16. the live ANN index and the live observability layer (``live_phase``,
   also runnable alone): a ``LiveAnnIndex`` (``models/live_ann.py``; K1
   counts each appended batch into its lists through
   ``ivf.assign_counts``, and each Lloyd step of a rebuild) over 1,048,576
   rows of phase 6's width (nlist auto, 15 Lloyd steps) with a
   ``RetrainDaemon`` thread bound to it; 32 appends of 4,096 rows into its
   overflow tails (budget 512 a list, a wave requested at a tail fill of
   0.125), each followed by 64 queries (k = 5) served through a
   ``ServingEngine`` over an ``AnnServingLearner``, whose swap source
   hands each published wave to ``install_state``, which delegates to
   ``LiveAnnIndex.adopt``. Gates: no query error, a wave requested,
   published and adopted mid-stream, no inline rebuild, the row count,
   recall ≥ 0.98 on 512 rows against K2's exact top-k over the union,
   full probing equal to a fresh build over the union, the
   ``lifecycle.swap`` span's p99 ≤ 250 ms, no daemon error, every K1 call
   exact against its plain version; with the append rate, the queries' ms
   with a wave in flight and with none, and each wave's wall; K1 at the
   append shape (chained, from graph replays reading HBM, plain,
   ``bincount``, bytes bound). Then NearestNeighbor with
   ``knn.ann.live=true`` on phase 3's elearn rows, its file byte-equal to
   ``knn.ann.live=false``'s; phase 3's elearn job and the engine verb
   (UCB2 on the first 1,024 of phase 14's ids) each in a fresh process
   with ``--obs-port 0`` (the elearn one with ``--metrics-out`` and
   ``alerts.enable=true``), ``/metrics`` and ``/healthz`` scraped while
   they run, the engine's gauges among them, lines and files equal to the
   unarmed jobs', the ``.prom`` and ``.alerts.jsonl`` written; and a job
   that fails leaving ``<metrics-out>.flight.jsonl``.
17. boosted serving, the grouped engine and the broker fleet
   (``serving_phase``, also runnable alone): (a) at phase 10's shape
   (1,048,576 retarget rows, 8 rounds at depth 3, the budgets
   ``boost_refit_train_fn`` pins), ``_serve_margins`` on the card bit-equal
   to the CPU's at every power-of-two batch up to 64 and
   ``BoostServingLearner``'s dispatch under
   ``set_sync_debug_mode("error")``; then 65,536 events scored by a
   ``ServingEngine`` over MiniRedis with a ``BoostServingLearner``, a
   Page-Hinkley ``DriftMonitor`` over a reward regime shift requesting a
   ``RetrainDaemon`` wave (K1's integer mode in ``grow_boosted``, each
   call exact against plain) that swaps in mid-drain; gates: every event
   answered once, the ledger empty, no daemon error, decision p99 under
   500 ms; (b) ``GroupedLearner.next_all_async`` of the ten learners under
   ``set_sync_debug_mode("error")``, and the ``GroupedServingEngine`` (16
   groups, phase 14's 4,096 ids and 1,024 rewards) for each learner on
   the card, its action queue equal to the CPU's (in a process beside
   it), over in-process queues and, for softMax, ``RedisQueues`` on
   MiniRedis; decisions/s beside phase 15's ``ServingEngine`` on the same
   ids; (c) the verb's ``broker.shards`` over two MiniRedis brokers on
   1,024 ids equal to the in-process engine's file, the grouped engine over
   ``ShardedQueues`` (16 groups on two shards) equal to (b)'s answers, and
   the groups re-routed over a third shard with ``migrate_group_queues``:
   nothing lost, nothing left on the old side. (b)'s grouped legs run on
   phase 15's first 1,024 ids;
18. the scale-out tier (``scaleout_phase``, also runnable alone), worker
   processes over one MiniRedis broker, which launch none of the port's
   kernels: (a) one worker process on the card and one with ``--device
   cpu`` for softMax and UCB1, through the step loop and through
   ``--engine``, all eight started together, each over its own broker
   prefilled with the same 64 events, 16 rewards and stop sentinels (8
   groups, 4 actions), the card's action queue equal to the CPU's byte
   for byte; (c) beside (a), ``run_chaos(2, n_events=400,
   kill_after=100)`` on the card through the step loop and the engine:
   nothing lost, the ledger empty, duplicates within 50 and 128; then (b)
   ``run_scaleout`` on the card at the tutorial's width (8 groups, 4
   actions, ``batch.size`` 8) and sizes, 1,000 throughput events and 200
   paced at 100/s, through the step loop at 4 workers (each worker's own
   rate from its heartbeats; no 1-worker leg, for the time limit) and
   through the engine at 2 workers on 2,000: every event answered once,
   ownership disjoint and total, heartbeats, with decisions/s, p50 and
   p90 latency, ``best_action_fraction``, the stragglers and each
   worker's seconds from spawn to its first heartbeat; (d) once
   the 4 workers of (b) are up, the device memory taken since their spawn
   and ``nvidia-smi --query-compute-apps``; (e) ``run_scaleout(2)`` with
   ``device="cpu"`` for scale.

Then one JSON line of per-kernel numbers (K1-K3's launches and K4's
through ``pair_counts_multi`` from the CLI phase; K4's through
``pair_counts``, one pair at 16,777,216 rows, and K5's from their entry
points' runs in phase 2: no CLI job counts a single pair, and no CLI key
selects the tpose layout; K2's
ablations' and K7-K8's from phase 4, K6's and K9's from phases 4 and 5,
K10-K12's from phase 5; a second K1 entry at the IVF shape, with the
launches of phase 6's builds, and a third at the tree shape, with the
launches of phase 7's two trees (its CLI jobs' in ``cli_launches``) and
each level shape's times in ``levels``; a fourth, K4 at the Markov
shape, with the launches of phase 8's training at scale (its CLI jobs' in
``cli_launches``); a fifth, K1 at the forest shape (``K1-forest``), with
the launches of phase 9's two forests at scale (its streamed growth's in
``stream_launches``, its CLI jobs' in ``cli_launches``) and each level
shape's times in ``levels``; a sixth, K1's integer mode at the boosting
shape (``K1-int``), with the launches of phase 10's two fits at scale
(its streamed growth's in ``stream_launches``, its CLI jobs' in
``cli_launches``) and of phase 17's refit waves (also in
``serving_launches``), a round's time at each depth in ``round_ms`` and
each level shape's times in ``levels``; a seventh, K1 at the token shape
(``K1-text``), with the launches of phase 11's text jobs and both
vocabularies' times in ``vocabularies``; an eighth and a ninth, K1 at
phase 12's stream-window and NB-shard shapes (``K1-stream``) and K4 at
its MI-shard shape (``K4-shard``), with phase 12's launches and each
shape's times in ``shapes``; a tenth, K1 at the live-ANN append shape
(``K1-live``), with the launches of phase 16's stream (the base build,
the appends, the waves); K1's, K2's and K3's launches
count phase 11's and phase 13's CLI jobs too (K2's and K3's ``launches`` are phase 3's
jobs and phase 11's regression and replay jobs); K6-K12 add ``parent_ms``, the
chained time of the CUDA-core body they replaced, in the same run; each
bound the larger
of the bytes over 3.35 TB/s and the operations at the card's rate for
their type, K2's ablations and K6-K9 with the product types and
instructions a pair of ``roofline_knn.WORK``), the
``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repo, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import inspect
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores, bf16
# (f32 sums) and int8 (int32 sums) on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
SEED = 20261016
# the CLI phase's data sizes
CHURN_TRAIN, CHURN_TEST = 200_000, 50_000
ELEARN_TRAIN, ELEARN_TEST = 100_000, 20_000
HOSP_ROWS = 100_000          # 5x the MI tutorial's 20,000 records
# the part dir of the CLI phase: 8 MR part files of 25,000 elearn test rows,
# one row in 100 of its copy made bad
PART_FILES, PART_ROWS = 8, 25_000
BAD_EVERY = 100
FEED_CHUNK_ROWS = 4096
MI_ALGORITHMS = ("mutualInfoMaximizer,mutualInfoFeatureSelection,"
                 "jointMutualInfo,doubleInputSymmetricalRelevance,"
                 "minRedundancyMaxRelevance")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_registers(build_log: str) -> str:
    """Registers per thread of each kernel instantiation, and the bytes
    it spills (stores/loads) where it spills, from the ``-Xptxas -v``
    lines of nvcc's build log, names demangled by ``c++filt`` where the
    toolchain has it."""
    entries, name, spill = [], None, ""
    for line in build_log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name, spill = found.group(1), ""
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if found and found.groups() != ("0", "0"):
            spill = f" spill {found.group(1)}/{found.group(2)} B"
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            entries.append((name, found.group(1) + spill))
            name = None
    names = [n for n, _ in entries]
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    from avenir_tpu_torch.scripts.roofline_knn import kernel_name
    return "; ".join(f"{kernel_name(n)} {regs}"
                     for n, (_, regs) in zip(names, entries))


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def hbm_copies(n_bytes: int) -> int:
    """Copies of a call's inputs of ``n_bytes`` that, read in turn, fill
    the card's L2 twice over, so that no call finds its inputs there."""
    return max(1, math.ceil(2 * L2_BYTES / max(n_bytes, 1)))


def hbm_graph_ms(call, inputs, n_bytes, dev) -> float:
    """Device time of ``call(*inputs)`` with its inputs read from HBM:
    replays of a CUDA graph that holds one call on each of
    ``hbm_copies(n_bytes)`` copies of ``inputs`` in turn
    (``_timing.graph_ms``: the wrapper's device work and none of its host
    work), divided by the copies."""
    from avenir_tpu_torch.scripts._timing import graph_ms
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(hbm_copies(n_bytes) - 1)]

    def run():
        for args in copies:
            call(*args)
    return graph_ms(run, dev) / len(copies)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pair_bound_ms(dev, m, n, d, n_bytes, product, ops_per_pair):
    """Bound of a kernel over m × n (row, column) pairs: the larger of the
    bytes over the memory rate and its operations at their units' rates.
    ``product`` is the dot's type: "bf16" (bf16-rounded operands, f32 sums)
    or "int8" (int32 sums): 2·m·n·d on the tensor cores, beside the CUDA
    cores; "f32" (2·m·n·d on the CUDA cores, which also run the per-pair
    instructions) or None. ``ops_per_pair`` f32 or int32 instructions a
    pair on the CUDA cores: the metric, then the compare and selects or
    the minimum that consume it, at SMs × 128 lanes × the maximum SM
    clock."""
    from avenir_tpu_torch.scripts.roofline_knn import lane_ops_per_s
    t_pairs = m * n * ops_per_pair / lane_ops_per_s(dev)
    tensor_rate = {"bf16": PEAK_BF16_FLOPS, "int8": PEAK_INT8_OPS}
    t_dot = 2.0 * m * n * d / tensor_rate.get(product, PEAK_F32_FLOPS)
    t_ops = (max(t_dot, t_pairs) if product in tensor_rate else
             t_dot + t_pairs if product == "f32" else t_pairs) * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def k1_case(dev, H, label, n, f, c, b, weights, offset=0):
    """K1 against its plain version on seeded ids of one shape, ids -1 and
    b (bins) and c (labels) among them; ``offset`` puts the bins one
    element past a 16-byte boundary, so that the kernel stages them with
    4-byte copies. Unweighted and 0/1 weights exact, float weights within
    rtol 1e-5 (f32 atomics in any order against one f64 sum rounded to
    f32); returns the float-weighted max abs error."""
    gen = torch.Generator(device=dev).manual_seed(n * 131 + f)
    bins = torch.randint(-1, b + 1, (n * f + offset,), generator=gen,
                         dtype=torch.int32, device=dev)[offset:].view(n, f)
    labels = torch.randint(-1, c + 1, (n,), generator=gen, dtype=torch.int32,
                           device=dev)
    err = 0.0
    for kind in weights:
        w = None
        if kind == "01":
            w = (torch.rand(n, generator=gen, device=dev) < 0.7).float()
        elif kind == "float":
            w = torch.rand(n, generator=gen, device=dev)
        got = H.class_feature_bin_counts(bins, labels, c, b, w)
        want = H.class_feature_bin_counts_plain(bins, labels, c, b, w)
        if kind == "float":
            if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
                raise AssertionError(f"K1 {label}: float-weighted counts "
                                     "beyond rtol 1e-5")
            err = max(err, float((got - want).abs().max()))
        elif not torch.equal(got, want):
            raise AssertionError(f"K1 {label}: {kind or 'unweighted'} "
                                 "counts differ from plain")
    return err


def check_k1(dev, rng):
    from avenir_tpu_torch.ops import cuda_histogram as H
    n, f, c, b = 1_048_576, 5, 2, 5
    bins = rng.integers(-1, b + 1, size=(n, f)).astype(np.int32)  # some drop
    labels = rng.integers(0, c, size=n).astype(np.int32)
    labels[rng.random(n) < 0.01] = c                              # some drop
    tb = torch.from_numpy(bins).to(dev)
    tl = torch.from_numpy(labels).to(dev)
    w01 = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32)).to(dev)
    wf = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    err = 0.0
    for name, w in (("unweighted", None), ("0/1 weights", w01)):
        got = H.class_feature_bin_counts(tb, tl, c, b, w)
        want = H.class_feature_bin_counts_plain(tb, tl, c, b, w)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 {name} counts differ from plain")
    got = H.class_feature_bin_counts(tb, tl, c, b, wf)
    want = H.class_feature_bin_counts_plain(tb, tl, c, b, wf)
    if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
        raise AssertionError("K1 float-weighted counts beyond rtol 1e-5")
    err = float((got - want).abs().max())
    # the global-atomics variant: 64 * 8 * 128 int32 cells exceed 227 KB
    gb = torch.randint(-1, 129, (200_000, 64), dtype=torch.int32, device=dev)
    gl = torch.randint(0, 8, (200_000,), dtype=torch.int32, device=dev)
    if not torch.equal(H.class_feature_bin_counts(gb, gl, 8, 128),
                       H.class_feature_bin_counts_plain(gb, gl, 8, 128)):
        raise AssertionError("K1 global-atomics variant differs from plain")
    all_kinds = (None, "01", "float")
    cases = (("churn CLI 200,000 x 5", 200_000, 5, 2, 5, all_kinds, 0),
             ("N not a multiple of 4, bins off 16-byte alignment", 200_003,
              5, 2, 5, all_kinds, 1),
             ("N = 1", 1, 5, 2, 5, all_kinds, 0),
             ("F = 1", 100_001, 1, 2, 5, all_kinds, 0),
             ("F = 64, C*B = 4", 100_000, 64, 2, 2, all_kinds, 0),
             ("C*B = 51 > 32", 100_002, 7, 3, 17, all_kinds, 0),
             ("F = 1,500 (two launches)", 3_001, 1_500, 2, 3, (None, "01"),
              0))
    for label, *shape, kinds, offset in cases:
        err = max(err, k1_case(dev, H, label, *shape, kinds, offset))

    from avenir_tpu_torch.scripts._timing import chain_ms
    per_call = cuda_ms(lambda: H.class_feature_bin_counts(tb, tl, c, b), 20)
    ms = chain_ms(lambda: H.class_feature_bin_counts(tb, tl, c, b), dev)
    hbm_ms = hbm_graph_ms(lambda x, y: H.class_feature_bin_counts(x, y, c, b),
                          (tb, tl), n * (f + 1) * 4, dev)
    plain_ms = cuda_ms(lambda: H.class_feature_bin_counts_plain(tb, tl, c, b),
                       5)
    combined = (torch.arange(f, device=dev).reshape(1, f) * (c * b)
                + tl.long().reshape(n, 1) * b + tb.long())
    valid = (tb >= 0) & (tb < b) & (tl.reshape(n, 1) < c)
    flat = combined[valid]
    library_ms = cuda_ms(lambda: torch.bincount(flat, minlength=f * c * b), 20)
    bound, by = bound_ms(n * (f + 1) * 4 + f * c * b * 4, n * f)
    log(f"phase 2 K1 counts n={n} f={f} c={c} b={b}: exact (unweighted, 0/1),"
        f" float weights max abs err {err:.3g} (rtol 1e-5), global variant "
        f"exact; also exact at {'; '.join(case[0] for case in cases)}; "
        f"kernel {ms:.4f} ms chained, {hbm_ms:.4f} ms device from graph "
        f"replays reading HBM ({bound / hbm_ms:.1%} of bound), "
        f"{per_call:.4f} ms per call host included, plain {plain_ms:.4f} ms,"
        f" bincount {library_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return {"name": "cfb_counts (K1)", "route": "cuda",
            "source": "avenir_tpu_torch/csrc/hist.cu",
            "replaces": "avenir_tpu/ops/pallas_histogram.py:57",
            "max_abs_err": err, "ms": ms, "graph_ms": hbm_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms}


def pair_flat(a, b, n_a, n_b):
    """The masked combined ids ``a·n_b + b`` that ``torch.bincount``
    counts: the library call that computes K4's unweighted function."""
    valid = (a >= 0) & (a < n_a) & (b >= 0) & (b < n_b)
    return (a.long() * n_b + b.long())[valid]


def multi_flat(ids, pairs, cards):
    """The masked combined ids ``offset[p] + a·n_b + b`` of every pair:
    what one ``torch.bincount`` counts to compute K4 over many pairs."""
    from avenir_tpu_torch.ops import cuda_histogram as H
    offsets = H.pair_offsets(pairs, cards)
    return torch.cat([offsets[p] + pair_flat(ids[a], ids[b], cards[a],
                                             cards[b])
                      for p, (a, b) in enumerate(pairs)])


def multi_bytes(ids, pairs, cards, weighted):
    """Bytes K4 over many pairs must move: each column its pairs name and
    the weights read once, the counts written once."""
    from avenir_tpu_torch.ops import cuda_histogram as H
    columns = len({c for pair in pairs for c in pair})
    return ((columns + weighted) * ids.shape[1]
            + H.pair_offsets(pairs, cards)[-1]) * 4


def k4_multi_case(dev, H, label, ids, pairs, cards, kinds=(None, "01",
                                                           "float")):
    """K4 over many pairs against its plain version, and each pair's block
    against the one-pair wrapper on the pair's two rows of ``ids``:
    unweighted and 0/1 weights exact, float weights within rtol 1e-5;
    returns the float-weighted max abs error."""
    gen = torch.Generator(device=dev).manual_seed(ids.shape[1] + len(pairs))
    n = ids.shape[1]
    err = 0.0
    for kind in kinds:
        w = None
        if kind == "01":
            w = (torch.rand(n, generator=gen, device=dev) < 0.7).float()
        elif kind == "float":
            w = torch.rand(n, generator=gen, device=dev)
        got = H.pair_counts_multi(ids, pairs, cards, w)
        want = H.pair_counts_multi_plain(ids, pairs, cards, w)
        if kind == "float":
            if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
                raise AssertionError(f"K4 {label}: float-weighted counts "
                                     "beyond rtol 1e-5")
            err = max(err, float((got - want).abs().max()))
            continue
        if not torch.equal(got, want):
            raise AssertionError(f"K4 {label}: {kind or 'unweighted'} counts "
                                 "differ from plain")
        for block, (a, b) in zip(H.split_pairs(got, pairs, cards), pairs):
            if not torch.equal(block, H.pair_counts(ids[a], ids[b], cards[a],
                                                    cards[b], w)):
                raise AssertionError(f"K4 {label}: pair ({a}, {b}) differs "
                                     "from the one-pair wrapper")
    return err


def check_k4(dev, rng):
    """K4 for one pair through ``pair_counts`` on two separate columns, at
    1,048,576 and 16,777,216 rows: unweighted and 0/1 weights exact, float
    weights within rtol 1e-5 (f32 atomics in any order against one f64 sum
    rounded to f32); N = 0; a pair too large for shared memory (the
    global-atomics group); the launches of one call of its entry point,
    ``ops.histogram.pair_counts``; then K4 over many pairs."""
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.ops import histogram as TH
    from avenir_tpu_torch.scripts._timing import chain_ms
    n_a, n_b = 9, 18          # the widest hospital pair: 9 bins x 9 bins * 2
    for n in (1_048_576, 16_777_216):
        # ids -1 and n_a / n_b drop out
        a = torch.from_numpy(rng.integers(-1, n_a + 1, size=n)
                             .astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(-1, n_b + 1, size=n)
                             .astype(np.int32)).to(dev)
        w01 = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32)) \
            .to(dev)
        wf = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
        for name, w in (("unweighted", None), ("0/1 weights", w01)):
            got = H.pair_counts(a, b, n_a, n_b, w)
            if not torch.equal(got, H.pair_counts_plain(a, b, n_a, n_b, w)):
                raise AssertionError(f"K4 {name} counts differ from plain "
                                     f"at n={n}")
        got = H.pair_counts(a, b, n_a, n_b, wf)
        want = H.pair_counts_plain(a, b, n_a, n_b, wf)
        if not torch.allclose(got, want, rtol=1e-5, atol=0.0):
            raise AssertionError(f"K4 float-weighted counts beyond rtol 1e-5 "
                                 f"at n={n}")
        err = float((got - want).abs().max())

        def timed(x, y):
            return H.pair_counts(x, y, n_a, n_b)
        per_call = cuda_ms(lambda: timed(a, b), 20)
        ms = chain_ms(lambda: timed(a, b), dev)
        hbm_ms = hbm_graph_ms(timed, (a, b), 2 * n * 4, dev)
        plain_ms = cuda_ms(lambda: H.pair_counts_plain(a, b, n_a, n_b), 5)
        flat = pair_flat(a, b, n_a, n_b)
        library_ms = cuda_ms(lambda: torch.bincount(flat,
                                                    minlength=n_a * n_b), 20)
        bound, by = bound_ms(2 * n * 4 + n_a * n_b * 4, n)
        log(f"phase 2 K4 one pair n={n} cells {n_a}x{n_b}: exact "
            f"(unweighted, 0/1), float weights max abs err {err:.3g} (rtol "
            f"1e-5); kernel {ms:.4f} ms chained, {hbm_ms:.4f} ms device from "
            f"graph replays reading HBM ({bound / hbm_ms:.1%} of bound), "
            f"{per_call:.4f} ms per call host included, plain "
            f"{plain_ms:.4f} ms, bincount {library_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({by})")
        del flat, w01, wf
    entry = {"name": "pair_counts (K4)", "route": "cuda",
             "source": "avenir_tpu_torch/csrc/hist.cu",
             "replaces": "avenir_tpu/ops/pallas_histogram.py:133",
             "max_abs_err": err, "ms": ms, "graph_ms": hbm_ms,
             "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
             "library_ms": library_ms}
    # the one-pair entry point's path: counts from 0, one call
    H.pair_counts.launches = 0
    TH.pair_counts(a, b, n_a, n_b)
    one_launches = H.pair_counts.launches
    if one_launches != 1:
        raise AssertionError(f"histogram.pair_counts launched K4 "
                             f"{one_launches} times, not once")
    del a, b
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    if not torch.equal(H.pair_counts(empty, empty, n_a, n_b),
                       torch.zeros((n_a, n_b), device=dev)):
        raise AssertionError("K4 with N = 0 is not all zeros")
    # the global-atomics group: 256 * 512 int32 cells exceed 227 KB
    ga = torch.randint(-1, 257, (200_000,), dtype=torch.int32, device=dev)
    gb = torch.randint(-1, 513, (200_000,), dtype=torch.int32, device=dev)
    if not torch.equal(H.pair_counts(ga, gb, 256, 512),
                       H.pair_counts_plain(ga, gb, 256, 512)):
        raise AssertionError("K4 global-atomics group differs from plain")
    log("phase 2 K4: N = 0 gives zeros; one pair of 256 x 512 cells (the "
        "global-atomics group) exact")
    return {"one": entry, "one_launches": one_launches,
            "multi": check_k4_multi(dev, H, chain_ms)}


def mi_ids(dev, n_f, n, seed):
    """The MI job's id matrix at n rows: F bin columns in [-1, 10) against
    9 bins and F combined (bin, class) columns in [-1, 19) against 18, ids
    -1 and the cardinality dropping out; every (f, F + g) pair."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.cat([
        torch.randint(-1, 10, (n_f, n), generator=gen, dtype=torch.int32,
                      device=dev),
        torch.randint(-1, 19, (n_f, n), generator=gen, dtype=torch.int32,
                      device=dev)])
    pairs = [(f, n_f + g) for f in range(n_f) for g in range(n_f)]
    return ids, pairs, [9] * n_f + [18] * n_f


def check_k4_multi(dev, H, chain_ms):
    """K4 over many pairs in one launch: the MI job's 100 pairs at its
    100,000 rows and at 1,048,576, one (9, 18) pair at the churn CLI's
    200,000 rows and at 1,048,576 (one histogram copy a warp, the 32 lanes
    on one pair), mixed cardinalities with columns shared by several
    pairs, a list that needs three or more groups, a pair that takes the
    global-atomics group, N = 0 and 1 and N not a multiple of 4 with the
    ids off 16-byte alignment; then times at the MI shape."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = 0.0
    for n in (100_000, 1_048_576):
        err = max(err, k4_multi_case(dev, H, f"MI n={n}",
                                     *mi_ids(dev, 10, n, SEED + n)))
    for n in (200_000, 1_048_576):
        ids = torch.stack([torch.randint(-1, c + 1, (n,), generator=gen,
                                         dtype=torch.int32, device=dev)
                           for c in (9, 18)])
        (group,) = H.plan_pair_groups([(0, 1)], [9, 18])
        if group.copies != H.WARPS:
            raise AssertionError(f"one pair is planned with {group.copies}"
                                 " histogram copies, not one a warp")
        err = max(err, k4_multi_case(dev, H, f"one pair n={n}", ids,
                                     [(0, 1)], [9, 18]))
    cards = [3, 7, 1, 12, 5, 40]
    mixed = [(0, 1), (1, 0), (2, 3), (3, 3), (4, 5), (0, 5), (5, 1), (1, 1)]
    ids = torch.stack([torch.randint(-1, c + 1, (100_003,), generator=gen,
                                     dtype=torch.int32, device=dev)
                       for c in cards])
    err = max(err, k4_multi_case(dev, H, "mixed cardinalities", ids, mixed,
                                 cards))
    wide_cards = [32] * 8 + [64] * 8
    wide = [(a, 8 + b) for a in range(8) for b in range(8)]
    n_groups = len(H.plan_pair_groups(wide, wide_cards))
    if n_groups < 3:
        raise AssertionError(f"64 pairs of 32 x 64 planned as {n_groups} "
                             "groups, not 3 or more")
    ids = torch.stack([torch.randint(-1, c + 1, (50_001,), generator=gen,
                                     dtype=torch.int32, device=dev)
                       for c in wide_cards])
    err = max(err, k4_multi_case(dev, H, f"{n_groups} groups", ids, wide,
                                 wide_cards))
    big_cards = [256, 512, 4]
    ids = torch.stack([torch.randint(-1, c + 1, (200_000,), generator=gen,
                                     dtype=torch.int32, device=dev)
                       for c in big_cards])
    err = max(err, k4_multi_case(dev, H, "global-atomics group", ids,
                                 [(0, 1), (2, 2), (1, 2)], big_cards))
    for n in (0, 1, 5, 4_098, 100_003):
        k, total = 4, 4 * n + 1
        # one element past a 16-byte boundary: 4-byte copies
        base = torch.randint(-1, 9, (total,), generator=gen,
                             dtype=torch.int32, device=dev)
        ids = base[1:].view(k, n)
        err = max(err, k4_multi_case(dev, H, f"n={n} unaligned", ids,
                                     [(0, 1), (2, 3), (1, 1), (3, 0)],
                                     [8, 7, 3, 8]))
    ids, pairs, cards = mi_ids(dev, 10, 100_000, SEED)
    n = ids.shape[1]
    per_call = cuda_ms(lambda: H.pair_counts_multi(ids, pairs, cards), 20)
    ms = chain_ms(lambda: H.pair_counts_multi(ids, pairs, cards), dev)
    hbm_ms = hbm_graph_ms(lambda x: H.pair_counts_multi(x, pairs, cards),
                          (ids,), ids.numel() * 4, dev)
    plain_ms = cuda_ms(lambda: H.pair_counts_multi_plain(ids, pairs, cards),
                       5)
    flat = multi_flat(ids, pairs, cards)
    total = H.pair_offsets(pairs, cards)[-1]
    library_ms = cuda_ms(lambda: torch.bincount(flat, minlength=total), 20)
    bound, by = bound_ms(multi_bytes(ids, pairs, cards, False),
                         n * len(pairs))
    log(f"phase 2 K4 {len(pairs)} pairs of (9, 18) in one launch, n={n}: "
        f"exact against plain and each pair against the one-pair wrapper "
        f"(unweighted, 0/1; also at 1,048,576 rows, one pair at 200,000 and "
        f"1,048,576 rows, mixed cardinalities, {n_groups} groups, a "
        f"global-atomics group, n = 0, 1, 5, 4,098, 100,003 unaligned), "
        f"float weights max abs err {err:.3g} (rtol 1e-5); kernel "
        f"{ms:.4f} ms chained, {hbm_ms:.4f} ms device from graph replays "
        f"reading HBM ({bound / hbm_ms:.1%} of bound), {per_call:.4f} ms "
        f"per call host included, plain {plain_ms:.4f} ms, bincount "
        f"{library_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return {"name": "pair_counts_multi (K4)", "route": "cuda",
            "source": "avenir_tpu_torch/csrc/hist.cu",
            "replaces": "avenir_tpu/ops/pallas_histogram.py:133",
            "max_abs_err": err, "ms": ms, "graph_ms": hbm_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms}


def compare_topk(label, got, plain, x, y, y2, n_attrs):
    """Hold a kernel's top-k (metric [M, k], ids [M, k]) against its plain
    version on the same (normalized) operands. ``plain`` carries one column
    more than ``got`` wherever the train rows allow it: the (k+1)-th, for
    the near-tie rule. The tolerance of a row is 1e-5 relative to the scale
    of its terms, ``|x|² + |metric|``. Required:

    - the kernel's ids are distinct train rows, and the metric it reports
      for each is that row's metric recomputed here;
    - its metrics equal the plain version's, position by position;
    - every position where its id differs from the plain id is a near-tie
      of the plain list (within tolerance of the plain metric before or
      after it), and a row whose id set differs has its plain k-th and
      (k+1)-th metrics within tolerance;
    - the finalized scaled ints are within 1.

    Returns the counts of rows with other ids and with another id set, the
    max |metric| difference and the max |scaled int| difference."""
    from avenir_tpu_torch.ops.cuda_distance import finalize
    from avenir_tpu_torch.ops.distance import row_sq_norm
    kd, ki = got
    k = kd.shape[1]
    pd_all, pi_all = plain
    pd, pi = pd_all[:, :k], pi_all[:, :k]
    x2 = row_sq_norm(x)
    tol = 1e-5 * (x2.reshape(-1, 1) + pd_all.abs())
    if not torch.isfinite(kd).all():
        raise AssertionError(f"{label}: non-finite kernel metrics")
    if ((ki < 0) | (ki >= y.shape[0])).any():
        raise AssertionError(f"{label}: kernel ids outside the train rows")
    ids_sorted = ki.sort(dim=1).values
    if (ids_sorted[:, 1:] == ids_sorted[:, :-1]).any():
        raise AssertionError(f"{label}: a kernel id repeats within a row")
    rows = ki.long()
    recomputed = y2[rows] - 2.0 * (y[rows] * x.unsqueeze(1)).sum(-1)
    if not ((kd - recomputed).abs() <= tol[:, :k]).all():
        raise AssertionError(f"{label}: kernel metrics are not those of "
                             "its ids")
    if not ((kd - pd).abs() <= tol[:, :k]).all():
        raise AssertionError(f"{label}: metrics beyond 1e-5 relative")
    inf = torch.full_like(pd[:, :1], float("inf"))
    gap_prev = torch.cat([inf, pd[:, 1:] - pd[:, :-1]], dim=1)
    gap_next = (pd_all[:, 1:k + 1] - pd if pd_all.shape[1] > k else
                torch.cat([pd[:, 1:] - pd[:, :-1], inf], dim=1))
    tied = (gap_prev <= tol[:, :k]) | (gap_next <= tol[:, :k])
    differ = ki != pi
    if (differ & ~tied).any():
        raise AssertionError(
            f"{label}: {int((differ & ~tied).any(dim=1).sum())} rows with "
            "other ids where the plain metrics are no near-tie")
    set_differ = (ids_sorted != pi.sort(dim=1).values).any(dim=1)
    if set_differ.any():
        if pd_all.shape[1] == k:
            raise AssertionError(f"{label}: other id set with k = N")
        boundary = (pd_all[:, k] - pd_all[:, k - 1]) <= tol[:, k]
        if (set_differ & ~boundary).any():
            raise AssertionError(
                f"{label}: {int((set_differ & ~boundary).sum())} rows with "
                "another id set where the plain k-th and (k+1)-th metrics "
                "are no near-tie")
    ks, _ = finalize(kd, ki, x2, n_attrs, 1000)
    ps, _ = finalize(pd, pi, x2, n_attrs, 1000)
    err = int((ks - ps).abs().max())
    if err > 1:
        raise AssertionError(f"{label}: scaled ints differ by {err}")
    return {"rows": int(differ.any(dim=1).sum()),
            "sets": int(set_differ.sum()),
            "metric_err": float((kd - pd).abs().max()), "int_err": err}


def summary(c) -> str:
    return (f"{c['rows']} rows with other ids, all near-ties ({c['sets']} "
            f"with another id set), metric err {c['metric_err']:.3g}, "
            f"scaled-int err {c['int_err']}")


def plain_with_next(fn, x, y, y2, k, *scales):
    """A plain top-k with the (k+1)-th column where N allows it."""
    return fn(x, y, y2, *scales, min(k + 1, y.shape[0]))


def check_k5(label, got_k2, x, y, y2, k, plain):
    """K5 on the transposed operands: bit-identical to K2's result
    ``got_k2`` on the row-major ones, and through the top-k gate against
    the plain version ``plain`` (with the (k+1)-th column)."""
    from avenir_tpu_torch.ops import cuda_distance as D
    xt, yt = x.T.contiguous(), y.T.contiguous()
    got = D.topk_raw_tpose(xt, yt, y2, k)
    if not all(torch.equal(p, q) for p, q in zip(got, got_k2)):
        raise AssertionError(f"K5 {label}: not bit-identical to K2")
    return compare_topk(f"K5 {label}", got, plain, x, y, y2, x.shape[1])


def check_k2_parts(dev, x, y, y2, k):
    """K2's ablations at the bench shape: without the product,
    bit-identical to its plain version (the same f32 adds, the same
    lowest-id rule); without the selection, each row's minimum within 1e-5
    relative of the plain one. Times by the chained helper, bounds at the
    card's rates."""
    from avenir_tpu_torch.ops import cuda_distance as D
    from avenir_tpu_torch.scripts._timing import chain_ms
    from avenir_tpu_torch.scripts.roofline_knn import WORK
    m, d = x.shape
    n = y.shape[0]
    nodot = D.topk_nodot_raw(x, y2, k)
    if not all(torch.equal(a, b) for a, b in
               zip(nodot, D.topk_nodot_plain(x, y2, k))):
        raise AssertionError("K2 without its product differs from plain")
    sweep, plain = D.topk_sweep_min(x, y, y2), D.topk_sweep_plain(x, y, y2)
    tol = 1e-5 * (D.row_sq_norm(x) + plain.abs())
    if not ((sweep - plain).abs() <= tol).all():
        raise AssertionError("K2 without its selection: minima beyond 1e-5 "
                             "relative")
    results = {}
    # (wrapper call, plain call, bytes, error); the product's type and the
    # instructions a pair from roofline_knn.WORK
    parts = {
        "K2-nodot": (lambda: D.topk_nodot_raw(x, y2, k),
                     lambda: D.topk_nodot_plain(x, y2, k),
                     (m * d + n) * 4 + m * k * 8, 0.0),
        "K2-sweep": (lambda: D.topk_sweep_min(x, y, y2),
                     lambda: D.topk_sweep_plain(x, y, y2),
                     (m * d + n * d + n) * 4 + m * 4,
                     float((sweep - plain).abs().max())),
    }
    for name, (kernel, plain_fn, n_bytes, err) in parts.items():
        ms = chain_ms(kernel, dev)
        plain_ms = cuda_ms(plain_fn, 3)
        bound, by = pair_bound_ms(dev, m, n, d, n_bytes, *WORK[name])
        log(f"phase 2 {name} bench shape: max err {err:.3g}; kernel "
            f"{ms:.4f} ms device (chained), plain {plain_ms:.3f} ms, bound "
            f"{bound:.4f} ms ({by}), {bound / ms:.1%} of bound")
        results[name] = {
            "name": f"topk_{name[3:]} (ablation of K2)", "route": "cuda",
            "source": "avenir_tpu_torch/csrc/topk.cu",
            "replaces": "avenir_tpu/ops/pallas_distance.py:165",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}
    return results


def check_k2_k3(dev):
    from avenir_tpu_torch.ops import cuda_distance as D
    from avenir_tpu_torch.ops import cuda_fused as F
    from avenir_tpu_torch.scripts._timing import chain_ms
    gen = torch.Generator(device=dev).manual_seed(SEED)
    d, k = 9, 5
    results = {}

    def operands(m, n, width=d):
        x = torch.rand((m, width), generator=gen, device=dev)
        y = torch.rand((n, width), generator=gen, device=dev)
        return x, y, D.row_sq_norm(y)

    # bench shape: 8,192 test x 65,536 train
    m, n = 8192, 65536
    x, y, y2 = operands(m, n)
    got2 = D.topk_raw(x, y, y2, k)
    c2 = compare_topk("K2 bench", got2,
                      plain_with_next(D.topk_raw_plain, x, y, y2, k),
                      x, y, y2, d)
    per_call = cuda_ms(lambda: D.topk_raw(x, y, y2, k), 20)
    ms = chain_ms(lambda: D.topk_raw(x, y, y2, k), dev)
    plain_ms = cuda_ms(lambda: D.topk_raw_plain(x, y, y2, k), 3)

    def library():
        return torch.topk(torch.cdist(x, y), k, dim=1, largest=False)

    library_ms = cuda_ms(library, 5)
    flops = 2.0 * m * n * d
    bound, by = bound_ms((m * d + n * d + n) * 4 + m * k * 8, flops)
    log(f"phase 2 K2 bench shape m={m} n={n} d={d} k={k}: {summary(c2)}; "
        f"kernel {ms:.4f} ms device (chained), {per_call:.4f} ms per call "
        f"host included, plain {plain_ms:.3f} ms, cdist+topk "
        f"{library_ms:.3f} ms, bound {bound:.4f} ms ({by})")
    results["K2"] = {"name": "topk_staged (K2)", "route": "cuda",
                     "source": "avenir_tpu_torch/csrc/topk.cu",
                     "replaces": "avenir_tpu/ops/pallas_distance.py:165",
                     "max_abs_err": c2["metric_err"], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "library_ms": library_ms}

    results.update(check_k2_parts(dev, x, y, y2, k))

    # K5: the same function over feature-major operands
    xt, yt = x.T.contiguous(), y.T.contiguous()
    c5 = check_k5("bench", got2, x, y, y2, k,
                  plain_with_next(D.topk_raw_tpose_plain, xt, yt, y2, k))
    per_call5 = cuda_ms(lambda: D.topk_raw_tpose(xt, yt, y2, k), 20)
    ms5 = chain_ms(lambda: D.topk_raw_tpose(xt, yt, y2, k), dev)
    # K2 once more, so that K5 sits between two K2 timings
    ms2_after = chain_ms(lambda: D.topk_raw(x, y, y2, k), dev)
    plain5 = cuda_ms(lambda: D.topk_raw_tpose_plain(xt, yt, y2, k), 3)
    log(f"phase 2 K5 bench shape: bit-identical to K2; vs plain "
        f"{summary(c5)}; kernel {ms5:.4f} ms device (chained; K2 before and "
        f"after {ms:.4f}, {ms2_after:.4f} ms), {per_call5:.4f} ms per call "
        f"host included, plain {plain5:.3f} ms, cdist+topk "
        f"{library_ms:.3f} ms, bound {bound:.4f} ms ({by})")
    results["K5"] = {"name": "topk_tpose (K5)", "route": "cuda",
                     "source": "avenir_tpu_torch/csrc/topk.cu",
                     "replaces": "avenir_tpu/ops/pallas_distance.py:256",
                     "max_abs_err": c5["metric_err"], "ms": ms5,
                     "plain_ms": plain5, "bound_ms": bound, "bound_by": by,
                     "library_ms": library_ms}
    # K5's entry point, its launches counted from 0: the same distances
    # and ids as the lane layout
    D.topk_raw_tpose.launches = 0
    tpose = D.pairwise_topk_cuda(x, y, k=k, layout="tpose")
    results["K5_launches"] = D.topk_raw_tpose.launches
    if results["K5_launches"] < 1:
        raise AssertionError("pairwise_topk_cuda(layout='tpose') did not "
                             "launch K5")
    if not all(torch.equal(p, q) for p, q in
               zip(tpose, D.pairwise_topk_cuda(x, y, k=k))):
        raise AssertionError("layout='tpose' differs from layout='lane'")
    log(f"phase 2 K5 path pairwise_topk_cuda(layout='tpose') {m}x{n}x{d}: "
        f"{results['K5_launches']} launch(es), equal to layout='lane'")
    del xt, yt

    # K3 on raw rows against K2 on the normalized rows: bit-identical
    mins = torch.rand(d, generator=gen, device=dev) * 50.0
    span = torch.rand(d, generator=gen, device=dev) * 200.0 + 1.0
    raw = torch.round(x * span + mins)
    staged = F.normalize(raw, mins, span)
    fd, fi = F.fused_topk_raw(raw, y, y2, mins, span, k)
    sd, si = D.topk_raw(staged, y, y2, k)
    if not (torch.equal(fd, sd) and torch.equal(fi, si)):
        raise AssertionError("K3 on raw rows is not bit-identical to K2 on "
                             "normalized rows")
    c3 = compare_topk("K3 bench", (fd, fi),
                      plain_with_next(F.fused_topk_raw_plain, raw, y, y2, k,
                                      mins, span), staged, y, y2, d)
    per_call3 = cuda_ms(lambda: F.fused_topk_raw(raw, y, y2, mins, span, k),
                        20)
    ms3 = chain_ms(lambda: F.fused_topk_raw(raw, y, y2, mins, span, k), dev)
    plain3 = cuda_ms(lambda: F.fused_topk_raw_plain(raw, y, y2, mins, span,
                                                    k), 3)
    bound3, by3 = bound_ms((m * d + n * d + n + 2 * d) * 4 + m * k * 8,
                           flops + 2.0 * m * d)
    log(f"phase 2 K3 bench shape: bit-identical to K2 on normalized rows; "
        f"vs plain {summary(c3)}; kernel {ms3:.4f} ms device (chained), "
        f"{per_call3:.4f} ms per call host included, plain {plain3:.3f} ms, "
        f"bound {bound3:.4f} ms ({by3})")
    results["K3"] = {"name": "topk_fused (K3)", "route": "cuda",
                     "source": "avenir_tpu_torch/csrc/topk.cu",
                     "replaces": "avenir_tpu/ops/pallas_fused.py:52",
                     "max_abs_err": c3["metric_err"], "ms": ms3,
                     "plain_ms": plain3, "bound_ms": bound3, "bound_by": by3,
                     "library_ms": None}

    # deployment scale: 65,536 test x 1,048,576 train
    m, n = 65536, 1_048_576
    x, y, y2 = operands(m, n)
    got = D.topk_raw(x, y, y2, k)
    t0 = time.perf_counter()
    want = plain_with_next(D.topk_raw_plain, x, y, y2, k)
    torch.cuda.synchronize()
    plain_big = (time.perf_counter() - t0) * 1e3
    c = compare_topk("K2 big", got, want, x, y, y2, d)
    ms_big = chain_ms(lambda: D.topk_raw(x, y, y2, k), dev)
    bound_big, _ = bound_ms((m * d + n * d + n) * 4 + m * k * 8,
                            2.0 * m * n * d)
    log(f"phase 2 K2 scale m={m} n={n} d={d} k={k}: {summary(c)}; kernel "
        f"{ms_big:.2f} ms device (chained), plain (one call, host clock) "
        f"{plain_big:.0f} ms, bound {bound_big:.2f} ms (operations)")
    xt, yt = x.T.contiguous(), y.T.contiguous()
    t0 = time.perf_counter()
    want5 = plain_with_next(D.topk_raw_tpose_plain, xt, yt, y2, k)
    torch.cuda.synchronize()
    plain5_big = (time.perf_counter() - t0) * 1e3
    c5 = check_k5("scale", got, x, y, y2, k, want5)
    ms5_big = chain_ms(lambda: D.topk_raw_tpose(xt, yt, y2, k), dev)
    ms2_after = chain_ms(lambda: D.topk_raw(x, y, y2, k), dev)
    log(f"phase 2 K5 scale: bit-identical to K2; vs plain {summary(c5)}; "
        f"kernel {ms5_big:.2f} ms device (chained; K2 before and after "
        f"{ms_big:.2f}, {ms2_after:.2f} ms), plain (one call, host clock) "
        f"{plain5_big:.0f} ms, bound {bound_big:.2f} ms (operations)")
    del x, y, y2, got, want, xt, yt, want5

    # K5's scalar loads: M and N not multiples of 4, splits off the
    # 16-byte grid
    x, y, y2 = operands(2051, 16383)
    plain = plain_with_next(D.topk_raw_plain, x, y, y2, k)
    c5 = check_k5("ragged 2051x16383", D.topk_raw(x, y, y2, k), x, y, y2, k,
                  plain)
    log(f"phase 2 K5 m=2051 n=16383 d={d} k={k} (scalar loads): "
        f"bit-identical to K2; vs plain {summary(c5)}")

    # the edges of the supported range: k = 128, encoded width 512
    for m, n, width, kk in ((2048, 16384, d, 128), (1024, 8192, 512, 5),
                            (1024, 8192, 512, 128)):
        x, y, y2 = operands(m, n, width)
        got2 = D.topk_raw(x, y, y2, kk)
        plain = plain_with_next(D.topk_raw_plain, x, y, y2, kk)
        c = compare_topk(f"K2 k={kk} width={width}", got2, plain, x, y, y2,
                         width)
        check_k5(f"k={kk} width={width}", got2, x, y, y2, kk, plain)
        mins = torch.rand(width, generator=gen, device=dev)
        span = torch.rand(width, generator=gen, device=dev) + 0.5
        raw = x * span + mins
        fused = F.fused_topk_raw(raw, y, y2, mins, span, kk)
        staged = D.topk_raw(F.normalize(raw, mins, span), y, y2, kk)
        if not all(torch.equal(a, b) for a, b in zip(fused, staged)):
            raise AssertionError(f"K3 != K2 at k={kk} width={width}")
        log(f"phase 2 K2/K3/K5 m={m} n={n} width={width} k={kk}: "
            f"{summary(c)}; K3 and K5 bit-identical to K2")
    return results


def check_exact_ties(dev):
    """K2, K5 and K3 (mins 0, span 1) on integer features in [0, 4), D = 9:
    every metric is an integer that f32 holds exactly in any sum order, and
    train rows repeat, so a row's k-th and (k+1)-th metrics tie often. The
    kernels' metrics and ids must equal the plain version's position by
    position, with no near-tie allowance: the lowest id wins every tie. At
    8,192 × 65,536 K2 takes one test row a thread and 9 train splits
    through the merge, at 16,384 × 1,048,576 four rows a thread and 17."""
    from avenir_tpu_torch.ops import cuda_distance as D
    from avenir_tpu_torch.ops import cuda_fused as F
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    d, k = 9, 5
    mins = torch.zeros(d, device=dev)
    span = torch.ones(d, device=dev)
    for m, n in ((8192, 65536), (16384, 1_048_576)):
        x = torch.randint(0, 4, (m, d), generator=gen, device=dev).float()
        y = torch.randint(0, 4, (n, d), generator=gen, device=dev).float()
        y2 = D.row_sq_norm(y)
        plain_d, plain_i = D.topk_raw_plain(x, y, y2, k + 1)
        want = (plain_d[:, :k], plain_i[:, :k])
        got = {"K2": D.topk_raw(x, y, y2, k),
               "K5": D.topk_raw_tpose(x.T.contiguous(), y.T.contiguous(),
                                      y2, k),
               "K3": F.fused_topk_raw(x, y, y2, mins, span, k)}
        for name, out in got.items():
            if not (torch.equal(out[0], want[0])
                    and torch.equal(out[1], want[1])):
                rows = int(((out[0] != want[0]) | (out[1] != want[1]))
                           .any(dim=1).sum())
                raise AssertionError(f"exact ties {m}x{n}: {name} differs "
                                     f"from plain in {rows} rows")
        boundary = float((plain_d[:, k] == plain_d[:, k - 1])
                         .float().mean())
        inside = float((want[0][:, 1:] == want[0][:, :-1]).any(dim=1)
                       .float().mean())
        log(f"phase 2 exact ties m={m} n={n} d={d} k={k} (integer features "
            f"in [0, 4)): K2, K5, K3 metrics and ids equal to plain, position "
            f"by position; rows with a tie inside the top-{k} {inside:.1%}, "
            f"at the k-th/(k+1)-th boundary {boundary:.1%}")
        del x, y, y2, plain_d, plain_i, want, got


# the fold kernels K6-K9: (label, m, n, k, K6 (n_acc, tile_n, bf16) list,
# K8/K9 (n_acc, tile_n) list); the first is the bench shape, timed
FOLD_SHAPES = (
    ("bench", 8192, 65536, 5,
     [(a, t, r) for a, t in ((2, 4096), (4, 4096), (4, 6144), (8, 4096),
                             (4, 8192)) for r in (True, False)],
     [(4, 4096)]),
    ("ragged N<B", 1000, 300, 5, [(4, 4096, True), (8, 4096, False)],
     [(8, 4096)]),
    ("ragged", 2051, 16383, 5, [(4, 6144, True), (2, 4096, False)],
     [(2, 4096)]),
    ("k=128", 2048, 16384, 128, [(4, 4096, True), (8, 4096, False)],
     [(8, 4096)]),
)
FOLD_SOURCE = "avenir_tpu_torch/csrc/fold.cu"
FOLD_REPLACES = {"K6": "scripts/exp_fold.py:24",
                 "K7": "scripts/roofline_knn.py:75",
                 "K8": "scripts/roofline_knn.py:98",
                 "K9": "scripts/roofline_knn.py:142"}
FOLD_NAMES = {"K6": "fold_acc (K6)", "K7": "fold_dotmin (K7)",
              "K8": "fold_nodot (K8)", "K9": "fold_tpose (K9)"}


def compare_fold(label, got, plain, metric_of, scale):
    """Hold a fold kernel's raw output (metric [M, 128], columns [M, 128],
    or lane minima [M, 128] with ``got[1]`` None) against its plain
    version on the same operands. The tolerance of a row is 1e-5 relative
    to the scale of its terms, ``scale + |metric|``. Required:

    - empty slots, (BIG, -1), exactly where the plain version has them
      (K7: lanes at BIG);
    - the metrics equal the plain version's within tolerance, slot by slot;
    - the kernel's columns are distinct within a row, and the metric it
      reports for each is that column's metric recomputed here
      (``metric_of``), so that a column other than the plain one carries a
      metric within twice the tolerance of the plain one: a near-tie.

    Returns the count of slots with another column and the max |metric|
    difference."""
    from avenir_tpu_torch.ops.fold import BIG
    kd, ki = got
    pd, pi = plain
    empty = pd == BIG if pi is None else pi < 0
    if not torch.equal(kd == BIG if ki is None else ki < 0, empty):
        raise AssertionError(f"{label}: empty slots differ from plain")
    if not (kd[empty] == BIG).all():
        raise AssertionError(f"{label}: an empty slot is not BIG")
    real = ~empty
    tol = 1e-5 * (scale.reshape(-1, 1) + pd.abs())
    if not torch.isfinite(kd[real]).all():
        raise AssertionError(f"{label}: non-finite kernel metrics")
    if ((kd - pd).abs() > tol)[real].any():
        raise AssertionError(f"{label}: metrics beyond 1e-5 relative")
    err = float((kd - pd).abs()[real].max()) if real.any() else 0.0
    if ki is None:
        return {"differ": 0, "err": err}
    slots = torch.arange(ki.shape[1], device=ki.device)
    ids = torch.where(real, ki.long(), -1 - slots).sort(dim=1).values
    if (ids[:, 1:] == ids[:, :-1]).any():
        raise AssertionError(f"{label}: a column repeats within a row")
    recomputed = metric_of(ki.clamp(min=0))
    if ((kd - recomputed).abs() > tol)[real].any():
        raise AssertionError(f"{label}: kernel metrics are not those of "
                             "its columns")
    return {"differ": int(((ki != pi) & real).sum()), "err": err}


def fold_metrics(x, y, y2, use_bf16):
    """(metric of given columns, row scale) of the product fold."""
    from avenir_tpu_torch.ops.distance import row_sq_norm
    from avenir_tpu_torch.ops.fold import round_bf16
    xr, yr = (round_bf16(x), round_bf16(y)) if use_bf16 else (x, y)

    def metric(ids):
        rows = ids.long()
        return y2[rows] - 2.0 * (yr[rows] * xr.unsqueeze(1)).sum(-1)
    return metric, row_sq_norm(xr)


def hold_nodot(label, got, plain):
    """K8 against its plain version: equal bit for bit, values and
    columns (one f32 add of the same two values a pair, the columns in the
    same order)."""
    if not (torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])):
        raise AssertionError(
            f"K8 {label}: differs from plain in "
            f"{int((got[0] != plain[0]).sum())} metrics and "
            f"{int((got[1] != plain[1]).sum())} columns")


def check_fold(dev):
    """K6-K9 against their plain versions at FOLD_SHAPES; times at the
    bench shape. Returns the kernels line's entries (launches from
    phase 4)."""
    from avenir_tpu_torch.ops import cuda_fold as CF
    from avenir_tpu_torch.ops import fold as F
    from avenir_tpu_torch.ops.distance import row_sq_norm
    from avenir_tpu_torch.scripts._timing import chain_ms
    from avenir_tpu_torch.scripts.roofline_knn import WORK
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    err = {name: 0.0 for name in FOLD_NAMES}
    entries = {}
    for label, m, n, k, accs, folds in FOLD_SHAPES:
        d = 9
        x = torch.rand((m, d), generator=gen, device=dev)
        y = torch.rand((n, d), generator=gen, device=dev)
        y2 = row_sq_norm(y)
        xt, yt = x.T.contiguous(), y.T.contiguous()
        notes, plains = [], {}

        def hold(name, what, got, plain, metric, scale):
            c = compare_fold(f"{name} {label} {what}", got, plain, metric,
                             scale)
            err[name] = max(err[name], c["err"])
            notes.append(f"{name} {what}: {c['differ']} other columns")

        for n_acc, tile_n, bf16 in accs:
            if (n_acc, bf16) not in plains:   # tile_n changes nothing
                plains[n_acc, bf16] = F.acc_fold_plain(
                    x, y, y2, k=k, n_acc=n_acc, tile_n=tile_n,
                    use_bf16=bf16)
            hold("K6", f"n_acc={n_acc} tile_n={tile_n} bf16={bf16}",
                 CF.acc_fold(x, y, y2, k=k, n_acc=n_acc, tile_n=tile_n,
                             use_bf16=bf16),
                 plains[n_acc, bf16], *fold_metrics(x, y, y2, bf16))
            if bf16:     # K9 is K6 with bf16 on over feature-major operands
                hold("K9", f"n_acc={n_acc} tile_n={tile_n}",
                     CF.tpose_fold(xt, yt, y2, k=k, n_acc=n_acc,
                                   tile_n=tile_n),
                     plains[n_acc, bf16], *fold_metrics(x, y, y2, bf16))
        metric, scale = fold_metrics(x, y, y2, True)
        hold("K7", "lanes", (CF.dotmin(x, y, y2), None),
             (F.dotmin_plain(x, y, y2), None), metric, scale)
        for n_acc, tile_n in folds:
            kw = dict(k=k, n_acc=n_acc, tile_n=tile_n)
            hold_nodot(f"{label} n_acc={n_acc}", CF.nodot_fold(x, y2, **kw),
                       F.nodot_fold_plain(x, y2, **kw))
            notes.append(f"K8 n_acc={n_acc}: equal")
            hold("K9", f"n_acc={n_acc}", CF.tpose_fold(xt, yt, y2, **kw),
                 F.tpose_fold_plain(xt, yt, y2, **kw), metric, scale)
        log(f"phase 2 K6-K9 {label} m={m} n={n} d={d} k={k}: "
            + "; ".join(notes))
        if label != "bench":
            continue
        n_acc, tile_n = folds[0]
        kw = dict(k=k, n_acc=n_acc, tile_n=tile_n)
        calls = {
            "K6": (lambda: CF.acc_fold(x, y, y2, **kw),
                   lambda: F.acc_fold_plain(x, y, y2, **kw)),
            "K7": (lambda: CF.dotmin(x, y, y2),
                   lambda: F.dotmin_plain(x, y, y2)),
            "K8": (lambda: CF.nodot_fold(x, y2, **kw),
                   lambda: F.nodot_fold_plain(x, y2, **kw)),
            "K9": (lambda: CF.tpose_fold(xt, yt, y2, **kw),
                   lambda: F.tpose_fold_plain(xt, yt, y2, **kw)),
        }
        inputs = (m * d + n * d + n) * 4
        # bytes (K8 reads no y; K7 writes values only), then the product's
        # type and the instructions a pair from roofline_knn.WORK
        work = {"K6": inputs + m * 128 * 8, "K7": inputs + m * 128 * 4,
                "K8": (m * d + n) * 4 + m * 128 * 8,
                "K9": inputs + m * 128 * 8}
        # the former body of K6-K9, on the CUDA cores (K6 keeps it for bf16
        # off), timed in this run as the kernels line's parent_ms
        kept = {"K6": lambda: CF._launch_acc(x, y, y2, k, n_acc, True,
                                             "cuda_cores", dev),
                "K7": lambda: CF._launch_dotmin(x, y, y2, "cuda_cores", dev),
                "K8": lambda: CF._launch_nodot(x, y2, k, n_acc, "cuda_cores",
                                               dev),
                "K9": lambda: CF._launch_tpose(xt, yt, y2, k, n_acc,
                                               "cuda_cores", dev)}
        for name, (kernel, plain) in calls.items():
            ms = chain_ms(kernel, dev)
            plain_ms = cuda_ms(plain, 3)
            bound, by = pair_bound_ms(dev, m, n, d, work[name], *WORK[name])
            parent_ms = chain_ms(kept[name], dev)
            parent = f", CUDA-core body {parent_ms:.4f} ms"
            log(f"phase 2 {name} bench shape (n_acc={n_acc}, tile_n="
                f"{tile_n}): kernel {ms:.4f} ms device (chained), plain "
                f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by}), "
                f"{bound / ms:.1%} of bound{parent}")
            entries[name] = {
                "name": FOLD_NAMES[name], "route": "cuda",
                "source": FOLD_SOURCE, "replaces": FOLD_REPLACES[name],
                "ms": ms, "parent_ms": parent_ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None}
        compare_bodies(dev, x, y, y2, k)
        del x, y, y2, xt, yt, plains
    for name, entry in entries.items():
        entry["max_abs_err"] = err[name]
    return entries


def compare_bodies(dev, x, y, y2, k):
    """Chained device time of the CUDA-core body against the new one, in
    turns (CUDA cores, new, new, CUDA cores), bf16 on: K6 at each n_acc of
    exp_fold's configurations and at n_acc 1, K7, K8 (the tile with an add
    for the product) at n_acc 4, and K9 at n_acc 4 and 8 (sweep 18's
    ``tpose_tag`` and ``tpose_tag8``). The tensor-core body's packed rows
    must equal ``tc_packed(tc_operands(...))`` bit for bit, and K9's,
    packed from the feature-major ``y.T``, K6's of y."""
    from avenir_tpu_torch.ops import cuda_fold as CF
    from avenir_tpu_torch.scripts._timing import chain_ms
    from avenir_tpu_torch.scripts.exp_fold import CONFIGS
    xt, yt = x.T.contiguous(), y.T.contiguous()
    arms = {f"K6 n_acc={a}": (
        "tensor", lambda b, a=a: CF._launch_acc(x, y, y2, k, a, True, b, dev))
        for a in sorted({1} | {a for a, _ in CONFIGS})}
    arms["K7"] = ("tensor", lambda b: CF._launch_dotmin(x, y, y2, b, dev))
    arms["K8 n_acc=4"] = (
        "tile", lambda b: CF._launch_nodot(x, y2, k, 4, b, dev))
    for a in (4, 8):
        arms[f"K9 n_acc={a}"] = (
            "tensor",
            lambda b, a=a: CF._launch_tpose(xt, yt, y2, k, a, b, dev))
    for arm, (new, launch) in arms.items():
        got = collections.defaultdict(list)
        for body in ("cuda_cores", new, new, "cuda_cores"):
            got[body].append(chain_ms(lambda: launch(body), dev))
        log(f"phase 2 bodies {arm} (bench shape, bf16 on): CUDA cores "
            + ", ".join(f"{t:.4f}" for t in got["cuda_cores"])
            + f" ms; {'tensor cores' if new == 'tensor' else new} "
            + ", ".join(f"{t:.4f}" for t in got[new]) + " ms")
    yp = CF._launch_acc(x, y, y2, k, 4, True, "tensor", dev)[2][0]
    want = CF.tc_packed(CF.tc_operands(x, y, y2, 512)[1])
    if not torch.equal(yp.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("K6 packed rows differ from "
                             "tc_packed(tc_operands(...))")
    yp9 = CF._launch_tpose(xt, yt, y2, k, 4, "tensor", dev)[2][0]
    if not torch.equal(yp9.view(torch.int16), yp.view(torch.int16)):
        raise AssertionError("K9 packed rows of y.T differ from K6's of y")
    log("phase 2 packed rows: K6's equal tc_packed(tc_operands(...)), K9's "
        "(from y.T) equal K6's (from y), bit for bit")


# the tensor-core body (K6 bf16 on, K7, K9) and K8 on its tile at their
# edges: (label, m, n, d, k); every indexed case at n_acc 1 and 8. d 13/14,
# 29/30, 45/46 are the k-step boundaries of d + 3 (the y2 parts ride in the
# padding), 16/17 those of d alone; m is no multiple of 128 rows; n = 50 is
# below one slice of 64 buckets
TC_EDGE_SHAPES = tuple(
    (f"d={d}", 1000, 5000, d, 5) for d in (1, 13, 14, 16, 17, 29, 30, 46, 48)
) + (("N<slice", 300, 50, 9, 5), ("k=128", 2048, 16384, 9, 128))


def check_tc_edges(dev):
    """TC_EDGE_SHAPES through the wrappers, K6, K7 and K9 held by
    ``compare_fold``, K8 bit for bit; then the exact-tie hold: integer
    features in [0, 4), where bf16 products and f32 sums are exact, so
    K6's and K9's (metric, column), K7's lanes and K8's pairs must equal
    the plain version's position by position at every n_acc. Returns the
    largest error of K6, K7 and K9."""
    from avenir_tpu_torch.ops import cuda_fold as CF
    from avenir_tpu_torch.ops import fold as F
    from avenir_tpu_torch.ops.distance import row_sq_norm
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    err = collections.defaultdict(float)
    for label, m, n, d, k in TC_EDGE_SHAPES:
        x = torch.rand((m, d), generator=gen, device=dev)
        y = torch.rand((n, d), generator=gen, device=dev)
        y2 = row_sq_norm(y)
        xt, yt = x.T.contiguous(), y.T.contiguous()
        metric, scale = fold_metrics(x, y, y2, True)
        notes = []
        for n_acc in (1, 8):
            for name, got, plain in (
                    ("K6", CF.acc_fold(x, y, y2, k=k, n_acc=n_acc),
                     F.acc_fold_plain(x, y, y2, k=k, n_acc=n_acc)),
                    ("K9", CF.tpose_fold(xt, yt, y2, k=k, n_acc=n_acc),
                     F.tpose_fold_plain(xt, yt, y2, k=k, n_acc=n_acc))):
                c = compare_fold(f"{name} {label} n_acc={n_acc}", got, plain,
                                 metric, scale)
                err[name] = max(err[name], c["err"])
                notes.append(f"{name} n_acc={n_acc} {c['differ']} other "
                             "columns")
            hold_nodot(f"{label} n_acc={n_acc}",
                       CF.nodot_fold(x, y2, k=k, n_acc=n_acc),
                       F.nodot_fold_plain(x, y2, k=k, n_acc=n_acc))
        c = compare_fold(f"K7 {label}", (CF.dotmin(x, y, y2), None),
                         (F.dotmin_plain(x, y, y2), None), metric, scale)
        err["K7"] = max(err["K7"], c["err"])
        log(f"phase 2 tensor-core edges {label} m={m} n={n} d={d} k={k}: "
            + "; ".join(notes) + "; K7 lanes within 1e-5; K8 at n_acc 1 "
            "and 8 equal to plain")
        del x, y, y2, xt, yt
    m, n, d, k = 2051, 65536, 9, 5
    x = torch.randint(0, 4, (m, d), generator=gen, device=dev).float()
    y = torch.randint(0, 4, (n, d), generator=gen, device=dev).float()
    y2 = row_sq_norm(y)
    xt, yt = x.T.contiguous(), y.T.contiguous()
    for n_acc in (1, 2, 4, 8):
        want = F.acc_fold_plain(x, y, y2, k=k, n_acc=n_acc)
        for name, got in (("K6", CF.acc_fold(x, y, y2, k=k, n_acc=n_acc)),
                          ("K9", CF.tpose_fold(xt, yt, y2, k=k,
                                               n_acc=n_acc))):
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"exact ties: {name} n_acc={n_acc} "
                                     "differs from plain")
        hold_nodot(f"exact ties n_acc={n_acc}",
                   CF.nodot_fold(x, y2, k=k, n_acc=n_acc),
                   F.nodot_fold_plain(x, y2, k=k, n_acc=n_acc))
    if not torch.equal(CF.dotmin(x, y, y2), F.dotmin_plain(x, y, y2)):
        raise AssertionError("exact ties: K7 differs from plain")
    log(f"phase 2 tensor-core exact ties m={m} n={n} d={d} k={k} (integer "
        "features in [0, 4)): K6, K9 and K8 at n_acc 1, 2, 4, 8 and K7 "
        "equal to plain, position by position")
    return dict(err)


def mma_counts(lib_path):
    """Tensor-core instructions of each tensor-core sweep kernel in the
    built library (``cuobjdump -sass``), by demangled name: (opcode,
    count), HMMA for the bf16 sweeps of K6 and K7 (``tc_sweep_kernel``),
    IMMA for the int8 sweeps of K11 and K12 (``tc_int8_sweep_kernel``)."""
    from avenir_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            counts[name] = collections.Counter()
        elif name:
            found = re.search(r"\b([HI]MMA)\b", line)
            if found:
                counts[name][found.group(1)] += 1
    names = list(counts)
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    from avenir_tpu_torch.scripts.roofline_knn import kernel_name
    out = {}
    for pretty, raw in zip(names, counts):
        op = ("IMMA" if "tc_int8_sweep_kernel" in raw else
              "HMMA" if "tc_sweep_kernel" in raw else None)
        if op:
            out[kernel_name(pretty)] = (op, counts[raw][op])
    return out


# the kernel-restructure sweeps' folds: (label, m, n) of the shapes K10-K12
# are held at; the first is the sweeps' own, timed
SWEEP_SHAPES = (("bench", 8192, 65536), ("ragged", 2051, 16383),
                ("ragged N<B", 1000, 300))
SWEEP_REPLACES = {"K10": "scripts/sweep16b_kernels.py:77",
                  "K11": "scripts/sweep16_kernels.py:71",
                  "K12": "scripts/sweep16b_kernels.py:114"}
SWEEP_NAMES = {"K10": "fold_raw (K10)", "K11": "fold_int8 (K11)",
               "K12": "fold_packed (K12)"}
SWEEP_SOURCES = {"K10": FOLD_SOURCE,
                 "K11": "avenir_tpu_torch/csrc/fold_int8.cu",
                 "K12": "avenir_tpu_torch/csrc/fold_int8.cu"}
# the configuration whose time stands for the kernel in the kernels line
SWEEP_ENTRY = {"K10": "augv2", "K11": "int8rr", "K12": "int8pk"}


def sweep_configs(x, y):
    """Every fold launch of the sweeps on operands their encoders make from
    x and y: label → (kernel, wrapper call, plain call, how to hold it,
    (width, bytes, product, instructions a pair) for the bound, the
    CUDA-core body's call where the kernel has left it: K10 on f32
    operands cast once here, K11 and K12). ``hold`` is "exact" or (metric
    of given columns, row scale) for the fold gate; the CUDA-core body is
    held exactly (K10's sums in feature order, as its plain version)."""
    from avenir_tpu_torch.ops import cuda_fold as CF
    from avenir_tpu_torch.ops import fold as F
    from avenir_tpu_torch.ops.distance import row_sq_norm
    from avenir_tpu_torch.scripts import _sweep as S
    m, d = x.shape
    n = y.shape[0]
    out_bytes = m * 128 * 8
    configs = {}

    def raw(label, xa, ya, tpose=False):
        xf, yf = xa.float(), ya.float()
        xr, yr = F.round_bf16(xf), F.round_bf16(yf)
        if tpose:
            xr, yr = xr.T.contiguous(), yr.T.contiguous()
        w = xr.shape[1]

        def metric(ids):
            return (yr[ids.long()] * xr.unsqueeze(1)).sum(-1)
        kw = dict(k=S.K, n_acc=S.N_ACC, tile_n=S.TILE_N, tpose=tpose)
        configs[label] = (
            "K10", lambda: CF.raw_fold(xa, ya, **kw),
            lambda: F.raw_fold_plain(xf, yf, **kw),
            (metric, row_sq_norm(xr)),
            (w, (m + n) * w * xa.element_size() + out_bytes, "bf16", 3),
            lambda: CF._launch_raw(xf, yf, S.K, S.N_ACC, tpose,
                                   "cuda_cores", x.device))

    def int8(label, xa, ya, k, y2=None, packed=False, n_acc=S.N_ACC):
        w = xa.shape[1]
        kw = dict(k=k, n_acc=n_acc, tile_n=max(S.TILE_N, n_acc * 128))
        n_bytes = (m + n) * w + (0 if y2 is None else n * 4) + out_bytes
        if packed:
            bound = F.packed_metric_bound(xa, ya)
            configs[label] = (
                "K12", lambda: CF.packed_fold(xa, ya, metric_bound=bound,
                                              **kw),
                lambda: F.packed_fold_plain(xa, ya, metric_bound=bound, **kw),
                "exact", (w, n_bytes, "int8", 2),
                lambda: CF._launch_packed(xa, ya, k, n_acc, "cuda_cores",
                                          x.device))
        else:
            configs[label] = (
                "K11", lambda: CF.int8_fold(xa, ya, y2, **kw),
                lambda: F.int8_fold_plain(xa, ya, y2, **kw), "exact",
                (w, n_bytes, "int8", 3 if y2 is None else 4),
                lambda: CF._launch_int8(xa, ya, y2, k, n_acc, "cuda_cores",
                                        x.device))

    ones = torch.ones((m, 1), device=x.device)
    y2 = row_sq_norm(y)
    raw("augbf16", torch.cat([x, ones], 1).to(torch.bfloat16),
        torch.cat([-2.0 * y, y2.reshape(-1, 1)], 1).to(torch.bfloat16))
    xa, ya = S.aug_operands(x, y)
    raw("augv2", xa.to(torch.bfloat16), ya.to(torch.bfloat16))
    raw("tpose_aug", xa.T.contiguous(), ya.T.contiguous(), tpose=True)
    x8, y8, _ = S.quant(x, y, 127.0)
    int8("int8epi", x8, y8, S.K, y2=S._int8_sq_norm(y8))
    xa8, ya8, _ = S.int8_aug_operands(x, y)
    int8("int8aug", xa8, ya8, S.K)
    int8("int8rr", xa8, ya8, S.K_CAND)
    int8("int8pk", xa8, ya8, S.K_CAND, packed=True)
    xc8, yc8, _ = S.int8_centered_operands(x, y)
    int8("int8pk8", xc8, yc8, 8, packed=True, n_acc=8)
    int8("int8pk16", xc8, yc8, 16, packed=True, n_acc=16)

    # the sweeps' uses of K6 and K9
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    xt, yt = x.T.contiguous(), y.T.contiguous()
    hold = fold_metrics(x, y, y2, True)
    inputs = (m * d + n * d + n) * 4
    work = (d, inputs + out_bytes, "bf16", 4)
    kw = dict(k=S.K, n_acc=S.N_ACC, tile_n=S.TILE_N)
    configs["tagfold"] = (
        "K6", lambda: CF.acc_fold(xb, yb, y2, **kw),
        lambda: F.acc_fold_plain(x, y, y2, **kw), hold,
        (d, inputs - (m + n) * d * 2 + out_bytes, "bf16", 4), None)
    from avenir_tpu_torch.scripts.sweep11_vmem import CONFIGS
    for tile_n in sorted({tn for _, tn in CONFIGS}):
        configs[f"vmem tile_n={tile_n}"] = (
            "K6", lambda tile_n=tile_n: CF.acc_fold(
                x, y, y2, k=S.K, n_acc=4, tile_n=tile_n),
            lambda: F.acc_fold_plain(x, y, y2, **kw), hold, work, None)
    for label, n_acc in (("tpose_tag", S.N_ACC), ("tpose_tag8", 8)):
        kw9 = dict(k=S.K, n_acc=n_acc, tile_n=S.TILE_N)
        configs[label] = (
            "K9", lambda kw9=kw9: CF.tpose_fold(xt, yt, y2, **kw9),
            lambda kw9=kw9: F.tpose_fold_plain(xt, yt, y2, **kw9), hold, work,
            None)
    return configs


def check_sweep_folds(dev):
    """K10-K12, and the sweeps' uses of K6 and K9, against their plain
    versions at SWEEP_SHAPES; times at the sweeps' shape, K10's, K11's and
    K12's beside their CUDA-core body's. Returns the kernels line's entries
    of K10-K12 (launches from phase 5)."""
    from avenir_tpu_torch.scripts._timing import chain_ms
    from avenir_tpu_torch.scripts.roofline_knn import kernel_split
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    err = {name: 0.0 for name in SWEEP_NAMES}
    entries = {}
    for label, m, n in SWEEP_SHAPES:
        x = torch.rand((m, 9), generator=gen, device=dev)
        y = torch.rand((n, 9), generator=gen, device=dev)
        notes = []
        for config, (name, kernel, plain, hold, work, kept) in \
                sweep_configs(x, y).items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if hold == "exact":
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(
                        f"{name} {config} {label}: differs from plain in "
                        f"{int((got[0] != want[0]).sum())} metrics and "
                        f"{int((got[1] != want[1]).sum())} columns")
                notes.append(f"{config} ({name}) exact")
            else:
                c = compare_fold(f"{name} {config} {label}", got, want, *hold)
                if name in err:
                    err[name] = max(err[name], c["err"])
                notes.append(f"{config} ({name}) {c['differ']} other "
                             f"columns, err {c['err']:.3g}")
            if label != "bench":
                continue
            ms = chain_ms(kernel, dev)
            plain_ms = cuda_ms(plain, 3)
            width, n_bytes, product, ops = work
            bound, by = pair_bound_ms(dev, m, n, width, n_bytes, product, ops)
            parent_ms = None
            if kept:
                if not all(torch.equal(a, b) for a, b in zip(kept(), want)):
                    raise AssertionError(f"{name} {config}: the CUDA-core "
                                         "body differs from plain")
                parent_ms = chain_ms(kept, dev)
            log(f"phase 2 {name} {config} {m}x{n}, width {width}: kernel "
                f"{ms:.4f} ms device (chained), plain {plain_ms:.3f} ms, "
                f"bound {bound:.4f} ms ({by}, {ops} instructions a pair), "
                f"{bound / ms:.1%} of bound" + (
                    f", CUDA-core body {parent_ms:.4f} ms" if kept else ""))
            if SWEEP_ENTRY.get(name) == config:
                entries[name] = {
                    "name": SWEEP_NAMES[name], "route": "cuda",
                    "source": SWEEP_SOURCES[name],
                    "replaces": SWEEP_REPLACES[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                    "library_ms": None}
                if kept:
                    entries[name]["parent_ms"] = parent_ms
                    log(f"phase 2 {name} {config} split (torch.profiler, "
                        "us a call): " + "; ".join(
                            f"{k} {us:.1f}" for k, us in kernel_split(kernel)))
        log(f"phase 2 sweep folds {label} m={m} n={n}: " + "; ".join(notes))
    for name, entry in entries.items():
        entry["max_abs_err"] = err[name]
    return entries


# K10 at the edges of the tensor-core body's raw mode: widths across each
# k-step edge of W + 3 (13/14, 29/30, 45/46) and the sweeps' 10 and 11, at
# every n_acc, row-major and feature-major, on 1,000 test rows (no multiple
# of a block's 128) and 5,000 train rows of signed operands; then (W,
# n_acc, N) with N below B and one past a whole round of steps (three at
# one k-step, two at more) on positive operands, where a pad column that
# won would show; k = 128; exact ties
RAW_EDGE_WIDTHS = (1, 10, 11, 13, 14, 29, 30, 45, 46, 48)
RAW_PAD_CASES = ((11, 1, 50), (11, 4, 300), (11, 4, 1537), (11, 8, 3073),
                 (14, 2, 513), (14, 8, 1000), (48, 1, 257))


def check_raw_edges(dev):
    """K10 through its wrapper at the edges above, held by
    ``compare_fold`` (the row scale Σ_c |bf16(x_c)| · max |bf16(y)|, which
    bounds every term of a metric); then the exact-tie hold: augmented
    integer operands ([x | 1] against [-2y | |y|²], x and y in [0, 4), the
    train rows drawn from an eighth as many), whose products and sums are
    exact in any order, equal to the plain version position by position,
    columns included, at every n_acc and in both layouts; and the packed
    rows of both layouts equal ``tc_packed(tc_operands(x, y, None, ...))``
    bit for bit. Returns K10's largest error."""
    from avenir_tpu_torch.ops import cuda_fold as CF
    from avenir_tpu_torch.ops import fold as F
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    err, held, other = 0.0, 0, 0

    def hold(what, x, y, n_acc, k=5):
        nonlocal err, held, other
        xr, yr = F.round_bf16(x), F.round_bf16(y)
        scale = xr.abs().sum(1) * yr.abs().max()

        def metric(ids):
            return (yr[ids.long()] * xr.unsqueeze(1)).sum(-1)
        kw = dict(k=k, n_acc=n_acc, tile_n=max(4096, n_acc * 128))
        want = F.raw_fold_plain(x, y, **kw)
        for layout, got in (
                ("rows", CF.raw_fold(x, y, **kw)),
                ("tpose", CF.raw_fold(x.T.contiguous(), y.T.contiguous(),
                                      tpose=True, **kw))):
            c = compare_fold(f"K10 {what} n_acc={n_acc} {layout}", got,
                             want, metric, scale)
            err = max(err, c["err"])
            other += c["differ"]
            held += 1

    m, n = 1000, 5000
    for w in RAW_EDGE_WIDTHS:
        x = torch.rand((m, w), generator=gen, device=dev) * 2 - 1
        y = torch.rand((n, w), generator=gen, device=dev) * 2 - 1
        for n_acc in F.N_ACC_CHOICES:
            hold(f"W={w}", x, y, n_acc)
    for w, n_acc, n_pad in RAW_PAD_CASES:
        x = torch.rand((m, w), generator=gen, device=dev)
        y = torch.rand((n_pad, w), generator=gen, device=dev)
        hold(f"W={w} N={n_pad}", x, y, n_acc)
    x = torch.rand((2048, 11), generator=gen, device=dev) * 2 - 1
    y = torch.rand((16384, 11), generator=gen, device=dev) * 2 - 1
    hold("k=128", x, y, 2, k=128)
    m, n, d = 2051, 65536, 9
    x = torch.randint(0, 4, (m, d), generator=gen, device=dev).float()
    rows = torch.randint(0, 4, (n // 8, d), generator=gen, device=dev).float()
    y = rows[torch.randint(0, n // 8, (n,), generator=gen, device=dev)]
    xa = torch.cat([x, torch.ones((m, 1), device=dev)], 1)
    ya = torch.cat([-2.0 * y, (y * y).sum(1, keepdim=True)], 1)
    for n_acc in F.N_ACC_CHOICES:
        kw = dict(k=5, n_acc=n_acc)
        want = F.raw_fold_plain(xa, ya, **kw)
        for layout, got in (
                ("rows", CF.raw_fold(xa, ya, **kw)),
                ("tpose", CF.raw_fold(xa.T.contiguous(), ya.T.contiguous(),
                                      tpose=True, **kw))):
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"K10 exact ties n_acc={n_acc} {layout}"
                                     ": differs from plain")
    x = torch.rand((2051, 11), generator=gen, device=dev)
    y = torch.rand((16383, 11), generator=gen, device=dev)
    yp = CF._launch_raw(x, y, 5, 4, False, "tensor", dev)[2][0]
    yt = CF._launch_raw(x.T.contiguous(), y.T.contiguous(), 5, 4, True,
                        "tensor", dev)[2][0]
    want = CF.tc_packed(CF.tc_operands(x, y, None, 512)[1]).view(torch.int16)
    if not (torch.equal(yp.view(torch.int16), want)
            and torch.equal(yt.view(torch.int16), want)):
        raise AssertionError("K10 packed rows differ from "
                             "tc_packed(tc_operands(x, y, None, ...))")
    log(f"phase 2 K10 tensor-core edges: {held} calls within 1e-5 of plain, "
        f"{other} other columns (near-ties), err {err:.3g} (W "
        f"{', '.join(map(str, RAW_EDGE_WIDTHS))} at every n_acc, rows and "
        "tpose; (W, n_acc, N) " + ", ".join(
            f"({w}, {a}, {b})" for w, a, b in RAW_PAD_CASES)
        + "; k=128 at 2048 x 16384); exact ties 2051 x 65536 (integer "
        "operands, duplicated rows) at n_acc 1, 2, 4, 8, rows and tpose: "
        "equal to plain, position by position; packed rows of both layouts "
        "equal tc_packed(tc_operands(x, y, None, ...)) bit for bit")
    return err


# K11 and K12 at the edges of the int8 tensor-core body: every width edge
# of one k-step of 32 bytes at every n_acc, on 1,000 test rows (no multiple
# of a block's 128) and 5,000 train rows; N below B and one past a whole
# number of steps, where a zero pad row's cross term 0 would beat the
# positive metrics; duplicated rows of small integers (ties everywhere,
# negative metrics); operands at +-127; K12's metrics at +-(2**18 - 1)
INT8_EDGE_WIDTHS = (1, 4, 9, 16, 17, 19, 32)
INT8_PAD_CASES = ((4, 300), (4, 1537), (1, 129), (8, 1025), (16, 2049))


def check_int8_edges(dev):
    """K11 (with and without y2) and K12 through their wrappers at the
    edges above, each equal to its plain version bit for bit, metrics and
    columns."""
    from avenir_tpu_torch.ops import cuda_fold as CF
    from avenir_tpu_torch.ops import fold as F
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    held = collections.Counter()

    def ints(shape, lo, hi):
        return torch.randint(lo, hi + 1, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.int8)

    def hold(what, xa, ya, n_acc, k=16, y2=None, packed=False):
        kw = dict(k=k, n_acc=n_acc, tile_n=max(4096, n_acc * 128))
        if packed:
            bound = F.packed_metric_bound(xa, ya)
            got = CF.packed_fold(xa, ya, metric_bound=bound, **kw)
            want = F.packed_fold_plain(xa, ya, metric_bound=bound, **kw)
        else:
            got = CF.int8_fold(xa, ya, y2, **kw)
            want = F.int8_fold_plain(xa, ya, y2, **kw)
        name = "K12" if packed else "K11"
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(
                f"{name} {what} n_acc={n_acc}: differs from plain in "
                f"{int((got[0] != want[0]).sum())} metrics and "
                f"{int((got[1] != want[1]).sum())} columns")
        held[name] += 1
        return want

    m, n = 1000, 5000
    for w in INT8_EDGE_WIDTHS:
        xa, ya = ints((m, w), -127, 127), ints((n, w), -127, 127)
        y2 = torch.randint(-2 ** 20, 2 ** 20, (n,), generator=gen,
                           device=dev, dtype=torch.int32)
        hi = min(127, math.isqrt((F.PACKED_METRIC_LIMIT - 1) // w))
        xp, yp = ints((m, w), -hi, hi), ints((n, w), -hi, hi)
        for n_acc in F.PACKED_N_ACC_CHOICES:
            if n_acc in F.N_ACC_CHOICES:
                hold(f"w={w}", xa, ya, n_acc)
                hold(f"w={w} y2", xa, ya, n_acc, y2=y2)
            hold(f"w={w}", xp, yp, n_acc, packed=True)
    for n_acc, n_pad in INT8_PAD_CASES:
        xa, ya = ints((m, 19), 1, 59), ints((n_pad, 19), 1, 59)
        if n_acc in F.N_ACC_CHOICES:
            hold(f"n={n_pad}", xa, ya, n_acc)
        hold(f"n={n_pad}", xa, ya, n_acc, packed=True)
    m, n = 2051, 65536
    xa, rows = ints((m, 9), -3, 3), ints((n // 8, 9), -3, 3)
    ya = rows[torch.randint(0, n // 8, (n,), generator=gen, device=dev)]
    y2 = (ya.to(torch.int32) ** 2).sum(dim=1, dtype=torch.int32)
    for n_acc in (1, 4, 8, 16):
        if n_acc < 16:
            hold("ties", xa, ya, n_acc)
            hold("ties y2", xa, ya, n_acc, y2=y2)
        hold("ties", xa, ya, n_acc, packed=True)
    m, n = 1000, 5000
    xa, ya = ((ints(shape, 0, 1).to(torch.int32) * 254 - 127).to(torch.int8)
              for shape in ((m, 32), (n, 32)))
    xa[3], xa[4], ya[5] = 127, -127, 127
    for n_acc in (2, 8):
        want = hold("+-127", xa, ya, n_acc)
        hold("+-127 y2", xa, ya, n_acc, y2=(ya.to(torch.int32) ** 2).sum(
            dim=1, dtype=torch.int32))
    if int(want[0][4, 0]) != -32 * 127 ** 2:
        raise AssertionError("K11 +-127: the extreme cross term is missing")
    # per-column ranges whose bound is 16 * 127^2 + 127 * 32 + 15 = 2^18 - 1
    hi_x = torch.tensor([127] * 17 + [15], device=dev, dtype=torch.int32)
    hi_y = torch.tensor([127] * 16 + [32, 1], device=dev, dtype=torch.int32)
    xa = ((ints((m, 18), 0, 1).to(torch.int32) * 2 - 1) * hi_x).to(torch.int8)
    ya = ((ints((n, 18), 0, 1).to(torch.int32) * 2 - 1) * hi_y).to(torch.int8)
    xa[3], xa[4], ya[5] = hi_x.to(torch.int8), -hi_x.to(torch.int8), \
        hi_y.to(torch.int8)
    if F.packed_metric_bound(xa, ya) != F.PACKED_METRIC_LIMIT - 1:
        raise AssertionError("K12 extremes: the bound is not 2**18 - 1")
    for n_acc in (2, 16):
        want = hold("+-(2**18-1)", xa, ya, n_acc, packed=True)
        if int(want[0][4, 0]) != 1 - F.PACKED_METRIC_LIMIT:
            raise AssertionError("K12 extremes: -(2**18 - 1) is missing")
    log(f"phase 2 int8 tensor-core edges: K11 {held['K11']} and K12 "
        f"{held['K12']} calls equal to plain, metrics and columns (w "
        f"{', '.join(map(str, INT8_EDGE_WIDTHS))} at every n_acc; N "
        + ", ".join(f"{b} at n_acc {a}" for a, b in INT8_PAD_CASES)
        + "; 2051 x 65536 duplicated rows; operands at +-127; K12 metrics "
        "at +-(2**18 - 1))")


def check_int8_packing(dev):
    """The int8 tensor-core body's packed rows (and y2 padded) equal
    ``int8_tc_packed`` (and y2 then zeros) bit for bit, at the sweeps'
    shape on ``int8epi``'s operands."""
    from avenir_tpu_torch.ops import cuda_fold as CF
    from avenir_tpu_torch.scripts import _sweep as S
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    x = torch.rand((8192, 9), generator=gen, device=dev)
    y = torch.rand((65536, 9), generator=gen, device=dev)
    x8, y8, _ = S.quant(x, y, 127.0)
    y2 = S._int8_sq_norm(y8)
    yp, y2p, _, _ = CF._launch_int8(x8, y8, y2, S.K, S.N_ACC, "tensor",
                                    dev)[2]
    n = y8.shape[0]
    if not (torch.equal(yp, CF.int8_tc_packed(y8, yp.shape[0]))
            and torch.equal(y2p[:n], y2) and not y2p[n:].any()):
        raise AssertionError("K11's packed rows differ from int8_tc_packed")
    log(f"phase 2 int8 packed rows: K11's [{yp.shape[0]}, 32] equal "
        "int8_tc_packed(y8), its y2 padded with zeros, bit for bit")


def sweep_harnesses():
    """Phase 5: the seven kernel-restructure sweeps, in-process on the card
    at their own shape, each fold kernel's launches counted from 0."""
    import importlib
    from avenir_tpu_torch.ops import cuda_fold as CF
    counters = {"K6": CF.acc_fold, "K9": CF.tpose_fold, "K10": CF.raw_fold,
                "K11": CF.int8_fold, "K12": CF.packed_fold}
    for fn in counters.values():
        fn.launches = 0
    results = {}
    for name in ("sweep11_vmem", "sweep14_tpose", "sweep17_tpose_protocol",
                 "sweep16_kernels", "sweep16b_kernels", "sweep16c_kernels",
                 "sweep18_tpose_fold"):
        log(f"phase 5 python -m avenir_tpu_torch.scripts.{name}:")
        module = importlib.import_module(f"avenir_tpu_torch.scripts.{name}")
        results[name] = module.main([])
    launches = {name: fn.launches for name, fn in counters.items()}
    missing = [name for name, c in launches.items() if c < 1]
    if missing:
        raise AssertionError(f"phase 5: {missing} not launched")
    gates = {}
    for name in ("sweep16_kernels", "sweep16b_kernels", "sweep16c_kernels",
                 "sweep18_tpose_fold"):
        gates.update(results[name]["gates"])
        for row in results[name]["timed"]:
            if not (math.isfinite(row["us"]) and row["us"] > 0
                    and math.isfinite(row["ratio"])):
                raise AssertionError(f"phase 5 {name} time out of range: "
                                     f"{row}")
    for name, g in gates.items():
        # K2 is exact; every arm approximates it and keeps most neighbors,
        # whether or not it clears the sweeps' 0.985
        floor = 0.999 if name == "prod" else 0.5
        if not (floor <= g["recall"] <= 1.0 and g["dist_err"] >= 0):
            raise AssertionError(f"phase 5 gate out of range: {g}")
    for name in ("sweep14_tpose", "sweep17_tpose_protocol"):
        if not 0.5 <= results[name]["recall"] <= 1.0:
            raise AssertionError(f"phase 5 {name}: {results[name]}")
    log("phase 5 gates: " + "; ".join(
        f"{name} recall {g['recall']:.4f} err {g['dist_err']} "
        f"{'PASS' if g['ok'] else 'FAIL'}" for name, g in gates.items())
        + f"; launches {json.dumps(launches)}")
    return launches


def fold_harnesses(dev):
    """Phase 4: the experiment harnesses of the slice, in-process on the
    card, each fold kernel's launches counted from 0; K6's f32 arm (the
    CUDA-core body) beside the bound of its f32 product and the floor of
    its fold's four instructions a pair at 64 lanes an SM and clock."""
    from avenir_tpu_torch.ops import cuda_fold as CF
    from avenir_tpu_torch.scripts import exp_fold, roofline_knn
    from avenir_tpu_torch.ops import cuda_distance as D
    counters = {"K2-sweep": D.topk_sweep_min, "K2-nodot": D.topk_nodot_raw,
                "K6": CF.acc_fold, "K7": CF.dotmin, "K8": CF.nodot_fold,
                "K9": CF.tpose_fold}
    for fn in counters.values():
        fn.launches = 0
    log("phase 4 python -m avenir_tpu_torch.scripts.exp_fold:")
    folds = exp_fold.main([])
    log("phase 4 python -m avenir_tpu_torch.scripts.roofline_knn:")
    roof = {r["variant"]: r for r in roofline_knn.main([])}
    launches = {name: fn.launches for name, fn in counters.items()}
    missing = [name for name, c in launches.items() if c < 1]
    if missing:
        raise AssertionError(f"phase 4: {missing} not launched")
    for row in folds:
        # the fold is approximate: bucket collisions cost some recall, the
        # bf16 rounding more
        if not (math.isfinite(row["ms"]) and row["recall_f32"] >= 0.95
                and row["recall"] >= 0.9):
            raise AssertionError(f"phase 4 exp_fold result out of range: "
                                 f"{row}")
    if not all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in roof.values()):
        raise AssertionError(f"phase 4 roofline_knn times: {roof}")
    from avenir_tpu_torch.scripts.roofline_knn import lane_ops_per_s
    m, n, d = exp_fold.M, exp_fold.N, exp_fold.D
    bound, by = bound_ms((m * d + n * d + n) * 4 + m * 128 * 8,
                         2.0 * m * n * d)
    floor = m * n * 4 / (lane_ops_per_s(dev) / 2) * 1e3
    log(f"phase 4 K6 f32 arm (CUDA cores, {len(folds)} launches, {m}x{n}, "
        f"d={d}): " + "; ".join(
            f"n_acc={r['n_acc']} tile_n={r['tile_n']} {r['ms_f32']:.4f} ms "
            f"({bound / r['ms_f32']:.1%} of bound)" for r in folds)
        + f"; bound {bound:.4f} ms ({by}: the f32 product 2*M*N*D at 67 "
        f"TFLOP/s), the fold's floor {floor:.4f} ms")
    full = roof["full"]["ms"]
    log("phase 4 decomposition: full (K2) " + f"{full:.4f} ms; " + "; ".join(
        f"{v} {roof[v]['ms']:.4f} ms = {roof[v]['ms'] / full:.0%} of full"
        for v in ("full-sweep", "full-nodot", "dotmin", "nodot", "tpose"))
        + f"; launches {json.dumps(launches)}")
    return launches


# --------------------------------------------------------------------------
# phase 6: the quantized and IVF KNN paths
# --------------------------------------------------------------------------

# bench.py's shape (bench.py:78-83) and the IVF scale case of its ANN arm
BENCH_M, BENCH_N, BENCH_D, BENCH_K = 8192, 65536, 9, 5
SCALE_N = 1_048_576
# bench.py's parity gate (bench.py:150-157, 198-200)
GATE_RECALL, GATE_VOTE, GATE_DIST_ERR = 0.985, 0.99, 25
IVF_FIELDS = ("centroids", "cent_valid", "flat", "qflat", "gids", "offsets",
              "lengths", "amax", "nlist", "probe_pad", "n_real", "n_attrs",
              "n_cat_bins", "seed")


def knn_gate(label, exact, got, y):
    """``bench.py``'s parity gate (``_parity_gate``, bench.py:158-207, and
    ``_ann_bench``'s sentinel rule, :368-378): recall of the exact top-k
    ≥ 0.985, the scaled distances of the neighbors both report within 25,
    and the majority vote over labels planted on the train rows (first
    feature > 0.5) agreeing on ≥ 99% of the rows, a row with a (-1) slot
    counting as a disagreement. Returns (recall, max error, matched pairs,
    vote agreement)."""
    d_ex, i_ex = (t.cpu().numpy() for t in exact)
    d_got, i_got = (t.cpu().numpy() for t in got)
    k = i_ex.shape[1]
    recall = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                            for a, b in zip(i_ex, i_got)]))
    err = matched = 0
    for r in range(i_ex.shape[0]):
        ex = dict(zip(i_ex[r].tolist(), d_ex[r].tolist()))
        for i, d in zip(i_got[r].tolist(), d_got[r].tolist()):
            if i in ex:
                err = max(err, abs(d - ex[i]))
                matched += 1
    labels = (y[:, 0] > 0.5).cpu().numpy().astype(np.int64)
    vote = lambda idx: labels[idx].mean(axis=1) > 0.5  # noqa: E731
    short = (i_got < 0).any(axis=1)
    agree = float(((vote(i_ex) == vote(np.maximum(i_got, 0)))
                   & ~short).mean())
    if (recall < GATE_RECALL or matched == 0 or err > GATE_DIST_ERR
            or agree < GATE_VOTE):
        raise AssertionError(
            f"{label}: gate failed: recall {recall:.4f}, scaled-distance "
            f"error {err} over {matched} pairs, vote agreement {agree:.4f}")
    return recall, err, matched, agree


def same_index(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               if isinstance(getattr(a, f), torch.Tensor)
               else getattr(a, f) == getattr(b, f) for f in IVF_FIELDS)


def hold_k1_calls(label, calls, name="K1"):
    """Each recorded K1 call (``name`` "K1-int": of its integer mode)
    against its plain version on its own operands, exactly; returns the
    count and the operands of the last."""
    from avenir_tpu_torch.ops import cuda_histogram as H
    plain = (H.class_feature_bin_sums_plain if name == "K1-int"
             else H.class_feature_bin_counts_plain)
    mine = [a for n, a, out in calls if n == name
            and torch.equal(out, plain(a["bins"], a["labels"],
                                       a["n_classes"], a["n_bins"],
                                       a["weights"]))]
    held = len(mine)
    total = sum(n == name for n, _, _ in calls)
    if held != total or not total:
        raise AssertionError(f"{label}: {total - held} of {total} {name} "
                             "calls differ from plain")
    return total, mine[-1]


def time_k1_at(dev, a):
    """K1 on recorded operands: chained, from graph replays reading HBM,
    plain, ``bincount`` and the bytes bound."""
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.scripts._timing import chain_ms
    bins, labels, c, b = a["bins"], a["labels"], a["n_classes"], a["n_bins"]
    n, f = bins.shape
    n_bytes = n * (f + 1) * 4 + f * c * b * 4
    ms = chain_ms(lambda: H.class_feature_bin_counts(bins, labels, c, b), dev)
    graph = hbm_graph_ms(lambda u, v: H.class_feature_bin_counts(u, v, c, b),
                         (bins, labels), n * (f + 1) * 4, dev)
    plain = cuda_ms(lambda: H.class_feature_bin_counts_plain(bins, labels, c,
                                                             b), 5)
    flat = bins.reshape(-1).long()
    library = cuda_ms(lambda: torch.bincount(flat, minlength=b), 20)
    bound, by = bound_ms(n_bytes, n * f)
    return {"ms": ms, "graph_ms": graph, "plain_ms": plain,
            "library_ms": library, "bound_ms": bound, "bound_by": by,
            "shape": f"N={n} F={f} C={c} B={b}"}


def profile_ops(label, fn, top=6):
    """One call of ``fn`` under ``torch.profiler``: its wall time, the
    device's busy time (the sum of its kernels' and copies' device time)
    and the operators that launched the most device time. Prints "not
    measured" where the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not device:
        log(f"{label} under torch.profiler: wall {wall:.1f} ms; device "
            "time not measured (the profiler recorded none)")
        return
    busy = sum(e.self_device_time_total for e in device) / 1e3
    # aten operators only: the profiler also charges device time to its
    # own markers ("Command Buffer Full": the host waiting on a full
    # launch queue)
    ops = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith("aten::")
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:top]
    log(f"{label} under torch.profiler: wall {wall:.1f} ms, device busy "
        f"{busy:.2f} ms ({busy / wall:.1%}); largest operators by device "
        "time: " + "; ".join(f"{e.key} x{e.count} "
                             f"{e.self_device_time_total / 1e3:.2f} ms"
                             for e in ops))


def quantized_ivf_phase(dev):
    """``quantized_topk`` (int8, bf16) and the IVF index at the bench shape
    against K2's exact top-k, the IVF build twice (identical), full probing
    against ``quantized_topk``, every K1 launch of the builds against its
    plain version, and the IVF at 1,048,576 train rows. Returns K1's
    kernels-line entry at the IVF shape."""
    from avenir_tpu_torch.ops import cuda_distance as D
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.ops import ivf, quantized
    from avenir_tpu_torch.scripts._timing import chain_ms
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    m, n, d, k = BENCH_M, BENCH_N, BENCH_D, BENCH_K
    x = torch.rand((m, d), generator=gen, device=dev)
    y = torch.rand((n, d), generator=gen, device=dev)
    exact = D.pairwise_topk_cuda(x, y, k=k)
    k2_ms = chain_ms(lambda: D.pairwise_topk_cuda(x, y, k=k), dev)
    rate = lambda ms: m / ms * 1e3  # noqa: E731
    notes = []
    for qdtype in ("int8", "bf16"):
        def call(qdtype=qdtype):
            return quantized.quantized_topk(x, y, k=k, qdtype=qdtype,
                                            device=dev)
        got = call()
        recall, err, matched, agree = knn_gate(f"quantized {qdtype}", exact,
                                               got, y)
        ms = chain_ms(call, dev)
        notes.append(f"{qdtype}: recall {recall:.4f}, scaled-distance error "
                     f"{err} over {matched} pairs, vote {agree:.4f}; "
                     f"{ms:.3f} ms, {rate(ms):,.0f} rows/s")
    quant_int8 = quantized.quantized_topk(x, y, k=k, device=dev)
    profile_ops("phase 6 quantized_topk int8",
                lambda: quantized.quantized_topk(x, y, k=k, device=dev))
    log(f"phase 6 quantized_topk {m}x{n}x{d} k={k} against K2's exact top-k "
        f"(gate recall >= {GATE_RECALL}, error <= {GATE_DIST_ERR}, vote >= "
        f"{GATE_VOTE}), chained: " + "; ".join(notes)
        + f"; K2 (pairwise_topk_cuda) {k2_ms:.4f} ms, {rate(k2_ms):,.0f} "
        "rows/s")

    # the IVF index at the bench shape, built twice: the path's K1 launches
    H.class_feature_bin_counts.launches = 0
    calls = []
    with recording(calls):
        build_ms, index = host_ms(lambda: ivf.build_ivf(y, device=dev))
        again = ivf.build_ivf(y, device=dev)
    launches = H.class_feature_bin_counts.launches
    if not same_index(index, again):
        raise AssertionError("phase 6: two IVF builds differ")
    held, k1_args = hold_k1_calls("phase 6 IVF build", calls)
    if held != launches:
        raise AssertionError(f"phase 6: {launches} K1 launches, {held} "
                             "recorded")
    lengths = index.lengths.cpu()
    full = ivf.ann_topk(index, x, k=k, n_probe=index.nlist)
    if not all(torch.equal(a, b) for a, b in zip(full, quant_int8)):
        raise AssertionError("phase 6: full-probe IVF differs from "
                             "quantized_topk (int8)")

    def query():
        return ivf.ann_topk(index, x, k=k)
    recall, err, matched, agree = knn_gate("IVF default probe", exact,
                                           query(), y)
    ann_ms = chain_ms(query, dev)
    profile_ops("phase 6 IVF default probe", query)
    k1 = time_k1_at(dev, k1_args)
    log(f"phase 6 IVF {n} rows, nlist {index.nlist} (lists of "
        f"{int(lengths.min())}-{int(lengths.max())} rows, probe_pad "
        f"{index.probe_pad}): built twice, identical, {build_ms / 1e3:.2f} s "
        f"the first; full probe ({index.nlist}) equals quantized_topk int8 "
        f"exactly; default probe {ivf.default_nprobe(index.nlist)}: recall "
        f"{recall:.4f}, error {err} over {matched} pairs, vote {agree:.4f}, "
        f"{ann_ms:.3f} ms chained, {rate(ann_ms):,.0f} rows/s")
    log(f"phase 6 K1 in the two builds: {held} launches, each exact "
        "against plain; "
        f"at {k1['shape']}: {k1['ms']:.4f} ms chained, "
        f"{k1['graph_ms']:.4f} ms from graph replays reading HBM "
        f"({k1['bound_ms'] / k1['graph_ms']:.1%} of bound), plain "
        f"{k1['plain_ms']:.4f} ms, bincount {k1['library_ms']:.4f} ms, bound "
        f"{k1['bound_ms']:.4f} ms ({k1['bound_by']})")
    del index, again, full, quant_int8

    # at scale: 1,048,576 train rows, the default nlist 1,024 and nprobe 256
    y_big = torch.rand((SCALE_N, d), generator=gen, device=dev)
    H.class_feature_bin_counts.launches = 0
    calls = []
    with recording(calls):
        build_ms, big = host_ms(lambda: ivf.build_ivf(y_big, device=dev))
    held_big, big_args = hold_k1_calls("phase 6 IVF build at scale", calls)
    if held_big != H.class_feature_bin_counts.launches:
        raise AssertionError("phase 6: K1 launches at scale not all "
                             "recorded")
    launches += held_big
    k1_big = time_k1_at(dev, big_args)
    big_ms = cuda_ms(lambda: ivf.ann_topk(big, x, k=k), 2)
    profile_ops("phase 6 IVF at scale", lambda: ivf.ann_topk(big, x, k=k))
    recall, err, matched, agree = knn_gate(
        "IVF at scale", D.pairwise_topk_cuda(x[:512], y_big, k=k),
        ivf.ann_topk(big, x[:512], k=k), y_big)
    lengths = big.lengths.cpu()
    log(f"phase 6 IVF {SCALE_N} rows, nlist {big.nlist} (lists of "
        f"{int(lengths.min())}-{int(lengths.max())} rows, probe_pad "
        f"{big.probe_pad}), nprobe {ivf.default_nprobe(big.nlist)}: build "
        f"{build_ms / 1e3:.2f} s; query {m} rows {big_ms:.1f} ms, "
        f"{rate(big_ms):,.0f} rows/s; 512-row slice against K2: recall "
        f"{recall:.4f}, error {err} over {matched} pairs, vote {agree:.4f}")
    log(f"phase 6 K1 in the build at scale: {held_big} calls exact against "
        f"plain; at {k1_big['shape']}: {k1_big['ms']:.4f} ms chained, "
        f"{k1_big['graph_ms']:.4f} ms from graph replays reading HBM "
        f"({k1_big['bound_ms'] / k1_big['graph_ms']:.1%} of bound), plain "
        f"{k1_big['plain_ms']:.4f} ms, bincount {k1_big['library_ms']:.4f} "
        f"ms, bound {k1_big['bound_ms']:.4f} ms ({k1_big['bound_by']})")
    return {"name": "cfb_counts (K1) at the IVF shape (k-means list "
                    "counts, C = 1, F = 1, B = nlist)",
            "route": "cuda", "source": "avenir_tpu_torch/csrc/hist.cu",
            "replaces": "avenir_tpu/ops/pallas_histogram.py:57",
            "launches": launches, "max_abs_err": 0.0,
            **{key: k1[key] for key in ("ms", "graph_ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
            "shape": k1["shape"],
            "scale": {key: k1_big[key] for key in (
                "shape", "ms", "graph_ms", "plain_ms", "bound_ms",
                "library_ms")}}


# --------------------------------------------------------------------------
# phase 7: the decision-tree family
# --------------------------------------------------------------------------

# the repo's tree workload: retarget_rows(4096, seed=1) tiled 256 times
TREE_BASE_ROWS, TREE_REPS = 4096, 256
TREE_DEPTHS = (4, 8)
# the CLI jobs' retarget rows
TREE_TRAIN, TREE_TEST = 200_000, 50_000
TREE_ACCURACY_BAR = 0.70


def retarget_big_table(dev):
    """1,048,576 retarget rows on ``dev``: 4,096 rows featurized, then
    tiled (a tree's counts depend on the rows' distribution, not their
    uniqueness)."""
    import dataclasses
    from avenir_tpu_torch.datagen import retarget_rows, retarget_schema
    from avenir_tpu_torch.utils.dataset import Featurizer
    base = retarget_rows(TREE_BASE_ROWS, seed=1)
    table = Featurizer(retarget_schema(), device=dev).fit(base) \
        .transform(base)
    return dataclasses.replace(
        table, binned=table.binned.repeat(TREE_REPS, 1),
        numeric=table.numeric.repeat(TREE_REPS, 1),
        labels=table.labels.repeat(TREE_REPS), ids=[],
        n_rows=table.n_rows * TREE_REPS)


def time_k1_weighted(dev, a):
    """K1 on the recorded operands of a weighted call: chained, from graph
    replays reading HBM, plain, the library call (one ``bincount`` of the
    weights over the same combined ids, built beforehand) and the bytes
    bound (ids, labels and weights read once, the counts written once)."""
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.scripts._timing import chain_ms
    bins, labels, w = a["bins"], a["labels"], a["weights"]
    c, b = a["n_classes"], a["n_bins"]
    n, f = bins.shape
    cells = f * c * b
    in_bytes = n * (f + 2) * 4
    ms = chain_ms(lambda: H.class_feature_bin_counts(bins, labels, c, b, w),
                  dev)
    graph = hbm_graph_ms(
        lambda u, v, x: H.class_feature_bin_counts(u, v, c, b, x),
        (bins, labels, w), in_bytes, dev)
    plain = cuda_ms(lambda: H.class_feature_bin_counts_plain(
        bins, labels, c, b, w), 5)
    ids = bins.long()
    flat = (torch.arange(f, device=dev)[None, :] * (c * b)
            + labels.long()[:, None] * b + ids)
    flat = torch.where(ids >= 0, flat, cells).reshape(-1)   # -1: a spare cell
    wide = w.reshape(n, 1).expand(n, f).reshape(-1).contiguous()
    library = cuda_ms(lambda: torch.bincount(flat, weights=wide,
                                             minlength=cells + 1), 20)
    bound, by = bound_ms(in_bytes + cells * 4, n * f)
    return {"ms": ms, "graph_ms": graph, "plain_ms": plain,
            "library_ms": library, "bound_ms": bound, "bound_by": by,
            "shape": f"N={n} F={f} C={c} B={b} weighted"}


def same_files(a_dir, b_dir):
    """Relative paths of the files under two directories, and those whose
    bytes differ or that only one of them holds."""
    def files(d):
        return {os.path.relpath(os.path.join(r, n), d)
                for r, _, names in os.walk(d) for n in names}
    fa, fb = files(a_dir), files(b_dir)
    differ = sorted(fa ^ fb) + sorted(
        rel for rel in fa & fb
        if open(os.path.join(a_dir, rel), "rb").read()
        != open(os.path.join(b_dir, rel), "rb").read())
    return sorted(fa), differ


def tree_library_growth(dev):
    """``grow_tree_device`` (giniIndex) at depths 4 and 8 on 1,048,576 rows:
    each tree equal to the same port's growth on the CPU, every K1 launch
    held exactly against its plain version, a tree's seconds (host clock,
    the readback included), K1 timed at every level shape, and the depth-8
    growth profiled. Returns (K1's launches, the timings by shape)."""
    import dataclasses
    from avenir_tpu_torch.models import tree as T
    from avenir_tpu_torch.ops import cuda_histogram as H
    table = retarget_big_table(dev)
    cpu_table = dataclasses.replace(
        table, binned=table.binned.cpu(), numeric=table.numeric.cpu(),
        labels=table.labels.cpu())
    launches, by_shape = 0, {}
    for depth in TREE_DEPTHS:
        cfg = T.TreeConfig(max_depth=depth, algorithm="giniIndex")
        calls = []
        H.class_feature_bin_counts.launches = 0
        with recording(calls):
            tree = T.grow_tree_device(table, cfg)
        count = H.class_feature_bin_counts.launches
        held, _ = hold_k1_calls(f"phase 7 depth {depth}", calls)
        if held != count:
            raise AssertionError(f"phase 7 depth {depth}: {count} K1 "
                                 f"launches, {held} recorded")
        launches += count
        t0 = time.perf_counter()
        on_cpu = T.grow_tree_device(cpu_table, cfg)
        cpu_s = time.perf_counter() - t0
        if T.canonical_tree(tree) != T.canonical_tree(on_cpu):
            raise AssertionError(f"phase 7 depth {depth}: the card's tree "
                                 "differs from the CPU's")
        secs = [host_ms(lambda: T.grow_tree_device(table, cfg))[0] / 1e3
                for _ in range(3)]
        for name, a, _ in calls:
            by_shape.setdefault((a["n_bins"], a["bins"].shape), a)
        log(f"phase 7 grow_tree_device giniIndex depth {depth}, "
            f"{table.n_rows} rows: {count} K1 launches (combined bins "
            f"{[a['n_bins'] for _, a, _ in calls]}), each exact against "
            f"plain; tree equal to the CPU's ({cpu_s:.2f} s there); "
            f"{', '.join(f'{t:.4f}' for t in secs)} s a tree on the card "
            f"(host clock, one readback); depth reached "
            f"{max_depth(tree)}, root attr {tree.attr_ordinal}")
    # the split statistics on the card against the CPU's, bit for bit, on
    # seeded counts
    from avenir_tpu_torch.ops import infotheory as I
    rng = np.random.default_rng(SEED + 7)
    counts = rng.integers(0, 3000, (200_000, 4, 2)).astype(np.float32)
    counts[rng.random(counts.shape) < 0.3] = 0
    notes = []
    for alg in ("giniIndex", "entropy", "hellingerDistance",
                "hellingerDistance:reference", "classConfidenceRatio"):
        card = I.split_stat(torch.from_numpy(counts).to(dev), alg).cpu()
        cpu = I.split_stat(torch.from_numpy(counts), alg)
        if not torch.equal(card, cpu):
            raise AssertionError(
                f"phase 7 split_stat {alg}: {int((card != cpu).sum())} of "
                f"{cpu.numel()} differ from the CPU's")
        notes.append(alg)
    log(f"phase 7 split statistics of {counts.shape[0]} candidates on the "
        "card equal the CPU's bit for bit: " + ", ".join(notes))
    profile_ops("phase 7 grow_tree_device depth 8",
                lambda: T.grow_tree_device(
                    table, T.TreeConfig(max_depth=8)))
    timings = []
    for (b, _), a in sorted(by_shape.items()):
        k1 = time_k1_weighted(dev, a)
        timings.append(k1)
        log(f"phase 7 K1 at {k1['shape']}: {k1['ms']:.4f} ms chained, "
            f"{k1['graph_ms']:.4f} ms from graph replays reading HBM "
            f"({k1['bound_ms'] / k1['graph_ms']:.1%} of bound), plain "
            f"{k1['plain_ms']:.4f} ms, bincount {k1['library_ms']:.4f} ms, "
            f"bound {k1['bound_ms']:.4f} ms ({k1['bound_by']})")
    return launches, timings


def max_depth(node) -> int:
    return 0 if not node.children else 1 + max(
        max_depth(c) for c in node.children.values())


def tree_cli_jobs(work):
    """The five tree verbs on 200,000 retarget train rows and 50,000 test
    rows, each on the card and with ``--device cpu`` in a directory of its
    own: TreeBuilder (max.depth=4) + TreePredictor (validation.mode, host
    walk and device routing), the tutorial's ClassPartitionGenerator
    at.root → SplitGenerator → DataPartitioner round, and DataPartitioner
    with tree.levels.per.invocation=3. Every file the card's jobs write
    equals the CPU's byte for byte, the root splits on cartValue (1) or
    loyalty (3), validation accuracy reaches the bar, and K1 launches
    (TreeBuilder, batched DataPartitioner), each launch held exactly.
    Returns K1's launches."""
    from avenir_tpu_torch.datagen import retarget_rows
    from avenir_tpu_torch.datagen.generators import _RETARGET_SCHEMA_JSON
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.cli.main import main
    rows = retarget_rows(TREE_TRAIN + TREE_TEST, seed=SEED)
    schema = os.path.join(work, "retarget.json")
    with open(schema, "w") as fh:
        json.dump(_RETARGET_SCHEMA_JSON, fh)
    dirs = {dev: os.path.join(work, f"tree_{dev}") for dev in ("cuda", "cpu")}
    for dev, d in dirs.items():
        os.makedirs(d)
        write_csv(os.path.join(d, "train.csv"), rows[:TREE_TRAIN])
        write_csv(os.path.join(d, "test.csv"), rows[TREE_TRAIN:])
        with open(os.path.join(work, f"tree_{dev}.properties"), "w") as fh:
            fh.write(f"feature.schema.file.path={schema}\n"
                     "field.delim.regex=,\nfield.delim.out=;\n"
                     f"tree.model.file.path={os.path.join(d, 'model.json')}\n"
                     "positive.class.value=yes\nmax.depth=4\n")
    launches = 0

    def both(label, verb, inp, out, *extra, k1=False):
        nonlocal launches
        reports, walls = {}, {}
        for dev, d in dirs.items():
            args = [verb, os.path.join(d, inp), os.path.join(d, out),
                    "--conf", os.path.join(work, f"tree_{dev}.properties"),
                    *[e.replace("{d}", d) for e in extra], "--device", dev]
            calls = []
            H.class_feature_bin_counts.launches = 0
            t0 = time.perf_counter()
            with recording(calls):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    if main(args) != 0:
                        raise AssertionError(f"phase 7 {label}: {dev} run "
                                             "failed")
            if dev == "cuda":
                torch.cuda.synchronize()
            walls[dev] = time.perf_counter() - t0
            reports[dev] = buf.getvalue()
            if dev == "cuda":
                count = H.class_feature_bin_counts.launches
                if k1 and not count:
                    raise AssertionError(f"phase 7 {label}: K1 not launched")
                if count:
                    held, _ = hold_k1_calls(f"phase 7 {label}", calls)
                    if held != count:
                        raise AssertionError(f"phase 7 {label}: {count} K1 "
                                             f"launches, {held} recorded")
                launches += count
        if reports["cuda"] != reports["cpu"]:
            raise AssertionError(f"phase 7 {label}: stdout differs: "
                                 f"{reports}")
        names, differ = same_files(dirs["cuda"], dirs["cpu"])
        if differ:
            raise AssertionError(f"phase 7 {label}: files differ between "
                                 f"the card and the CPU: {differ[:10]}")
        log(f"phase 7 {label}: card {walls['cuda']:.2f} s, CPU "
            f"{walls['cpu']:.2f} s (host clock); {len(names)} files "
            "byte-identical to the CPU's")
        lines = [line for line in reports["cuda"].splitlines() if line]
        return json.loads(lines[-1]) if lines else {}

    built = both(f"TreeBuilder {TREE_TRAIN} rows max.depth=4", "TreeBuilder",
                 "train.csv", "model.json", k1=True)
    with open(os.path.join(dirs["cuda"], "model.json")) as fh:
        root_attr = json.load(fh)["root"]["attr"]
    if root_attr not in (1, 3):
        raise AssertionError(f"phase 7: the root splits on {root_attr}, not "
                             "cartValue (1) or loyalty (3)")
    for on_device in ("false", "true"):
        report = both(f"TreePredictor {TREE_TEST} rows device.predict="
                      f"{on_device}", "TreePredictor", "test.csv",
                      f"pred_{on_device}.txt", "-D", "validation.mode=true",
                      "-D", f"device.predict={on_device}")
        acc = report["Validation.Accuracy"]
        if acc < TREE_ACCURACY_BAR:
            raise AssertionError(f"phase 7: accuracy {acc} below "
                                 f"{TREE_ACCURACY_BAR}")
    log(f"phase 7 planted rule: depth {built['Tree.Depth']}, root on "
        f"attribute {root_attr}, validation accuracy {acc:.4f} (bar "
        f"{TREE_ACCURACY_BAR})")
    both("ClassPartitionGenerator at.root", "ClassPartitionGenerator",
         "train.csv", "root.txt", "-D", "at.root=true")
    with open(os.path.join(dirs["cuda"], "root.txt")) as fh:
        parent = fh.read().strip()
    both("SplitGenerator", "SplitGenerator", "train.csv", "splits.txt",
         "-D", f"parent.info={parent}")
    picked = both("DataPartitioner", "DataPartitioner", "train.csv", "node",
                  "-D", "candidate.splits.path={d}/splits.txt")
    if picked["split.attribute"] not in (1, 3):
        raise AssertionError(f"phase 7: DataPartitioner split on {picked}")
    both("DataPartitioner tree.levels.per.invocation=3", "DataPartitioner",
         "train.csv", "batched", "-D", "tree.levels.per.invocation=3",
         "-D", "candidate.splits.path={d}/batched_splits.txt", k1=True)
    return launches


def tree_phase(dev, work):
    """Phase 7; returns K1's kernels-line entry at the tree shape."""
    launches, timings = tree_library_growth(dev)
    cli_launches = tree_cli_jobs(work)
    widest = max(timings, key=lambda k: k["bound_ms"])
    return {"name": "cfb_counts (K1) at the tree shape (a level's "
                    "(node, feature, bin, class) histogram, weighted)",
            "route": "cuda", "source": "avenir_tpu_torch/csrc/hist.cu",
            "replaces": "avenir_tpu/ops/pallas_histogram.py:57",
            "launches": launches, "cli_launches": cli_launches,
            "max_abs_err": 0.0,
            **{key: widest[key] for key in ("ms", "graph_ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms", "shape")},
            "levels": [{key: k[key] for key in (
                "shape", "ms", "graph_ms", "plain_ms", "library_ms",
                "bound_ms")} for k in timings]}


# --------------------------------------------------------------------------
# phase 8: the sequence models
# --------------------------------------------------------------------------

SEQ_SCALE = 1_048_576
MARKOV_LEN = (5, 30)          # states a sequence: the tutorial's 5-30
HMM_LEN = (8, 40)             # steps a loyalty sequence (hmm_tagged_rows')
MARKOV_LABELS = ("churn", "loyal")
VITERBI_CPU_ROWS = 65_536
BW_SIZES = (8_192, 81_920)    # the associative and the sequential E-step
BW_ITERS, BW_CHUNK = 10, 5
MARKOV_CLI_TRAIN, MARKOV_CLI_TEST = 200_000, 50_000
HMM_CLI_ROWS, BW_CLI_ROWS = 100_000, 8_192
# the gates: the planted matrix recovered, the classifier's and Viterbi's
# accuracy on the planted signal, and the tolerances of the float results
# (the log odds are f32 sums in one order on both devices; Baum-Welch
# runs exp and log, which differ between the card and the CPU)
MARKOV_PLANTED_ATOL = 0.01
MARKOV_ACCURACY_BAR = 0.95
VITERBI_ACCURACY_BAR = 0.45
ODDS_RTOL, LL_RTOL, PARAM_ATOL, LL_SLACK = 1e-6, 1e-5, 1e-4, 1e-2


def markov_planted():
    """The two classes' planted [S, S] transition matrices over the
    email-marketing tutorial's nine states, [2, 9, 9]."""
    rng = np.random.default_rng(SEED + 8)
    return np.stack([rng.dirichlet(np.ones(9) * 0.7, size=9)
                     for _ in MARKOV_LABELS])


def draw_categorical(rng, probs):
    """One draw from each row of [n, K] ``probs`` (inverse CDF)."""
    cdf = np.cumsum(probs, axis=1)
    u = rng.random(len(probs))
    return np.minimum((u[:, None] >= cdf).sum(1), probs.shape[1] - 1)


def draw_markov(n, planted, seed):
    """``n`` class-conditional sequences of MARKOV_LEN states drawn
    vectorized (a row generator's per-step ``rng.choice`` would take
    minutes at this size): codes [n, 30] int32 padded with 0 as
    ``encode_sequences`` pads, lengths [n] int32, class ids [n] int32."""
    rng = np.random.default_rng(seed)
    n_states = planted.shape[1]
    labels = rng.integers(0, len(planted), n).astype(np.int32)
    lengths = rng.integers(MARKOV_LEN[0], MARKOV_LEN[1] + 1, n) \
        .astype(np.int32)
    codes = np.zeros((n, MARKOV_LEN[1]), np.int32)
    codes[:, 0] = rng.integers(0, n_states, n)
    for t in range(1, MARKOV_LEN[1]):
        codes[:, t] = draw_categorical(rng, planted[labels, codes[:, t - 1]])
    codes[np.arange(MARKOV_LEN[1])[None, :] >= lengths[:, None]] = 0
    return codes, lengths, labels


def draw_hmm(n, seed):
    """``n`` sequences of the loyalty tutorial's HMM of HMM_LEN steps,
    drawn vectorized: observation codes and hidden states [n, 40] int32
    (0 past a row's length), lengths [n] int32."""
    from avenir_tpu_torch.datagen import generators as G
    rng = np.random.default_rng(seed)
    lengths = rng.integers(HMM_LEN[0], HMM_LEN[1] + 1, n).astype(np.int32)
    obs = np.zeros((n, HMM_LEN[1]), np.int32)
    states = np.zeros((n, HMM_LEN[1]), np.int32)
    s = draw_categorical(rng, np.broadcast_to(G.LOYALTY_INITIAL, (n, 3)))
    for t in range(HMM_LEN[1]):
        states[:, t] = s
        obs[:, t] = draw_categorical(rng, G.LOYALTY_EMIT[s])
        s = draw_categorical(rng, G.LOYALTY_TRANS[s])
    past = np.arange(HMM_LEN[1])[None, :] >= lengths[:, None]
    obs[past] = 0
    states[past] = 0
    return obs, states, lengths


def code_rows(codes, lengths, symbols):
    """Token rows of ``codes`` cut at each row's length (the symbols are
    shared objects, so 40M tokens cost no new strings)."""
    table = np.asarray(symbols, dtype=object)[codes]
    return [row[:n] for row, n in zip(table.tolist(), lengths.tolist())]


def hold_k4_pair_calls(label, calls):
    """Each recorded one-pair K4 call against its plain version on its own
    operands, exactly; returns the calls."""
    from avenir_tpu_torch.ops import cuda_histogram as H
    mine = [(a, out) for name, a, out in calls if name == "K4-pair"]
    if not mine:
        raise AssertionError(f"{label}: K4 was not called")
    for a, out in mine:
        want = H.pair_counts_plain(a["a"], a["b"], a["n_a"], a["n_b"],
                                   a["weights"])
        if not torch.equal(out, want):
            raise AssertionError(f"{label}: a K4 launch of "
                                 f"{a['a'].shape[0]} rows differs from plain "
                                 f"in {int((out != want).sum())} cells")
    return mine


def time_k4_pair(dev, a, b, n_a, n_b):
    """K4 on a recorded launch's operands, ``b`` at a fixed stride past
    ``a`` as the Markov path lays them: chained, from graph replays
    reading HBM, plain, ``bincount`` over the combined ids and the bytes
    bound (both id rows read once, the counts written once)."""
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.scripts._timing import chain_ms
    ids = torch.stack([a, b])
    n = ids.shape[1]

    def timed(t):
        return H.pair_counts(t[0], t[1], n_a, n_b)
    ms = chain_ms(lambda: timed(ids), dev)
    graph = hbm_graph_ms(timed, (ids,), 2 * n * 4, dev)
    plain = cuda_ms(lambda: H.pair_counts_plain(ids[0], ids[1], n_a, n_b), 5)
    flat = pair_flat(ids[0], ids[1], n_a, n_b)
    library = cuda_ms(lambda: torch.bincount(flat, minlength=n_a * n_b), 20)
    bound, by = bound_ms(2 * n * 4 + n_a * n_b * 4, n)
    return {"ms": ms, "graph_ms": graph, "plain_ms": plain,
            "library_ms": library, "bound_ms": bound, "bound_by": by,
            "shape": f"N={n} n_a={n_a} n_b={n_b}"}


def markov_at_scale(dev):
    """Markov training on SEQ_SCALE class-conditional sequences: every K4
    launch held exactly, the int64 counts equal to the CPU's, the planted
    matrices recovered, the training time; K4 timed at the launch's
    shape; the sequences classified, the labels equal to the CPU's and
    the odds within ODDS_RTOL. Returns K4's launches and timing."""
    from avenir_tpu_torch.models import markov as M
    from avenir_tpu_torch.ops import cuda_histogram as H
    planted = markov_planted()
    codes, lengths, labels = draw_markov(SEQ_SCALE, planted, SEED + 81)
    host = [torch.from_numpy(x) for x in (codes, lengths, labels)]
    seqs, lens, cids = (x.to(dev) for x in host)
    n_trans = int(np.maximum(lengths - 1, 0).sum())
    calls = []
    H.pair_counts.launches = 0
    with recording(calls):
        counts = M._bigram_counts(seqs, lens, cids, 9, 2)
    launches = H.pair_counts.launches
    mine = hold_k4_pair_calls("phase 8 Markov at scale", calls)
    if launches != len(mine) or launches != -(-n_trans
                                              // M.MAX_LAUNCH_TRANSITIONS):
        raise AssertionError(f"phase 8: {launches} K4 launches, "
                             f"{len(mine)} recorded, for {n_trans} "
                             "transitions")
    cpu = M._bigram_counts(*host, 9, 2)
    if not torch.equal(counts.cpu(), cpu):
        raise AssertionError("phase 8: the card's int64 counts differ from "
                             "the CPU's")
    states = list(M.XACTION_STATES)
    secs = [host_ms(lambda: M.train_encoded(
        seqs, lens, states, cids, list(MARKOV_LABELS), scale=1))[0] / 1e3
        for _ in range(3)]
    model = M.train_encoded(seqs, lens, states, cids, list(MARKOV_LABELS),
                            scale=1)
    err = max(float(np.abs(model.class_trans[label] - planted[i]).max())
              for i, label in enumerate(MARKOV_LABELS))
    if err > MARKOV_PLANTED_ATOL:
        raise AssertionError(f"phase 8: planted matrices recovered within "
                             f"{err}, not {MARKOV_PLANTED_ATOL}")
    log(f"phase 8 Markov at scale: {SEQ_SCALE} sequences of "
        f"{MARKOV_LEN[0]}-{MARKOV_LEN[1]} states, {n_trans} transitions, "
        f"{launches} K4 launches of {[a['a'].shape[0] for a, _ in mine]} "
        f"steps (fewer than 2^24 of them transitions), each exact against "
        "plain; int64 counts equal the CPU's; planted matrices recovered "
        f"within {err:.5f} (gate {MARKOV_PLANTED_ATOL}); training "
        f"{', '.join(f'{s:.4f}' for s in secs)} s (host clock, counts read "
        "back and normalized)")
    first = mine[0][0]
    k4 = time_k4_pair(dev, first["a"], first["b"], first["n_a"],
                      first["n_b"])
    log(f"phase 8 K4 at the Markov shape {k4['shape']}: {k4['ms']:.4f} ms "
        f"chained, {k4['graph_ms']:.4f} ms from graph replays reading HBM "
        f"({k4['bound_ms'] / k4['graph_ms']:.1%} of bound), plain "
        f"{k4['plain_ms']:.4f} ms, bincount {k4['library_ms']:.4f} ms, "
        f"bound {k4['bound_ms']:.4f} ms ({k4['bound_by']})")
    del calls, mine, first
    model = M.train_encoded(seqs, lens, states, cids, list(MARKOV_LABELS))
    t_card, (pred, odds) = host_ms(lambda: M.classify_encoded(
        model, seqs, lens, MARKOV_LABELS))
    t0 = time.perf_counter()
    cpu_pred, cpu_odds = M.classify_encoded(model, host[0], host[1],
                                            MARKOV_LABELS)
    t_cpu = time.perf_counter() - t0
    if not np.array_equal(pred, cpu_pred):
        raise AssertionError("phase 8: the card's Markov labels differ from "
                             "the CPU's")
    if not np.allclose(odds, cpu_odds, rtol=ODDS_RTOL, atol=0.0):
        raise AssertionError("phase 8: the card's log odds beyond rtol "
                             f"{ODDS_RTOL} of the CPU's")
    acc = float((pred == np.asarray(MARKOV_LABELS)[labels]).mean())
    log(f"phase 8 Markov classify {SEQ_SCALE} sequences: card "
        f"{t_card / 1e3:.3f} s, CPU {t_cpu:.3f} s (host clock); labels equal "
        f"the CPU's, log odds bit-identical in "
        f"{int((odds == cpu_odds).sum())} of {len(odds)} (rtol "
        f"{ODDS_RTOL}); accuracy on the planted classes {acc:.4f}")
    return launches, k4


def viterbi_at_scale(dev):
    """``predict_states`` on SEQ_SCALE loyalty sequences: the paths equal
    the CPU's on a VITERBI_CPU_ROWS slice; its wall time, the decode alone
    (``viterbi_batch`` on the encoded batch) and its busy share under
    ``torch.profiler``."""
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.models import hmm as HM
    from avenir_tpu_torch.ops.scanops import viterbi_batch
    obs, states, lengths = draw_hmm(SEQ_SCALE, SEED + 82)
    rows = code_rows(obs, lengths, G.LOYALTY_OBSERVATIONS)
    model = HM.HmmModel(G.LOYALTY_STATES, G.LOYALTY_OBSERVATIONS,
                        G.LOYALTY_TRANS, G.LOYALTY_EMIT, G.LOYALTY_INITIAL)
    wall, paths = host_ms(lambda: HM.predict_states(
        model, rows, reversed_output=False, device=dev))
    cpu = HM.predict_states(model, rows[:VITERBI_CPU_ROWS],
                            reversed_output=False, device="cpu")
    if paths[:VITERBI_CPU_ROWS] != cpu:
        raise AssertionError("phase 8: the card's Viterbi paths differ from "
                             "the CPU's")
    index = {s: i for i, s in enumerate(G.LOYALTY_STATES)}
    got = np.zeros_like(states)
    for b, path in enumerate(paths):
        got[b, :len(path)] = [index[s] for s in path]
    live = np.arange(states.shape[1])[None, :] < lengths[:, None]
    acc = float((got == states)[live].mean())
    li, lt, le = HM._log_params(model, dev)
    ob, ln = torch.from_numpy(obs).to(dev), torch.from_numpy(lengths).to(dev)
    decode = [host_ms(lambda: viterbi_batch(li, lt, le, ob, ln))[0]
              for _ in range(3)]
    log(f"phase 8 Viterbi predict_states {SEQ_SCALE} loyalty sequences of "
        f"{HMM_LEN[0]}-{HMM_LEN[1]} steps: {wall / 1e3:.2f} s (host clock, "
        "encoding and output included); the decode alone "
        f"{', '.join(f'{t:.1f}' for t in decode)} ms; paths equal the CPU's "
        f"on {VITERBI_CPU_ROWS} rows; accuracy against the planted states "
        f"{acc:.4f}")
    profile_ops("phase 8 viterbi_batch at scale",
                lambda: viterbi_batch(li, lt, le, ob, ln))


def baum_welch_phase(dev, work):
    """Baum-Welch on BW_SIZES loyalty sequences (the associative and the
    sequential E-step), BW_ITERS iterations each: the LL history never
    decreasing beyond LL_SLACK, within LL_RTOL of the CPU's at every
    iteration with the same iterations run and the log-parameters within
    PARAM_ATOL; a checkpointed run stopped after one chunk and resumed
    equal to the uninterrupted checkpointed run; seconds an iteration and
    the busy share under ``torch.profiler``."""
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.models import hmm as HM
    for n in BW_SIZES:
        obs, _, lengths = draw_hmm(n, SEED + 83)
        rows = code_rows(obs, lengths, G.LOYALTY_OBSERVATIONS)
        form = "associative" if n * 3 <= 65536 else "sequential"
        kwargs = dict(n_iters=BW_ITERS, seed=1)
        t0 = time.perf_counter()
        model, ll = HM.train_baum_welch(rows, G.LOYALTY_OBSERVATIONS, 3,
                                        device=dev, **kwargs)
        secs = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_model, cpu_ll = HM.train_baum_welch(
            rows, G.LOYALTY_OBSERVATIONS, 3, device="cpu", **kwargs)
        cpu_secs = time.perf_counter() - t0
        if len(ll) != BW_ITERS or len(cpu_ll) != BW_ITERS:
            raise AssertionError(f"phase 8 Baum-Welch {n}: {len(ll)} and "
                                 f"{len(cpu_ll)} iterations run")
        if not np.all(np.diff(ll) >= -LL_SLACK):
            raise AssertionError(f"phase 8 Baum-Welch {n}: the LL decreased: "
                                 f"{ll.tolist()}")
        ll_err = float(np.max(np.abs(ll - cpu_ll) / np.abs(cpu_ll)))
        p_err = max(float(np.abs(np.log(getattr(model, k))
                                 - np.log(getattr(cpu_model, k))).max())
                    for k in ("trans", "emit", "initial"))
        if ll_err > LL_RTOL or p_err > PARAM_ATOL:
            raise AssertionError(f"phase 8 Baum-Welch {n}: LL {ll_err:.3g} "
                                 f"relative, log-parameters {p_err:.3g} from "
                                 "the CPU's")
        ck = os.path.join(work, f"bw_{n}.npz")
        full = os.path.join(work, f"bw_{n}_full.npz")
        ck_kwargs = dict(kwargs, chunk_size=BW_CHUNK, device=dev)
        HM.train_baum_welch(rows, G.LOYALTY_OBSERVATIONS, 3,
                            **dict(ck_kwargs, n_iters=BW_CHUNK),
                            checkpoint_path=ck)
        resumed, r_ll = HM.train_baum_welch(rows, G.LOYALTY_OBSERVATIONS, 3,
                                            checkpoint_path=ck, **ck_kwargs)
        whole, w_ll = HM.train_baum_welch(rows, G.LOYALTY_OBSERVATIONS, 3,
                                          checkpoint_path=full, **ck_kwargs)
        if not (np.array_equal(r_ll, w_ll) and all(
                np.array_equal(getattr(resumed, k), getattr(whole, k))
                for k in ("trans", "emit", "initial"))):
            raise AssertionError(f"phase 8 Baum-Welch {n}: the resumed run "
                                 "differs from the uninterrupted one")
        same = np.array_equal(w_ll, ll)
        log(f"phase 8 Baum-Welch {n} sequences ({form} E-step), "
            f"{BW_ITERS} iterations: {secs / BW_ITERS:.4f} s an iteration on "
            f"the card, {cpu_secs / BW_ITERS:.4f} s on the CPU (host clock); "
            f"LL {ll[0]:.6g} -> {ll[-1]:.6g}, non-decreasing (slack "
            f"{LL_SLACK}); against the CPU's: LL within {ll_err:.3g} "
            f"relative, log-parameters within {p_err:.3g}; resumed after "
            f"one chunk of {BW_CHUNK} equal to the uninterrupted run; the "
            f"chunked path's LL {'equal to' if same else 'differs from'} "
            "the single-dispatch one's")
        profile_ops(f"phase 8 Baum-Welch {n} sequences, 3 iterations",
                    lambda: HM.train_baum_welch(
                        rows, G.LOYALTY_OBSERVATIONS, 3, n_iters=3, seed=1,
                        device=dev))


def sequence_cli_jobs(work):
    """The four verbs, each on the card and with ``--device cpu`` in a
    directory of its own: MarkovStateTransitionModel on MARKOV_CLI_TRAIN
    class-conditional rows (in memory and streamed, K4 launched and each
    launch held), MarkovModelClassifier (validation) on MARKOV_CLI_TEST
    held-out rows, HiddenMarkovModelBuilder on HMM_CLI_ROWS tagged
    loyalty rows and untagged (Baum-Welch, checkpointed) on BW_CLI_ROWS,
    ViterbiStatePredictor on the tagged rows' observations. Every file
    and stdout line of the card's jobs equals the CPU's byte for byte
    but the float fields: the log odds within ODDS_RTOL, the BaumWelch
    log-likelihood within LL_RTOL and the untagged model file's
    probabilities within PARAM_ATOL in log space (and the file's six
    digits). The classifier and Viterbi clear their planted-signal bars.
    Returns K4's launches."""
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.models import markov as M
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.cli.main import main
    planted = markov_planted()
    codes, lengths, labels = draw_markov(MARKOV_CLI_TRAIN + MARKOV_CLI_TEST,
                                         planted, SEED + 84)
    seqs = code_rows(codes, lengths, M.XACTION_STATES)
    markov_rows = [[f"C{i:07d}", MARKOV_LABELS[c]] + s
                   for i, (c, s) in enumerate(zip(labels.tolist(), seqs))]
    obs, states, hmm_lengths = draw_hmm(HMM_CLI_ROWS, SEED + 85)
    obs_rows = code_rows(obs, hmm_lengths, G.LOYALTY_OBSERVATIONS)
    state_rows = code_rows(states, hmm_lengths, G.LOYALTY_STATES)
    tagged = [[f"T{i:08d}"] + [f"{o}:{s}" for o, s in zip(orow, srow)]
              for i, (orow, srow) in enumerate(zip(obs_rows, state_rows))]
    plain_obs = [[f"T{i:08d}"] + orow for i, orow in enumerate(obs_rows)]
    dirs = {dev: os.path.join(work, f"seq_{dev}") for dev in ("cuda", "cpu")}
    for dev, d in dirs.items():
        os.makedirs(d)
        write_csv(os.path.join(d, "markov_train.csv"),
                  markov_rows[:MARKOV_CLI_TRAIN])
        write_csv(os.path.join(d, "markov_test.csv"),
                  markov_rows[MARKOV_CLI_TRAIN:])
        write_csv(os.path.join(d, "tagged.csv"), tagged)
        write_csv(os.path.join(d, "obs.csv"), plain_obs)
        write_csv(os.path.join(d, "untagged.csv"), obs_rows[:BW_CLI_ROWS])
        with open(os.path.join(work, f"seq_{dev}.properties"), "w") as fh:
            fh.write("field.delim.regex=,\n"
                     f"model.states={','.join(M.XACTION_STATES)}\n"
                     "skip.field.count=1\nclass.label.field.ord=1\n"
                     f"class.labels={','.join(MARKOV_LABELS)}\n"
                     "validation.mode=true\n"
                     f"mm.model.path={os.path.join(d, 'markov.txt')}\n")
        with open(os.path.join(work, f"hmm_{dev}.properties"), "w") as fh:
            fh.write("field.delim.regex=,\nskip.field.count=1\n"
                     f"model.states={','.join(G.LOYALTY_STATES)}\n"
                     "model.observations="
                     f"{','.join(G.LOYALTY_OBSERVATIONS)}\n"
                     f"hmm.model.path={os.path.join(d, 'hmm.txt')}\n")
    launches = 0

    def both(label, verb, inp, out, conf, *extra, k4=False):
        nonlocal launches
        reports, walls = {}, {}
        for dev, d in dirs.items():
            args = [verb, os.path.join(d, inp), os.path.join(d, out),
                    "--conf", os.path.join(work, f"{conf}_{dev}.properties"),
                    *[e.replace("{d}", d) for e in extra], "--device", dev]
            calls = []
            H.pair_counts.launches = 0
            t0 = time.perf_counter()
            with recording(calls):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    if main(args) != 0:
                        raise AssertionError(f"phase 8 {label}: {dev} run "
                                             "failed")
            if dev == "cuda":
                torch.cuda.synchronize()
            walls[dev] = time.perf_counter() - t0
            reports[dev] = buf.getvalue()
            if dev == "cuda":
                count = H.pair_counts.launches
                if k4 and not count:
                    raise AssertionError(f"phase 8 {label}: K4 not launched")
                if count and len(hold_k4_pair_calls(
                        f"phase 8 {label}", calls)) != count:
                    raise AssertionError(f"phase 8 {label}: {count} K4 "
                                         "launches, not all recorded")
                launches += count
        log(f"phase 8 {label}: card {walls['cuda']:.2f} s, CPU "
            f"{walls['cpu']:.2f} s (host clock)")
        return reports

    def same_file(name, reports):
        a, b = (open(os.path.join(d, name), "rb").read()
                for d in dirs.values())
        if a != b or reports["cuda"] != reports["cpu"]:
            raise AssertionError(f"phase 8: {name} or stdout differs between "
                                 "the card and the CPU")

    for streamed in ("false", "true"):
        same_file(f"markov_{streamed}.txt", both(
            f"MarkovStateTransitionModel {MARKOV_CLI_TRAIN} rows "
            f"streaming.train={streamed}", "MarkovStateTransitionModel",
            "markov_train.csv", f"markov_{streamed}.txt", "seq", "-D",
            f"streaming.train={streamed}", k4=True))
    for d in dirs.values():
        shutil.copy(os.path.join(d, "markov_false.txt"),
                    os.path.join(d, "markov.txt"))
    if open(os.path.join(dirs["cuda"], "markov_true.txt")).read() != open(
            os.path.join(dirs["cuda"], "markov_false.txt")).read():
        raise AssertionError("phase 8: the streamed Markov model differs "
                             "from the in-memory one")
    reports = both(f"MarkovModelClassifier {MARKOV_CLI_TEST} rows",
                   "MarkovModelClassifier", "markov_test.csv", "pred.txt",
                   "seq")
    if reports["cuda"] != reports["cpu"]:
        raise AssertionError(f"phase 8 classifier: stdout differs: "
                             f"{reports}")
    lines = {dev: open(os.path.join(d, "pred.txt")).read().splitlines()
             for dev, d in dirs.items()}
    fields = {dev: [line.split(",") for line in rows]
              for dev, rows in lines.items()}
    if [f[:3] for f in fields["cuda"]] != [f[:3] for f in fields["cpu"]]:
        raise AssertionError("phase 8 classifier: ids or labels differ")
    odds = {dev: np.asarray([float(f[3]) for f in rows])
            for dev, rows in fields.items()}
    if not np.allclose(odds["cuda"], odds["cpu"], rtol=ODDS_RTOL, atol=0.0):
        raise AssertionError("phase 8 classifier: log odds beyond rtol "
                             f"{ODDS_RTOL}")
    acc = json.loads(reports["cuda"].splitlines()[-1])["Validation.Accuracy"]
    if acc < MARKOV_ACCURACY_BAR:
        raise AssertionError(f"phase 8 classifier: accuracy {acc} below "
                             f"{MARKOV_ACCURACY_BAR}")
    whole = sum(a == b for a, b in zip(*lines.values()))
    log(f"phase 8 MarkovModelClassifier: ids, labels and Validation JSON "
        f"byte-identical to the CPU's, {whole} of {len(lines['cuda'])} "
        f"lines whole; accuracy {acc:.4f} (bar {MARKOV_ACCURACY_BAR})")
    same_file("hmm.txt", both(
        f"HiddenMarkovModelBuilder {HMM_CLI_ROWS} tagged rows",
        "HiddenMarkovModelBuilder", "tagged.csv", "hmm.txt", "hmm"))
    same_file("paths.txt", both(
        f"ViterbiStatePredictor {HMM_CLI_ROWS} rows",
        "ViterbiStatePredictor", "obs.csv", "paths.txt", "hmm"))
    index = {s: i for i, s in enumerate(G.LOYALTY_STATES)}
    hits = total = 0
    with open(os.path.join(dirs["cuda"], "paths.txt")) as fh:
        for line, srow in zip(fh, state_rows):
            path = line.rstrip("\n").split(",")[1:][::-1]
            hits += sum(index[p] == index[s] for p, s in zip(path, srow))
            total += len(srow)
    acc = hits / total
    if acc < VITERBI_ACCURACY_BAR:
        raise AssertionError(f"phase 8 Viterbi: accuracy {acc} below "
                             f"{VITERBI_ACCURACY_BAR}")
    log(f"phase 8 tagged model and Viterbi paths byte-identical to the "
        f"CPU's; Viterbi accuracy against the planted states {acc:.4f} "
        f"(bar {VITERBI_ACCURACY_BAR})")
    reports = both(f"HiddenMarkovModelBuilder untagged {BW_CLI_ROWS} rows "
                   f"checkpointed", "HiddenMarkovModelBuilder",
                   "untagged.csv", "bw.txt", "hmm", "-D",
                   "training.mode=untagged", "-D", "num.states=3", "-D",
                   f"num.iterations={BW_ITERS}", "-D",
                   "trans.prob.scale=1", "-D",
                   "checkpoint.file.path={d}/bw.npz", "-D",
                   f"iteration.chunk.size={BW_CHUNK}")
    bw = {dev: json.loads(r.splitlines()[-1]) for dev, r in reports.items()}
    ll = [bw[d].pop("BaumWelch.LogLikelihood") for d in ("cuda", "cpu")]
    if bw["cuda"] != bw["cpu"] or abs(ll[0] - ll[1]) > LL_RTOL * abs(ll[1]):
        raise AssertionError(f"phase 8 untagged builder: {bw}, LL {ll}")
    files = {dev: open(os.path.join(d, "bw.txt")).read().splitlines()
             for dev, d in dirs.items()}
    if files["cuda"][:2] != files["cpu"][:2]:
        raise AssertionError("phase 8 untagged builder: states or "
                             "observations differ")
    p_err = max(float(np.abs(np.log([float(v) for v in a.split(",")])
                             - np.log([float(v) for v in b.split(",")]))
                      .max())
                for a, b in zip(files["cuda"][2:], files["cpu"][2:]))
    if p_err > 2 * PARAM_ATOL:
        raise AssertionError(f"phase 8 untagged builder: model file "
                             f"probabilities {p_err} apart in log space")
    log(f"phase 8 untagged builder: {bw['cuda']} on both, LL {ll[0]!r} "
        f"against {ll[1]!r}; model files within {p_err:.3g} in log space "
        "(six printed digits)")
    return launches


def sequence_phase(dev, work):
    """Phase 8; returns K4's kernels-line entry at the Markov shape."""
    launches, k4 = markov_at_scale(dev)
    viterbi_at_scale(dev)
    baum_welch_phase(dev, work)
    cli_launches = sequence_cli_jobs(work)
    return {"name": "pair_counts (K4) at the Markov shape (class-conditional "
                    "transitions: a = class·S + src, b = dst)",
            "route": "cuda", "source": "avenir_tpu_torch/csrc/hist.cu",
            "replaces": "avenir_tpu/ops/pallas_histogram.py:133",
            "launches": launches, "cli_launches": cli_launches,
            "max_abs_err": 0.0,
            **{key: k4[key] for key in ("ms", "graph_ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms",
                                        "shape")}}


# --------------------------------------------------------------------------
# phase 9: forests and bandits
# --------------------------------------------------------------------------

# the forest tutorial (docs/TUTORIALS.md "Training forests at scale") on the
# tree workload's 1,048,576 retarget rows, and hospital rows tiled alike
FOREST_TREES, FOREST_SET, FOREST_DEPTH, FOREST_SEED = 50, 3, 6, 7
HOSP_FOREST_TREES = 16
FOREST_CPU_ROWS = 65_536
# streamed growth: 8 part files of retarget rows
STREAM_PARTS, STREAM_PART_ROWS, STREAM_TREES = 8, 16_384, 10
# the CLI jobs: retarget rows, and the price tutorial's groups
FOREST_TRAIN, FOREST_TEST = 200_000, 50_000
CLI_FOREST_TREES = 10
BANDIT_GROUPS = 100
# the planted rule caps a tree near 0.725 and the majority class reads
# ~0.54; a tree of random.split.set.size=2 sees only one of the rule's two
# attributes a time in three, so the ten trees' vote reads ~0.69-0.72
FOREST_ACCURACY_BAR = 0.65


def hosp_big_table(dev):
    """1,048,576 hospital rows on ``dev``: 4,096 rows featurized, then
    tiled as ``retarget_big_table`` tiles its rows."""
    import dataclasses
    from avenir_tpu_torch.datagen import hosp_readmit_rows, hosp_readmit_schema
    from avenir_tpu_torch.utils.dataset import Featurizer
    base = hosp_readmit_rows(TREE_BASE_ROWS, seed=1)
    table = Featurizer(hosp_readmit_schema(), device=dev).fit(base) \
        .transform(base)
    return dataclasses.replace(
        table, binned=table.binned.repeat(TREE_REPS, 1),
        numeric=table.numeric.repeat(TREE_REPS, 1),
        labels=table.labels.repeat(TREE_REPS), ids=[],
        n_rows=table.n_rows * TREE_REPS)


def rows_of(table, n, dev):
    """The first ``n`` rows of ``table`` on ``dev``."""
    import dataclasses
    return dataclasses.replace(
        table, binned=table.binned[:n].to(dev),
        numeric=table.numeric[:n].to(dev), labels=table.labels[:n].to(dev),
        ids=[], n_rows=n)


def forest_config(n_trees, growth="auto", bagging=True, depth=FOREST_DEPTH):
    from avenir_tpu_torch.models import forest as F
    from avenir_tpu_torch.models import tree as T
    return F.ForestConfig(n_trees=n_trees, attrs_per_tree=FOREST_SET,
                          bagging=bagging, seed=FOREST_SEED, growth=growth,
                          tree=T.TreeConfig(max_depth=depth))


def canon(trees):
    from avenir_tpu_torch.models import tree as T
    return [T.canonical_tree(t) for t in trees]


def forest_k1_launches(table, cfg):
    """K1 launches a batched forest makes: one for each tree and chunk of
    nodes of each level; none for padding."""
    from avenir_tpu_torch.models import tree as T
    from avenir_tpu_torch.ops import histogram as hg
    splittable = sorted(T.splittable_ordinals(table))
    cand = T._device_candidates(table, T._attr_plans(
        table, splittable, cfg.tree.max_cat_attr_split_groups))
    chunk = max(1, hg._NODE_CHUNK_CB // cand.b_max)
    widths = T._level_widths(cfg.tree.max_depth, cand.s_max,
                             cfg.tree.device_node_budget)
    return cfg.n_trees * sum(-(-w // chunk) for w in widths)


def forest_growth(table, cfg):
    """The batched growth without its bootstrap draws: a callable that
    grows the forest of ``cfg`` from its plans, drawn here once."""
    from avenir_tpu_torch.models import forest as F
    splittable = F._validate_forest_config(table, cfg)
    plans = F._draw_tree_plans(np.random.default_rng(cfg.seed), splittable,
                               cfg, table.n_rows)
    return lambda: F._grow_drawn(table, cfg, splittable, plans)


def forest_at_scale(dev, label, table, n_trees):
    """One forest on ``table`` (1,048,576 rows): grown by ``grow_forest``
    (auto: batched) with every K1 launch recorded and held exactly
    against its plain version, their count equal to one for each real
    tree and chunk of nodes; then the bootstrap draws alone, the batched
    growth from the drawn plans and the serial growth each timed (host
    clock), both forests equal to the recorded one tree by tree, and the
    batched growth under ``torch.profiler``. Returns (trees, launches,
    the recorded operands by K1 shape)."""
    from avenir_tpu_torch.models import forest as F
    from avenir_tpu_torch.ops import cuda_histogram as H
    cfg = forest_config(n_trees)
    calls = []
    H.class_feature_bin_counts.launches = 0
    with recording(calls):
        trees = F.grow_forest(table, cfg)
    torch.cuda.synchronize()
    count = H.class_feature_bin_counts.launches
    held, _ = hold_k1_calls(f"phase 9 {label}", calls)
    expected = forest_k1_launches(table, cfg)
    if held != count or count != expected:
        raise AssertionError(f"phase 9 {label}: {count} K1 launches, "
                             f"{held} recorded, {expected} expected")
    by_shape = {}
    for _, a, _ in calls:
        by_shape.setdefault((a["n_bins"], tuple(a["bins"].shape)), a)
    del calls
    splittable = F._validate_forest_config(table, cfg)
    t0 = time.perf_counter()
    F._draw_tree_plans(np.random.default_rng(cfg.seed), splittable, cfg,
                       table.n_rows)
    draw_s = time.perf_counter() - t0
    serial_ms, serial = host_ms(lambda: F._grow_forest_serial(table, cfg))
    growth = forest_growth(table, cfg)
    growth_ms, grown = host_ms(growth)
    if not canon(trees) == canon(grown) == canon(serial):
        raise AssertionError(f"phase 9 {label}: the batched and serial "
                             "forests differ on the card")
    log(f"phase 9 {label}: {n_trees} trees, random.split.set.size="
        f"{FOREST_SET}, depth {FOREST_DEPTH}, bagging, seed {FOREST_SEED}, "
        f"{table.n_rows} rows: {count} K1 launches (one for each tree and "
        f"chunk of nodes), each exact against plain; batched equals serial "
        f"tree by tree; bootstrap draws {draw_s:.3f} s (host numpy), "
        f"batched growth {growth_ms / 1e3:.3f} s (from the drawn plans), "
        f"serial {serial_ms / 1e3:.3f} s (growth "
        f"{serial_ms / 1e3 - draw_s:.3f} s), host clock; depths "
        f"{sorted(collections.Counter(max_depth(t) for t in trees).items())}"
        f", root attrs {sorted(collections.Counter(t.attr_ordinal for t in trees).items())}")
    profile_ops(f"phase 9 {label} batched growth from drawn plans",
                growth)
    return trees, count, by_shape


def forest_card_vs_cpu(label, table, n_trees):
    """The same forest config grown on the first FOREST_CPU_ROWS rows on
    the card and on the CPU: equal tree by tree."""
    from avenir_tpu_torch.models import forest as F
    cfg = forest_config(n_trees)
    card_ms, card = host_ms(lambda: F.grow_forest(
        rows_of(table, FOREST_CPU_ROWS, table.binned.device), cfg))
    t0 = time.perf_counter()
    cpu = F.grow_forest(rows_of(table, FOREST_CPU_ROWS, "cpu"), cfg)
    cpu_s = time.perf_counter() - t0
    if canon(card) != canon(cpu):
        raise AssertionError(f"phase 9 {label}: the card's forest on "
                             f"{FOREST_CPU_ROWS} rows differs from the CPU's")
    log(f"phase 9 {label} on {FOREST_CPU_ROWS} rows: equal to the CPU's "
        f"tree by tree (card {card_ms / 1e3:.3f} s, CPU {cpu_s:.2f} s)")


def forest_prediction(trees, table):
    """The stacked device vote on every row, timed, against the host walk
    on the first FOREST_CPU_ROWS rows."""
    from avenir_tpu_torch.models import forest as F
    F.predict_forest(trees, rows_of(table, 4096, table.binned.device),
                     device=True)
    vote_ms, pred = host_ms(lambda: F.predict_forest(trees, table,
                                                     device=True))
    t0 = time.perf_counter()
    walk = F.predict_forest(trees, rows_of(table, FOREST_CPU_ROWS, "cpu"))
    walk_s = time.perf_counter() - t0
    if not np.array_equal(pred[:FOREST_CPU_ROWS], walk):
        raise AssertionError("phase 9: the device vote differs from the "
                             "host walk")
    truth = table.labels.cpu().numpy()
    log(f"phase 9 predict_forest: the device vote of {len(trees)} trees on "
        f"{table.n_rows} rows {vote_ms:.1f} ms (host clock), equal to the "
        f"host walk on {FOREST_CPU_ROWS} rows ({walk_s:.2f} s on the CPU); "
        f"training accuracy {(pred == truth).mean():.4f}")


def forest_streamed(dev, work):
    """``grow_forest_streaming`` over STREAM_PARTS part files of
    STREAM_PART_ROWS retarget rows: without bagging equal to
    ``grow_forest_batched`` over the same rows, with bagging equal to the
    CPU's streamed forest; every K1 launch of the card's runs held.
    Returns K1's launches."""
    from avenir_tpu_torch.datagen import retarget_rows, retarget_schema
    from avenir_tpu_torch.models import forest as F
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.utils.dataset import Featurizer
    rows = retarget_rows(STREAM_PARTS * STREAM_PART_ROWS, seed=SEED + 9)
    d = os.path.join(work, "stream")
    os.makedirs(d)
    paths = []
    for i in range(STREAM_PARTS):
        paths.append(os.path.join(d, f"part-{i:05d}"))
        write_csv(paths[-1], rows[i * STREAM_PART_ROWS:
                                  (i + 1) * STREAM_PART_ROWS])
    fz = Featurizer(retarget_schema(), device=dev).fit(rows)
    fz_cpu = Featurizer(retarget_schema(), device="cpu").fit(rows)
    launches, notes = 0, []
    for bagging in (False, True):
        cfg = forest_config(STREAM_TREES, bagging=bagging)
        calls = []
        H.class_feature_bin_counts.launches = 0
        t0 = time.perf_counter()
        with recording(calls):
            streamed = F.grow_forest_streaming(fz, paths, cfg)
        card_s = time.perf_counter() - t0
        count = H.class_feature_bin_counts.launches
        held, _ = hold_k1_calls(f"phase 9 streamed bagging={bagging}", calls)
        if held != count:
            raise AssertionError(f"phase 9 streamed: {count} K1 launches, "
                                 f"{held} recorded")
        del calls
        launches += count
        if bagging:
            t0 = time.perf_counter()
            want = F.grow_forest_streaming(fz_cpu, paths, cfg)
            ref_s, ref = time.perf_counter() - t0, "the CPU's streamed"
        else:
            t0 = time.perf_counter()
            want = F.grow_forest_batched(fz.transform(rows), cfg)
            ref_s, ref = time.perf_counter() - t0, "in-core batched"
        if canon(streamed) != canon(want):
            raise AssertionError(f"phase 9 streamed bagging={bagging}: "
                                 f"differs from {ref} growth")
        notes.append(f"bagging={str(bagging).lower()} equal to {ref} growth "
                     f"({card_s:.2f} s, {count} K1 launches; reference "
                     f"{ref_s:.2f} s)")
    log(f"phase 9 grow_forest_streaming, {STREAM_TREES} trees over "
        f"{STREAM_PARTS} part files of {STREAM_PART_ROWS} rows: "
        + "; ".join(notes))
    return launches


def forest_cli_jobs(work):
    """RandomForestBuilder and RandomForestPredictor (validation, host walk
    and device vote) on FOREST_TRAIN / FOREST_TEST retarget rows, and the
    four bandit verbs on a round of BANDIT_GROUPS price-optimization
    groups with ``group.item.count.path``, each on the card and with
    ``--device cpu`` in a directory of its own: every file and stdout line
    equal, RandomForestBuilder's K1 launches held, the bandits launching
    nothing.
    Returns K1's launches."""
    from avenir_tpu_torch.datagen import price_opt_arms, retarget_rows
    from avenir_tpu_torch.datagen.generators import _RETARGET_SCHEMA_JSON
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.cli.main import main
    rows = retarget_rows(FOREST_TRAIN + FOREST_TEST, seed=SEED + 10)
    rng = np.random.default_rng(SEED + 11)
    round_rows, sizes = [], []
    for g, (arms, expect) in price_opt_arms(n_groups=BANDIT_GROUPS,
                                            seed=11).items():
        for arm, reward in zip(arms, expect):
            count = int(rng.integers(0, 4))
            round_rows.append([g, arm, str(count),
                               str(int(reward) if count else 0)])
        sizes.append([g, str(int(rng.integers(1, 4)))])
    schema = os.path.join(work, "retarget.json")
    with open(schema, "w") as fh:
        json.dump(_RETARGET_SCHEMA_JSON, fh)
    dirs = {dev: os.path.join(work, f"forest_{dev}")
            for dev in ("cuda", "cpu")}
    for dev, d in dirs.items():
        os.makedirs(d)
        write_csv(os.path.join(d, "train.csv"), rows[:FOREST_TRAIN])
        write_csv(os.path.join(d, "test.csv"), rows[FOREST_TRAIN:])
        write_csv(os.path.join(d, "round.csv"), round_rows)
        write_csv(os.path.join(d, "sizes.csv"), sizes[::2])
        with open(os.path.join(work, f"forest_{dev}.properties"), "w") as fh:
            fh.write(f"feature.schema.file.path={schema}\n"
                     "field.delim.regex=,\nfield.delim.out=;\n"
                     "field.delim=,\n"
                     f"forest.model.file.path={os.path.join(d, 'forest.json')}"
                     f"\npositive.class.value=yes\nmax.depth=4\n"
                     f"num.trees={CLI_FOREST_TREES}\nrandom.split.set.size=2\n"
                     f"random.seed={FOREST_SEED}\nbatch.size=2\n"
                     "current.round.num=3\n"
                     f"group.item.count.path={os.path.join(d, 'sizes.csv')}\n")
    launches = 0

    def both(label, verb, inp, out, *extra, k1=None):
        nonlocal launches
        reports, walls = {}, {}
        for dev, d in dirs.items():
            args = [verb, os.path.join(d, inp), os.path.join(d, out),
                    "--conf", os.path.join(work, f"forest_{dev}.properties"),
                    *extra, "--device", dev]
            calls = []
            H.class_feature_bin_counts.launches = 0
            t0 = time.perf_counter()
            with recording(calls):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    if main(args) != 0:
                        raise AssertionError(f"phase 9 {label}: {dev} run "
                                             "failed")
            if dev == "cuda":
                torch.cuda.synchronize()
            walls[dev] = time.perf_counter() - t0
            reports[dev] = buf.getvalue()
            if dev == "cuda":
                count = H.class_feature_bin_counts.launches
                if k1 is not None and bool(count) != k1:
                    raise AssertionError(f"phase 9 {label}: {count} K1 "
                                         "launches")
                if count:
                    held, _ = hold_k1_calls(f"phase 9 {label}", calls)
                    if held != count:
                        raise AssertionError(f"phase 9 {label}: {count} K1 "
                                             f"launches, {held} recorded")
                launches += count
        if reports["cuda"] != reports["cpu"]:
            raise AssertionError(f"phase 9 {label}: stdout differs: "
                                 f"{reports}")
        names, differ = same_files(dirs["cuda"], dirs["cpu"])
        if differ:
            raise AssertionError(f"phase 9 {label}: files differ between "
                                 f"the card and the CPU: {differ[:10]}")
        log(f"phase 9 {label}: card {walls['cuda']:.2f} s, CPU "
            f"{walls['cpu']:.2f} s (host clock); {len(names)} files "
            "byte-identical to the CPU's")
        lines = [line for line in reports["cuda"].splitlines() if line]
        return json.loads(lines[-1]) if lines else {}

    built = both(f"RandomForestBuilder {FOREST_TRAIN} rows num.trees="
                 f"{CLI_FOREST_TREES}", "RandomForestBuilder", "train.csv",
                 "forest.json", k1=True)
    if built["Forest.Trees"] != CLI_FOREST_TREES:
        raise AssertionError(f"phase 9: {built}")
    for on_device in ("false", "true"):
        report = both(f"RandomForestPredictor {FOREST_TEST} rows "
                      f"device.predict={on_device}", "RandomForestPredictor",
                      "test.csv", f"pred_{on_device}.txt", "-D",
                      "validation.mode=true", "-D",
                      f"device.predict={on_device}", k1=False)
        acc = report["Validation.Accuracy"]
        if acc < FOREST_ACCURACY_BAR:
            raise AssertionError(f"phase 9: forest accuracy {acc} below "
                                 f"{FOREST_ACCURACY_BAR}")
    log(f"phase 9 forest planted rule: validation accuracy {acc:.4f} (bar "
        f"{FOREST_ACCURACY_BAR})")
    for verb in ("GreedyRandomBandit", "AuerDeterministic", "SoftMaxBandit",
                 "RandomFirstGreedyBandit"):
        both(f"{verb} {BANDIT_GROUPS} groups", verb, "round.csv",
             f"{verb}.txt", k1=False)
    return launches


def forest_phase(dev, work):
    """Phase 9; returns K1's kernels-line entry at the forest shape."""
    tables = {"retarget": retarget_big_table(dev),
              "hospital": hosp_big_table(dev)}
    launches, by_shape = 0, {}
    trees = None
    for (name, table), n_trees in zip(tables.items(),
                                      (FOREST_TREES, HOSP_FOREST_TREES)):
        grown, count, shapes = forest_at_scale(dev, f"{name} forest", table,
                                               n_trees)
        launches += count
        by_shape.update(shapes)
        trees = grown if trees is None else trees
        forest_card_vs_cpu(f"{name} forest", table, n_trees)
    forest_prediction(trees, tables["retarget"])
    del tables
    timings = []
    for (b, _), a in sorted(by_shape.items()):
        k1 = time_k1_weighted(dev, a)
        timings.append(k1)
        log(f"phase 9 K1 at {k1['shape']}: {k1['ms']:.4f} ms chained, "
            f"{k1['graph_ms']:.4f} ms from graph replays reading HBM "
            f"({k1['bound_ms'] / k1['graph_ms']:.1%} of bound), plain "
            f"{k1['plain_ms']:.4f} ms, bincount {k1['library_ms']:.4f} ms, "
            f"bound {k1['bound_ms']:.4f} ms ({k1['bound_by']})")
    del by_shape
    stream_launches = forest_streamed(dev, work)
    cli_launches = forest_cli_jobs(work)
    widest = max(timings, key=lambda k: k["bound_ms"])
    return {"name": "cfb_counts (K1-forest) at the forest shape (each "
                    "tree's level histogram, bootstrap-weighted)",
            "route": "cuda", "source": "avenir_tpu_torch/csrc/hist.cu",
            "replaces": "avenir_tpu/ops/pallas_histogram.py:57",
            "launches": launches, "stream_launches": stream_launches,
            "cli_launches": cli_launches, "max_abs_err": 0.0,
            **{key: widest[key] for key in ("ms", "graph_ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms", "shape")},
            "levels": [{key: k[key] for key in (
                "shape", "ms", "graph_ms", "plain_ms", "library_ms",
                "bound_ms")} for k in timings]}


# --------------------------------------------------------------------------
# phase 10: gradient boosting
# --------------------------------------------------------------------------

# (rounds, depth): the churn tutorial's 8 rounds at depth 3, and deeper
BOOST_RUNS = ((8, 3), (10, 6))
BOOST_LEARNING_RATE = 0.3
BOOST_ACCURACY_BAR = 0.65
BOOST_MARGIN_ATOL = 1e-5
# a CLI job whose holdout decides the rounds kept (as tests/test_torch_boost
# stops early)
BOOST_EARLY_STOP = ("-D", "forest.boost.num.rounds=30", "-D",
                    "forest.boost.learning.rate=0.9", "-D",
                    "forest.boost.early.stop.rounds=2")


def boost_config(rounds, depth):
    from avenir_tpu_torch.models import boost as B
    from avenir_tpu_torch.models.tree import TreeConfig
    return B.BoostConfig(n_rounds=rounds, learning_rate=BOOST_LEARNING_RATE,
                         tree=TreeConfig(max_depth=depth))


def boost_k1_launches(table, cfg):
    """K1's integer-mode launches of a boosted fit: two for each chunk of
    nodes of every level of every round (one launch a chunk's rows while
    N · 2^10 < 2^31)."""
    from avenir_tpu_torch.models import boost as B
    from avenir_tpu_torch.models import tree as T
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.ops import histogram as hg
    _, cand = B.build_boost_catalog(table, cfg.tree)
    chunk = max(1, hg._NODE_CHUNK_CB // cand.b_max)
    splits = math.ceil(table.n_rows / H.rows_per_launch(B._Q))
    widths = T._level_widths(cfg.tree.max_depth, cand.s_max,
                             cfg.tree.device_node_budget)
    return cfg.n_rounds * sum(2 * splits * math.ceil(w / chunk)
                              for w in widths)


def boost_artifact(model, path):
    from avenir_tpu_torch.models import boost as B
    B.save_boosted(model, path)
    with open(path, "rb") as fh:
        return fh.read()


def boost_at_scale(dev, work, table, cpu_table):
    """Each BOOST_RUNS config on ``table`` (1,048,576 rows) on the card,
    every K1 launch (integer mode) recorded and held exactly against its
    plain version, their count the expected one; the same config on the
    CPU: trees with their leaf values and the artifact bytes equal.
    Returns (the last model, launches, the recorded operands by K1
    shape)."""
    from avenir_tpu_torch.models import boost as B
    from avenir_tpu_torch.models import tree as T
    from avenir_tpu_torch.ops import cuda_histogram as H
    launches, by_shape, model = 0, {}, None
    for rounds, depth in BOOST_RUNS:
        cfg = boost_config(rounds, depth)
        label = f"phase 10 {rounds} rounds at depth {depth}"
        calls = []
        H.class_feature_bin_sums.launches = 0
        t0 = time.perf_counter()
        with recording(calls):
            model = B.grow_boosted(table, cfg)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        count = H.class_feature_bin_sums.launches
        held, _ = hold_k1_calls(label, calls, "K1-int")
        expected = boost_k1_launches(table, cfg)
        if held != count or count != expected:
            raise AssertionError(f"{label}: {count} K1 integer-mode "
                                 f"launches, {held} recorded, {expected} "
                                 "expected")
        for name, a, _ in calls:
            if name == "K1-int":
                by_shape.setdefault((a["n_bins"], a["n_classes"]), a)
        del calls
        launches += count
        t0 = time.perf_counter()
        cpu_model = B.grow_boosted(cpu_table, cfg)
        cpu_s = time.perf_counter() - t0
        depths = [max_depth(t) for t in model.trees]
        card_trees = [T.canonical_tree(t, with_values=True)
                      for t in model.trees]
        cpu_trees = [T.canonical_tree(t, with_values=True)
                     for t in cpu_model.trees]
        if card_trees != cpu_trees:
            raise AssertionError(f"{label}: the card's trees or leaf values "
                                 "differ from the CPU's")
        card_bytes = boost_artifact(model, os.path.join(work, "card.json"))
        if card_bytes != boost_artifact(cpu_model,
                                        os.path.join(work, "cpu.json")):
            raise AssertionError(f"{label}: the card's artifact differs from "
                                 "the CPU's")
        log(f"{label} on {table.n_rows} rows (learning rate "
            f"{BOOST_LEARNING_RATE}): {count} K1 integer-mode launches, "
            f"each exact against plain; trees, leaf values and the "
            f"{len(card_bytes)}-byte artifact equal to the CPU's; card "
            f"{card_s:.3f} s, CPU {cpu_s:.2f} s (host clock); depths "
            f"{sorted(collections.Counter(depths).items())}")
    return model, launches, by_shape


def boost_round(table, rounds, depth):
    """One boosting round at ``depth`` from the base score, timed (host
    clock, synchronized, after one warm-up round) and under
    ``torch.profiler``."""
    from avenir_tpu_torch.models import boost as B
    cfg = boost_config(rounds, depth)
    _, cand = B.build_boost_catalog(table, cfg.tree)
    dev = table.binned.device
    ones = torch.ones(table.n_rows, device=dev)
    score = torch.zeros(table.n_rows, device=dev)
    reg = torch.tensor(1.0, device=dev)
    lr = torch.tensor(np.float32(BOOST_LEARNING_RATE), device=dev)

    def one_round():
        return B._boost_round(
            [(cand, table.labels, ones, ones, score)], cand, reg, lr,
            depth=depth,
            n_classes=table.n_classes, algorithm=cfg.tree.algorithm,
            min_node_size=cfg.tree.min_node_size,
            min_gain=cfg.tree.min_gain,
            node_budget=cfg.tree.device_node_budget)
    one_round()
    ms = min(host_ms(one_round)[0] for _ in range(3))
    log(f"phase 10 a round at depth {depth} on {table.n_rows} rows: "
        f"{ms:.2f} ms (host clock, best of 3)")
    profile_ops(f"phase 10 a round at depth {depth}", one_round)
    return ms


def boost_margins(model, table):
    """Device margins of every row against the host walk: within
    BOOST_MARGIN_ATOL and the same classes."""
    dev_ms, device = host_ms(lambda: model.margins(table, device=True))
    t0 = time.perf_counter()
    host = model.margins(table)
    host_s = time.perf_counter() - t0
    err = float(np.abs(device - host).max())
    if err > BOOST_MARGIN_ATOL or not np.array_equal(device > 0, host > 0):
        raise AssertionError(f"phase 10 margins: device against host walk "
                             f"max |diff| {err}, classes "
                             f"{int(((device > 0) != (host > 0)).sum())} "
                             "apart")
    truth = table.labels.cpu().numpy()
    log(f"phase 10 margins of {len(model.trees)} trees on {table.n_rows} "
        f"rows: device {dev_ms:.1f} ms, host walk {host_s:.2f} s (host "
        f"clock); max |diff| {err:.3g} (atol {BOOST_MARGIN_ATOL}), classes "
        f"equal; training accuracy {((host > 0) == truth).mean():.4f}")


def time_k1_int(dev, a):
    """K1's integer mode on recorded operands: chained, from graph replays
    reading HBM, plain, the library call (``bincount`` of the weights over
    the same combined ids, built beforehand) and the bytes bound (ids and
    weights read once, labels too where C > 1, the int32 sums written
    once)."""
    from avenir_tpu_torch.models.boost import _Q
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.scripts._timing import chain_ms
    bins, labels, w = a["bins"], a["labels"], a["weights"]
    c, b = a["n_classes"], a["n_bins"]
    n, f = bins.shape
    cells = f * c * b
    in_bytes = n * (f + (2 if c > 1 else 1)) * 4
    ms = chain_ms(lambda: H.class_feature_bin_sums(bins, labels, c, b, w,
                                                   _Q), dev)
    graph = hbm_graph_ms(
        lambda u, v, x: H.class_feature_bin_sums(u, v, c, b, x, _Q),
        (bins, labels, w), in_bytes, dev)
    plain = cuda_ms(lambda: H.class_feature_bin_sums_plain(
        bins, labels, c, b, w), 5)
    ids = bins.long()
    flat = (torch.arange(f, device=dev)[None, :] * (c * b)
            + labels.long()[:, None] * b + ids)
    flat = torch.where(ids >= 0, flat, cells).reshape(-1)   # -1: a spare cell
    wide = w.double().reshape(n, 1).expand(n, f).reshape(-1).contiguous()
    library = cuda_ms(lambda: torch.bincount(flat, weights=wide,
                                             minlength=cells + 1), 20)
    bound, by = bound_ms(in_bytes + cells * 4, n * f)
    return {"ms": ms, "graph_ms": graph, "plain_ms": plain,
            "library_ms": library, "bound_ms": bound, "bound_by": by,
            "shape": f"N={n} F={f} C={c} B={b} integer"}


def check_k1_int_split(dev, a):
    """K1's integer mode split across launches on the card, held exactly
    against its plain version with the launches counted: one recorded
    level's operands under a weight bound of 2^12 (three launches at
    1,048,576 rows, the last of two rows); and 2^21 + 2^20 rows of weight
    ±2^10 with one cell past 2^31, which the wrapper's bound of 2^10 splits
    into two launches whose int32 sums add in int64."""
    from avenir_tpu_torch.models.boost import _Q
    from avenir_tpu_torch.ops import cuda_histogram as H
    n = (1 << 21) + (1 << 20)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    labels = (torch.rand(n, generator=gen, device=dev) < 0.1).to(torch.int32)
    bins = torch.stack([torch.zeros(n, dtype=torch.int32, device=dev),
                        torch.randint(-1, 9, (n,), generator=gen,
                                      dtype=torch.int32, device=dev)], 1)
    w = torch.where(labels == 0, _Q, -_Q).to(torch.float32)
    cases = ((a["bins"], a["labels"], a["n_classes"], a["n_bins"],
              a["weights"], 2.0 ** 12), (bins, labels, 2, 8, w, _Q))
    for bins, labels, c, b, w, bound in cases:
        expected = math.ceil(bins.shape[0] / H.rows_per_launch(bound))
        H.class_feature_bin_sums.launches = 0
        got = H.class_feature_bin_sums(bins, labels, c, b, w, bound)
        count = H.class_feature_bin_sums.launches
        want = H.class_feature_bin_sums_plain(bins, labels, c, b, w)
        equal = torch.equal(got, want)
        if count != expected or count < 2 or not equal:
            raise AssertionError(
                f"phase 10 K1 integer mode split over {count} launches "
                f"({expected} expected) on {bins.shape[0]} rows, weights "
                f"up to {bound}: equal to plain {equal}")
        log(f"phase 10 K1 integer mode split: {bins.shape[0]} rows, "
            f"weights up to {bound:g}, {count} launches, equal to plain "
            f"(largest |cell| {int(want.abs().max())})")
    if int(want.max()) < H.INT_SUM_LIMIT:
        raise AssertionError("phase 10 K1 integer mode split: no cell past "
                             "2^31")


def boost_streamed(dev, work):
    """``grow_boosted_streaming`` over STREAM_PARTS part files of
    STREAM_PART_ROWS retarget rows against ``grow_boosted`` over the same
    rows on the card: the artifacts byte for byte; every K1 launch of the
    streamed run held. Returns its K1 launches."""
    from avenir_tpu_torch.datagen import retarget_rows, retarget_schema
    from avenir_tpu_torch.models import boost as B
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.utils.dataset import Featurizer
    rows = retarget_rows(STREAM_PARTS * STREAM_PART_ROWS, seed=SEED + 12)
    d = os.path.join(work, "boost_stream")
    os.makedirs(d)
    paths = []
    for i in range(STREAM_PARTS):
        paths.append(os.path.join(d, f"part-{i:05d}"))
        write_csv(paths[-1], rows[i * STREAM_PART_ROWS:
                                  (i + 1) * STREAM_PART_ROWS])
    fz = Featurizer(retarget_schema(), device=dev).fit(rows)
    rounds, depth = BOOST_RUNS[0]
    cfg = boost_config(rounds, depth)
    calls = []
    H.class_feature_bin_sums.launches = 0
    t0 = time.perf_counter()
    with recording(calls):
        streamed = B.grow_boosted_streaming(fz, paths, cfg)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    count = H.class_feature_bin_sums.launches
    held, _ = hold_k1_calls("phase 10 streamed", calls, "K1-int")
    if held != count:
        raise AssertionError(f"phase 10 streamed: {count} K1 launches, "
                             f"{held} recorded")
    del calls
    t0 = time.perf_counter()
    incore = B.grow_boosted(fz.transform(rows), cfg)
    incore_s = time.perf_counter() - t0
    got = boost_artifact(streamed, os.path.join(d, "streamed.json"))
    if got != boost_artifact(incore, os.path.join(d, "incore.json")):
        raise AssertionError("phase 10 streamed: the artifact differs from "
                             "in-core growth over the same rows")
    log(f"phase 10 grow_boosted_streaming, {rounds} rounds at depth {depth} "
        f"over {STREAM_PARTS} part files of {STREAM_PART_ROWS} rows: "
        f"artifact byte-identical to in-core growth ({stream_s:.2f} s, "
        f"{count} K1 launches, each exact; in-core {incore_s:.2f} s, host "
        "clock)")
    return count


def boost_cli_jobs(work):
    """GradientBoostBuilder (in core, early-stopped, and streamed over part
    files) and GradientBoostPredictor (validation, host walk and device route) on
    TREE_TRAIN / TREE_TEST retarget rows, each on the card and with
    ``--device cpu`` in a directory of its own: every file and stdout
    line equal, the builders' K1 launches held. Returns K1's launches."""
    from avenir_tpu_torch.cli.main import main
    from avenir_tpu_torch.datagen import retarget_rows
    from avenir_tpu_torch.datagen.generators import _RETARGET_SCHEMA_JSON
    from avenir_tpu_torch.ops import cuda_histogram as H
    rows = retarget_rows(TREE_TRAIN + TREE_TEST, seed=SEED + 13)
    schema = os.path.join(work, "boost_schema.json")
    with open(schema, "w") as fh:
        json.dump(_RETARGET_SCHEMA_JSON, fh)
    dirs = {dev: os.path.join(work, f"boost_{dev}") for dev in ("cuda", "cpu")}
    rounds, depth = BOOST_RUNS[0]
    part = TREE_TRAIN // STREAM_PARTS
    for dev, d in dirs.items():
        os.makedirs(os.path.join(d, "parts"))
        write_csv(os.path.join(d, "train.csv"), rows[:TREE_TRAIN])
        write_csv(os.path.join(d, "test.csv"), rows[TREE_TRAIN:])
        for i in range(STREAM_PARTS):
            write_csv(os.path.join(d, "parts", f"part-{i:05d}"),
                      rows[i * part:(i + 1) * part])
        with open(os.path.join(work, f"boost_{dev}.properties"), "w") as fh:
            fh.write(f"feature.schema.file.path={schema}\n"
                     "field.delim.regex=,\nfield.delim.out=;\n"
                     "forest.boost.model.file.path="
                     f"{os.path.join(d, 'boost.json')}\n"
                     "featurizer.fit.data.path="
                     f"{os.path.join(d, 'train.csv')}\n"
                     f"positive.class.value=yes\nmax.depth={depth}\n"
                     f"forest.boost.num.rounds={rounds}\n"
                     f"forest.boost.learning.rate={BOOST_LEARNING_RATE}\n")
    launches = 0

    def both(label, verb, inp, out, *extra, k1):
        nonlocal launches
        reports, walls = {}, {}
        for dev, d in dirs.items():
            args = [verb, os.path.join(d, inp), os.path.join(d, out),
                    "--conf", os.path.join(work, f"boost_{dev}.properties"),
                    *extra, "--device", dev]
            calls = []
            H.class_feature_bin_sums.launches = 0
            t0 = time.perf_counter()
            with recording(calls):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    if main(args) != 0:
                        raise AssertionError(f"phase 10 {label}: {dev} run "
                                             "failed")
            if dev == "cuda":
                torch.cuda.synchronize()
                count = H.class_feature_bin_sums.launches
                if bool(count) != k1:
                    raise AssertionError(f"phase 10 {label}: {count} K1 "
                                         "launches")
                if count:
                    held, _ = hold_k1_calls(f"phase 10 {label}", calls,
                                            "K1-int")
                    if held != count:
                        raise AssertionError(f"phase 10 {label}: {count} "
                                             f"K1 launches, {held} recorded")
                launches += count
            walls[dev] = time.perf_counter() - t0
            reports[dev] = buf.getvalue()
        if reports["cuda"] != reports["cpu"]:
            raise AssertionError(f"phase 10 {label}: stdout differs: "
                                 f"{reports}")
        names, differ = same_files(dirs["cuda"], dirs["cpu"])
        if differ:
            raise AssertionError(f"phase 10 {label}: files differ between "
                                 f"the card and the CPU: {differ[:10]}")
        log(f"phase 10 {label}: card {walls['cuda']:.2f} s, CPU "
            f"{walls['cpu']:.2f} s (host clock); {len(names)} files "
            "byte-identical to the CPU's")
        lines = [line for line in reports["cuda"].splitlines() if line]
        return json.loads(lines[-1]) if lines else {}

    built = both(f"GradientBoostBuilder {TREE_TRAIN} rows",
                 "GradientBoostBuilder", "train.csv", "boost.json", k1=True)
    if built["Boost.Rounds"] != rounds:
        raise AssertionError(f"phase 10: {built}")
    stopped = both(f"GradientBoostBuilder {TREE_TRAIN} rows with early "
                   "stopping", "GradientBoostBuilder", "train.csv",
                   "early.json", *BOOST_EARLY_STOP, k1=True)
    log(f"phase 10 early stopping: {stopped['Boost.Rounds']} of "
        f"{BOOST_EARLY_STOP[1].split('=')[1]} rounds kept, the same on the "
        "card and the CPU")
    both(f"GradientBoostBuilder streaming.train over {STREAM_PARTS} part "
         "files", "GradientBoostBuilder", "parts", "streamed.json", "-D",
         "streaming.train=true", k1=True)
    for d in dirs.values():
        with open(os.path.join(d, "boost.json"), "rb") as fh, \
                open(os.path.join(d, "streamed.json"), "rb") as gh:
            if fh.read() != gh.read():
                raise AssertionError("phase 10: the streamed CLI artifact "
                                     "differs from the in-core one")
    for on_device in ("false", "true"):
        report = both(f"GradientBoostPredictor {TREE_TEST} rows "
                      f"device.predict={on_device}",
                      "GradientBoostPredictor", "test.csv",
                      f"pred_{on_device}.txt", "-D", "validation.mode=true",
                      "-D", f"device.predict={on_device}", k1=False)
        acc = report["Validation.Accuracy"]
        if acc < BOOST_ACCURACY_BAR:
            raise AssertionError(f"phase 10: boosted accuracy {acc} below "
                                 f"{BOOST_ACCURACY_BAR}")
    log(f"phase 10 boosted planted rule: validation accuracy {acc:.4f} (bar "
        f"{BOOST_ACCURACY_BAR}); the streamed CLI artifact equals the "
        "in-core one")
    return launches


def boost_phase(dev, work):
    """Phase 10; returns K1's integer mode's kernels-line entry."""
    import dataclasses
    table = retarget_big_table(dev)
    cpu_table = dataclasses.replace(
        table, binned=table.binned.cpu(), numeric=table.numeric.cpu(),
        labels=table.labels.cpu())
    model, launches, by_shape = boost_at_scale(dev, work, table, cpu_table)
    del cpu_table
    boost_margins(model, table)
    round_ms = {depth: boost_round(table, rounds, depth)
                for rounds, depth in BOOST_RUNS}
    del table
    # every level shape of the hessian channels, and the gradient
    # channel's at the widest level
    widest_b = max(b for b, _ in by_shape)
    timings = []
    for (b, c), a in sorted(by_shape.items()):
        if c == 1 and b != widest_b:
            continue
        k1 = time_k1_int(dev, a)
        timings.append(k1)
        log(f"phase 10 K1 integer mode at {k1['shape']}: {k1['ms']:.4f} ms "
            f"chained, {k1['graph_ms']:.4f} ms from graph replays reading "
            f"HBM ({k1['bound_ms'] / k1['graph_ms']:.1%} of bound), plain "
            f"{k1['plain_ms']:.4f} ms, bincount {k1['library_ms']:.4f} ms, "
            f"bound {k1['bound_ms']:.4f} ms ({k1['bound_by']})")
    check_k1_int_split(dev, by_shape[(widest_b, 2)])
    del by_shape
    stream_launches = boost_streamed(dev, work)
    cli_launches = boost_cli_jobs(work)
    widest = max(timings, key=lambda k: k["bound_ms"])
    return {"name": "cfb_sums_int (K1-int) at the boosting shape (each "
                    "level's hessian and gradient channels, exact int32 "
                    "sums)",
            "route": "cuda", "source": "avenir_tpu_torch/csrc/hist.cu",
            "replaces": "avenir_tpu/ops/pallas_histogram.py:57",
            "launches": launches, "stream_launches": stream_launches,
            "cli_launches": cli_launches, "max_abs_err": 0.0,
            "round_ms": round_ms,
            **{key: widest[key] for key in ("ms", "graph_ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms", "shape")},
            "levels": [{key: k[key] for key in (
                "shape", "ms", "graph_ms", "plain_ms", "library_ms",
                "bound_ms")} for k in timings]}


# --------------------------------------------------------------------------
# phase 11: the main path's remaining modes
# --------------------------------------------------------------------------

# text Naive Bayes and WordCounter: 50,000 training and 12,500 test
# documents of 5-40 tokens (at 200,000 + 50,000 the whole script ran past
# its 1,200 s limit), on two vocabularies: C·V = 60,000 cells pass
# the 58,112 that K1 keeps in shared memory (its global-atomics
# instantiation), 8,192 stay within them
TEXT_DOCS, TEXT_TEST_DOCS = 50_000, 12_500
TEXT_LEN = (5, 40)
TEXT_VOCABS = (30_000, 4_096)
TOKEN_IDS = 1 << 24          # K1 at the token shape: 16,777,216 token ids
TEXT_ACCURACY_BAR = 0.9
REGRESSION_METHODS = (("average", ()), ("median", ()),
                      ("linearRegression",
                       ("-D", "regr.input.field.ordinal=6")),
                      ("multiLinearRegression", ()))
# the method whose regression also runs with --device cpu: the neighbor
# search all four share and the float64 solve (one of four since phase 12
# came, to keep the script's wall under ~1,000 s on a slow host)
REGRESSION_CPU_METHODS = ("multiLinearRegression",)
SIM_SELF_ROWS = 1024
# 128 x 4,096 = 524,288 distance records through the join and the replay
# (512 until phase 12 came: the replay is host parsing, ~12 µs a record,
# and ran ~180 s of the script on card and CPU)
SIM_TEST, SIM_TRAIN = 128, 4096
FULL_SHAPE = (8192, 65536, 9)
# tests/test_tutorials.py:117-145: the replayed predictions against the
# fused path's
REPLAY_AGREEMENT_BAR = 0.97


def text_corpus(n, vocab, seed):
    """``text,class`` rows from a seed: two classes, each drawing 60% of
    its tokens from one Zipf law over the whole vocabulary and 40% from
    the same law over its own half of it (the planted signal)."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(vocab)], dtype=object)
    lengths = rng.integers(TEXT_LEN[0], TEXT_LEN[1] + 1, n)
    labels = rng.integers(0, 2, n)
    zipf = 1.0 / (1.0 + np.arange(vocab))
    half = vocab // 2
    ids = np.empty(int(lengths.sum()), np.int64)
    of_class = np.repeat(labels, lengths)
    for c in (0, 1):
        own = np.zeros(vocab)
        own[c * half:(c + 1) * half] = zipf[:half]
        p = 0.6 * zipf / zipf.sum() + 0.4 * own / own.sum()
        mask = of_class == c
        ids[mask] = rng.choice(vocab, int(mask.sum()), p=p / p.sum())
    text = words[ids]
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    return [[" ".join(text[s:s + n_tok]), ("neg", "pos")[c]]
            for s, n_tok, c in zip(starts, lengths, labels)]


def time_k1_tokens(dev, vocab):
    """K1 at the token shape: TOKEN_IDS seeded token ids over ``vocab``
    bins and two classes in one launch, exact against its plain version;
    chained, from graph replays reading HBM, plain, ``bincount`` over the
    combined ``class · V + id`` (built beforehand) and the bytes bound (8
    bytes a token read once, the counts written once)."""
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.scripts._timing import chain_ms
    gen = torch.Generator(device=dev).manual_seed(SEED + vocab)
    ids = torch.randint(0, vocab, (TOKEN_IDS, 1), generator=gen, device=dev,
                        dtype=torch.int32)
    labels = torch.randint(0, 2, (TOKEN_IDS,), generator=gen, device=dev,
                           dtype=torch.int32)
    got = H.class_feature_bin_counts(ids, labels, 2, vocab)
    want = H.class_feature_bin_counts_plain(ids, labels, 2, vocab)
    if not torch.equal(got, want) or int(want.sum()) != TOKEN_IDS:
        raise AssertionError(f"phase 11 K1 at {TOKEN_IDS} tokens, V={vocab}:"
                             " counts differ from plain")
    ms = chain_ms(lambda: H.class_feature_bin_counts(ids, labels, 2, vocab),
                  dev)
    graph = hbm_graph_ms(lambda u, v: H.class_feature_bin_counts(u, v, 2,
                                                                 vocab),
                         (ids, labels), TOKEN_IDS * 8, dev)
    plain = cuda_ms(lambda: H.class_feature_bin_counts_plain(ids, labels, 2,
                                                             vocab), 3)
    flat = labels.long() * vocab + ids.reshape(-1).long()
    library = cuda_ms(lambda: torch.bincount(flat, minlength=2 * vocab), 5)
    bound, by = bound_ms(TOKEN_IDS * 8 + 2 * vocab * 4, TOKEN_IDS)
    shared = 2 * vocab * 4 <= 232448
    return {"ms": ms, "graph_ms": graph, "plain_ms": plain,
            "library_ms": library, "bound_ms": bound, "bound_by": by,
            "shape": f"N={TOKEN_IDS} F=1 C=2 B={vocab} "
                     + ("shared-memory" if shared else "global-atomics")}


def exact_near_tie(x, y, rows, k, rtol=1e-5):
    """[len(rows)] bool: the float64 squared distances of test ``rows`` to
    every train row hold two within ``rtol`` among their k + 1 smallest
    (where the f32 summation order may pick either neighbor)."""
    xs = x[rows].double()
    out = []
    for r in range(xs.shape[0]):
        d = ((y.double() - xs[r]) ** 2).sum(1)
        part = torch.topk(d, k + 1, largest=False).values
        gaps = part[1:] - part[:-1]
        out.append(bool((gaps <= rtol * part[1:].abs().clamp(min=1e-12))
                        .any()))
    return out


def same_bytes(label, a, b):
    """Fail unless files ``a`` and ``b`` hold the same bytes."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError(f"{label}: {a} differs from {b}")


def cli_job(phase, label, args, on, counters):
    """One CLI job in-process with ``--device on``; on the card every
    kernel call is recorded, the launch counts of ``counters`` set to 0
    just before and read just after, and each call held against its plain
    version. Returns (stdout, wall s, launches, the recorded calls)."""
    from avenir_tpu_torch.cli.main import main
    calls = []
    for fn in counters.values():
        fn.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with recording(calls), contextlib.redirect_stdout(buf):
        if main(list(args) + ["--device", on]) != 0:
            raise AssertionError(f"phase {phase} {label}: {on} run failed")
    if on == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    if on == "cuda":
        hold_main_path(label, calls, 9, phase=phase)
    return buf.getvalue(), wall, counts, calls


def cli_pair(phase, label, args_of, outs_of, must, counters):
    """The job on the card and on the CPU, each writing its own files
    (``args_of(on)``, ``outs_of(on)``): stdout and every file equal;
    ``must`` kernels launched on the card. Returns the card's stdout,
    launches and recorded calls."""
    got = {on: cli_job(phase, label, args_of(on), on, counters)
           for on in ("cuda", "cpu")}
    counts = got["cuda"][2]
    missing = [name for name in must if counts[name] < 1]
    if missing:
        raise AssertionError(f"phase {phase} {label}: {missing} not "
                             "launched")
    if got["cuda"][0] != got["cpu"][0]:
        raise AssertionError(f"phase {phase} {label}: stdout differs: "
                             f"{got['cuda'][0][:300]!r} against "
                             f"{got['cpu'][0][:300]!r}")
    for a, b in zip(outs_of("cuda"), outs_of("cpu")):
        same_bytes(f"phase {phase} {label}", a, b)
    log(f"phase {phase} {label}: card {got['cuda'][1]:.2f} s, CPU "
        f"{got['cpu'][1]:.2f} s (host clock), launches {counts}; stdout "
        f"and {len(outs_of('cuda'))} file(s) byte-identical to the CPU's")
    return got["cuda"][0], counts, got["cuda"][3]


def modes_phase(dev, work):
    """Phase 11; returns the K1-text kernels-line entry and the launches of
    phase 11's CLI jobs by kernel (K1 tabular, K2, K3)."""
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.models import knn
    from avenir_tpu_torch.ops import cuda_distance, cuda_fused, cuda_histogram
    from avenir_tpu_torch.ops.distance import pairwise_full
    from avenir_tpu_torch.utils.dataset import Featurizer
    from avenir_tpu_torch.utils.schema import FeatureSchema
    counters = {"K1": cuda_histogram.class_feature_bin_counts,
                "K2": cuda_distance.topk_raw, "K3": cuda_fused.fused_topk_raw}
    totals = {"K1-text": 0, "K1": 0, "K2": 0, "K3": 0}
    p = lambda name: os.path.join(work, name)  # noqa: E731

    def run(label, args, on):
        return cli_job(11, label, args, on, counters)[:3]

    def both(label, args_of, outs_of, must, kind="K1"):
        """``cli_pair``, its launches added to phase 11's; returns the
        card's stdout."""
        stdout, counts, _ = cli_pair(11, label, args_of, outs_of, must,
                                     counters)
        totals[kind] += counts["K1"]
        totals["K2"] += counts["K2"]
        totals["K3"] += counts["K3"]
        return stdout

    # -- text Naive Bayes and WordCounter, both vocabularies ----------------
    vocab_timings = []
    for vocab in TEXT_VOCABS:
        t0 = time.perf_counter()
        rows = text_corpus(TEXT_DOCS + TEXT_TEST_DOCS, vocab, SEED + vocab)
        write_csv(p(f"text{vocab}_train.csv"), rows[:TEXT_DOCS])
        write_csv(p(f"text{vocab}_test.csv"), rows[TEXT_DOCS:])
        with open(p(f"text{vocab}.properties"), "w") as fh:
            fh.write("tabular.input=false\nfield.delim.regex=,\n"
                     "validation.mode=true\n")
        log(f"phase 11 text corpus V={vocab}: {TEXT_DOCS} + {TEXT_TEST_DOCS}"
            f" documents of {TEXT_LEN[0]}-{TEXT_LEN[1]} tokens written in "
            f"{time.perf_counter() - t0:.1f} s")
        conf = ["--conf", p(f"text{vocab}.properties")]
        model = lambda on: p(f"text{vocab}_model_{on}.txt")  # noqa: E731
        report = both(
            f"BayesianDistribution tabular.input=false V={vocab}",
            lambda on: ["BayesianDistribution", p(f"text{vocab}_train.csv"),
                        model(on), *conf],
            lambda on: [model(on)], ["K1"], kind="K1-text")
        vocab_found = json.loads(report.splitlines()[-1])[
            "Distribution Data.Vocabulary"]
        report = both(
            f"BayesianPredictor tabular.input=false V={vocab}",
            lambda on: ["BayesianPredictor", p(f"text{vocab}_test.csv"),
                        p(f"text{vocab}_pred_{on}.txt"), *conf, "-D",
                        f"bayesian.model.file.path={model(on)}"],
            lambda on: [p(f"text{vocab}_pred_{on}.txt")], [])
        acc = json.loads(report.splitlines()[-1])["Validation.Accuracy"]
        if not acc >= TEXT_ACCURACY_BAR:
            raise AssertionError(f"phase 11 text V={vocab}: accuracy {acc} "
                                 f"below {TEXT_ACCURACY_BAR}")
        both(f"WordCounter V={vocab}",
             lambda on: ["WordCounter", p(f"text{vocab}_train.csv"),
                         p(f"text{vocab}_wc_{on}.txt"), *conf, "-D",
                         "text.field.ordinal=0"],
             lambda on: [p(f"text{vocab}_wc_{on}.txt")], ["K1"],
             kind="K1-text")
        k1 = time_k1_tokens(dev, vocab)
        vocab_timings.append(k1)
        log(f"phase 11 text V={vocab}: {vocab_found} words found (C·V = "
            f"{2 * vocab_found}), accuracy {acc:.4f} (bar "
            f"{TEXT_ACCURACY_BAR}); K1 at {k1['shape']}: exact against "
            f"plain, {k1['ms']:.4f} ms chained, {k1['graph_ms']:.4f} ms from "
            f"graph replays reading HBM ({k1['bound_ms'] / k1['graph_ms']:.1%}"
            f" of bound), plain {k1['plain_ms']:.3f} ms, bincount "
            f"{k1['library_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms "
            f"({k1['bound_by']})")

    # -- KNN regression at the elearn CLI shape -----------------------------
    elearn = G.elearn_rows(ELEARN_TRAIN + ELEARN_TEST, seed=SEED + 11)
    feats = np.asarray([[float(v) for v in r[1:10]] for r in elearn])
    rng = np.random.default_rng(SEED + 11)
    score = (0.5 * feats[:, 4] + 0.3 * feats[:, 5] + feats[:, 0] / 20.0
             + rng.normal(0, 3, len(elearn)))
    reg_rows = [r[:10] + [f"{v:.1f}"] for r, v in zip(elearn, score)]
    write_csv(p("reg_train.csv"), reg_rows[:ELEARN_TRAIN])
    write_csv(p("reg_test.csv"), reg_rows[ELEARN_TRAIN:])
    schema = G.elearn_schema_json()
    fields = [f for f in schema["entity"]["fields"] if f["ordinal"] < 10]
    fields.append({"name": "score", "ordinal": 10, "dataType": "double",
                   "classAttribute": True})
    reg_schema = dict(schema, entity=dict(schema["entity"], fields=fields))
    with open(p("reg.json"), "w") as fh:
        json.dump(reg_schema, fh)
    with open(p("reg.properties"), "w") as fh:
        fh.write(f"field.delim.regex=,\nfeature.schema.file.path="
                 f"{p('reg.json')}\ntrain.data.path={p('reg_train.csv')}\n"
                 "prediction.mode=regression\ntop.match.count=5\n"
                 "validation.mode=true\n")
    truth = score[ELEARN_TRAIN:].round(1)
    baseline = float(np.abs(truth - truth.mean()).mean())
    # the normalized features, for holding a row that differs card to CPU
    # to a near tie of its neighbors
    fz = Featurizer(FeatureSchema.from_json(reg_schema), device="cpu")
    fz.fit(reg_rows[:ELEARN_TRAIN])
    y_num, _, _ = knn._split_features(
        fz.transform(reg_rows[:ELEARN_TRAIN], with_labels=False))
    x_num, _, _ = knn._split_features(
        fz.transform(reg_rows[ELEARN_TRAIN:], with_labels=False))
    conf = ["--conf", p("reg.properties")]
    for method, extra in REGRESSION_METHODS:
        outs = {}
        legs = [("staged", "cuda", (), ["K2"]),
                (f"feed.chunk.rows={FEED_CHUNK_ROWS}", "cuda",
                 ("-D", f"feed.chunk.rows={FEED_CHUNK_ROWS}"), ["K3"])]
        if method in REGRESSION_CPU_METHODS:
            legs.append(("cpu", "cpu", (), []))
        for tag, on, feed, must in legs:
            label = f"NearestNeighbor regression {method} {tag}"
            out = p(f"reg_{method}_{on}_{len(feed)}.txt")
            stdout, wall, counts = run(
                label, ["NearestNeighbor", p("reg_test.csv"), out, *conf,
                        "-D", f"regression.method={method}", *extra, *feed],
                on)
            missing = [name for name in must if counts[name] < 1]
            if missing:
                raise AssertionError(f"phase 11 {label}: {missing} not "
                                     "launched")
            totals["K2"] += counts["K2"]
            totals["K3"] += counts["K3"]
            mae = json.loads(stdout.splitlines()[-1])[
                "Validation.MeanAbsoluteError"]
            if not (math.isfinite(mae) and mae < 0.5 * baseline):
                raise AssertionError(f"phase 11 {label}: MAE {mae} not below"
                                     f" half the mean predictor's {baseline}")
            outs[tag] = (stdout, open(out).read().splitlines())
            log(f"phase 11 {label}: {wall:.2f} s (host clock), launches "
                f"{counts}, MAE {mae:.4f} (mean predictor {baseline:.4f})")
        staged, chunked = (outs[t] for t in (
            "staged", f"feed.chunk.rows={FEED_CHUNK_ROWS}"))
        if staged != chunked:
            raise AssertionError(f"phase 11 regression {method}: staged and "
                                 "chunked outputs differ")
        if "cpu" not in outs:
            log(f"phase 11 regression {method}: staged (K2) and chunked (K3) "
                "outputs and stdout byte-identical")
            continue
        cpu = outs["cpu"]
        differ = [i for i, (a, b) in enumerate(zip(staged[1], cpu[1]))
                  if a != b]
        if len(staged[1]) != len(cpu[1]) or not all(
                exact_near_tie(x_num, y_num, differ, 5)):
            raise AssertionError(f"phase 11 regression {method}: rows "
                                 f"{differ[:10]} differ card to CPU off a "
                                 "near tie")
        log(f"phase 11 regression {method}: staged (K2) and chunked (K3) "
            "outputs and stdout byte-identical; against the CPU "
            f"{len(differ)} of {len(cpu[1])} rows differ, each at a near tie "
            "of its neighbors")

    # -- SameTypeSimilarity, pairwise_full and the replay pipeline ----------
    rows = G.elearn_rows(SIM_TRAIN + SIM_TEST, seed=SEED + 12)
    write_csv(p("sim_train.csv"), rows[:SIM_TRAIN])
    write_csv(p("sim_test.csv"), rows[SIM_TRAIN:])
    write_csv(p("sim_self.csv"), rows[:SIM_SELF_ROWS])
    with open(p("sim.properties"), "w") as fh:
        fh.write(f"field.delim.regex=,\nfeature.schema.file.path="
                 f"{p('elearn.json')}\ntrain.data.path={p('sim_train.csv')}\n"
                 "top.match.count=5\nkernel.function=none\n"
                 "distance.scale=1000\nvalidation.mode=true\n"
                 "positive.class.value=fail\nlaplace.smoothing=1.0\n")
    with open(p("elearn.json"), "w") as fh:
        json.dump(G.elearn_schema_json(), fh)
    conf = ["--conf", p("sim.properties")]
    both(f"SameTypeSimilarity {SIM_SELF_ROWS} rows",
         lambda on: ["SameTypeSimilarity", p("sim_self.csv"),
                     p(f"self_{on}.txt"), *conf],
         lambda on: [p(f"self_{on}.txt")], [])
    both(f"SameTypeSimilarity inter.set.matching {SIM_TEST}x{SIM_TRAIN}",
         lambda on: ["SameTypeSimilarity", p("sim_test.csv"),
                     p(f"dist_{on}.txt"), *conf, "-D",
                     "inter.set.matching=true"],
         lambda on: [p(f"dist_{on}.txt")], [])
    m, n, d = FULL_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    x = torch.rand((m, d), generator=gen, device=dev)
    y = torch.rand((n, d), generator=gen, device=dev)
    full = pairwise_full(x, y)
    part = pairwise_full(x[:256].cpu(), y.cpu())
    if not torch.equal(full[:256].cpu(), part):
        raise AssertionError("phase 11 pairwise_full: the card's first 256 "
                             "rows differ from the CPU's")
    full_ms = cuda_ms(lambda: pairwise_full(x, y), 3)
    cdist_ms = cuda_ms(lambda: torch.cdist(x, y), 3)
    full_bound, full_by = bound_ms(m * n * 4 + (m + n) * d * 4,
                                   3.0 * m * n * d)
    del full
    log(f"phase 11 pairwise_full {m}x{n}x{d}: first 256 rows equal to the "
        f"CPU's; {full_ms:.2f} ms (CUDA events), bound {full_bound:.4f} ms "
        f"({full_by}: int32 writes), torch.cdist {cdist_ms:.2f} ms")
    # elearn's features are all continuous: its model is the class
    # moments, and K1 has no binned column to count
    both(f"BayesianDistribution elearn {SIM_TRAIN} rows",
         lambda on: ["BayesianDistribution", p("sim_train.csv"),
                     p(f"nb_{on}.txt"), *conf],
         lambda on: [p(f"nb_{on}.txt")], [])
    # the continuous predictor's probabilities: XLA's log and exp, float64
    # square roots, fixed sums (ROADMAP C9, repaired), so the file is equal
    # card to CPU; the card's feeds the join on both
    both("BayesianPredictor output.feature.prob.only=true",
         lambda on: ["BayesianPredictor", p("sim_train.csv"),
                     p(f"prob_{on}.txt"), *conf, "-D",
                     f"bayesian.model.file.path={p(f'nb_{on}.txt')}", "-D",
                     "output.feature.prob.only=true"],
         lambda on: [p(f"prob_{on}.txt")], [])
    both("FeatureCondProbJoiner",
         lambda on: ["FeatureCondProbJoiner", p(f"dist_{on}.txt"),
                     p(f"joined_{on}.txt"), *conf, "-D",
                     f"feature.prob.path={p('prob_cuda.txt')}", "-D",
                     f"test.class.path={p('sim_test.csv')}"],
         lambda on: [p(f"joined_{on}.txt")], [])
    report = both(
        "NearestNeighbor neighbor.data.path 6-field class-conditional",
        lambda on: ["NearestNeighbor", p("ignored.csv"),
                    p(f"replay6_{on}.txt"), *conf, "-D",
                    f"neighbor.data.path={p(f'joined_{on}.txt')}", "-D",
                    "class.condition.weighted=true"],
        lambda on: [p(f"replay6_{on}.txt")], [])
    acc6 = json.loads(report.splitlines()[-1])["Validation.Accuracy"]
    report = both(
        "NearestNeighbor neighbor.data.path 3-field",
        lambda on: ["NearestNeighbor", p("ignored.csv"),
                    p(f"replay3_{on}.txt"), *conf, "-D",
                    f"neighbor.data.path={p(f'dist_{on}.txt')}"],
        lambda on: [p(f"replay3_{on}.txt")], [])
    if "validation.mode=true skipped" not in report:
        raise AssertionError("phase 11: the 3-field replay did not skip "
                             f"validation: {report!r}")
    stdout, _, counts = run("NearestNeighbor fused (the replay's yardstick)",
                            ["NearestNeighbor", p("sim_test.csv"),
                             p("fused.txt"), *conf], "cuda")
    if counts["K2"] < 1:
        raise AssertionError("phase 11 fused NearestNeighbor: K2 not "
                             "launched")
    totals["K2"] += counts["K2"]
    replay = dict(line.split(",") for line in
                  open(p("replay3_cuda.txt")).read().splitlines())
    fused = dict(line.split(",")[:2] for line in
                 open(p("fused.txt")).read().splitlines())
    agree = float(np.mean([replay.get(key) == v for key, v in fused.items()]))
    if set(replay) != set(fused) or agree < REPLAY_AGREEMENT_BAR:
        raise AssertionError(f"phase 11 replay: agreement {agree} with the "
                             f"fused path (bar {REPLAY_AGREEMENT_BAR})")
    log(f"phase 11 replay pipeline: files equal card to CPU at every step; "
        f"class-conditional replay accuracy {acc6:.4f}; the 3-field replay "
        f"agrees with the fused path on {agree:.4f} of {len(fused)} rows "
        f"(bar {REPLAY_AGREEMENT_BAR})")

    widest = vocab_timings[0]
    entry = {"name": "cfb_counts (K1-text) at the token shape (text Naive "
                     "Bayes' (class, token) counts, WordCounter's token "
                     "counts: one feature, the vocabulary as its bins)",
             "route": "cuda", "source": "avenir_tpu_torch/csrc/hist.cu",
             # the JAX package counts these with an f32 scatter-add and
             # a bincount, not with a Pallas kernel
             "replaces": "avenir_tpu/text/text_bayes.py:59-65 and "
                         "avenir_tpu/text/word_count.py:44-45 (not Pallas "
                         "kernels)",
             "launches": totals["K1-text"], "max_abs_err": 0.0,
             **{key: widest[key] for key in (
                 "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "shape")},
             "vocabularies": [{key: k[key] for key in (
                 "shape", "ms", "graph_ms", "plain_ms", "library_ms",
                 "bound_ms")} for k in vocab_timings]}
    log(f"phase 11 kernels {json.dumps(totals)}")
    return entry, totals


# --------------------------------------------------------------------------
# phase 12: the last batch verbs, streamed and per-shard NB and MI
# --------------------------------------------------------------------------

# streamed NB: phase 3's churn rows tiled to 1,048,576 (the same rows the
# per-shard train reads as 8 part files of 131,072), 8 MiB windows; elearn
# rows tiled to 262,144 (continuous NB, logistic, Fisher); hospital
# rows tiled to 8 part files of 131,072 (per-shard MI); the
# samplers over 262,144 churn lines (at 2,097,152 and 1,048,576 the whole
# script ran past its 1,200 s limit); ~1,000,000 purchase rows for the
# projection (the email-marketing tutorial's buyhist stage)
STREAM_CHURN_ROWS = 1_048_576
STREAM_WINDOW_BYTES = 8_388_608
BATCH_ROWS = 262_144
NB_SHARDS, NB_SHARD_ROWS = 8, 131_072
MI_SHARDS, MI_SHARD_ROWS = 8, 131_072
# the elearn and hospital rows tiled from 32,768 of each (the hospital
# generator takes ~0.2 ms a row on the host)
BATCH_BASE_ROWS = 32_768
LR_ITERATIONS, LR_SPLIT = 100, 40
BUY_CUSTOMERS, BUY_DAYS, BUY_FRACTION = 100_000, 200, 0.05
BAG_BATCH = 10_000
DROPPED_SHARD = 3


def write_tiled(path, rows, n):
    """``rows`` as CSV lines, repeated until ``n`` lines are written."""
    text = "".join(",".join(r) + "\n" for r in rows)
    with open(path, "w") as fh:
        for _ in range(n // len(rows)):
            fh.write(text)
        fh.write("".join(",".join(r) + "\n" for r in rows[:n % len(rows)]))


def split_parts(path, part_dir, n_parts):
    """The lines of ``path`` cut into ``n_parts`` MR part files of equal
    size."""
    os.makedirs(part_dir)
    with open(path) as fh:
        lines = fh.readlines()
    size = len(lines) // n_parts
    for i in range(n_parts):
        with open(os.path.join(part_dir, f"part-{i:05d}"), "w") as fh:
            fh.writelines(lines[i * size:(i + 1) * size])


def time_k4_at(dev, a):
    """K4 on recorded operands: chained, from graph replays reading HBM,
    plain, ``bincount`` over the offset combined ids and the bytes
    bound."""
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.scripts._timing import chain_ms
    ids, pairs, cards = a["ids"], a["pairs"], a["cards"]
    n = ids.shape[1]
    ms = chain_ms(lambda: H.pair_counts_multi(ids, pairs, cards), dev)
    graph = hbm_graph_ms(lambda x: H.pair_counts_multi(x, pairs, cards),
                         (ids,), ids.numel() * 4, dev)
    plain = cuda_ms(lambda: H.pair_counts_multi_plain(ids, pairs, cards), 5)
    flat = multi_flat(ids, pairs, cards)
    total = H.pair_offsets(pairs, cards)[-1]
    library = cuda_ms(lambda: torch.bincount(flat, minlength=total), 20)
    bound, by = bound_ms(multi_bytes(ids, pairs, cards, False),
                         n * len(pairs))
    return {"ms": ms, "graph_ms": graph, "plain_ms": plain,
            "library_ms": library, "bound_ms": bound, "bound_by": by,
            "shape": f"N={n} K={ids.shape[0]} {len(pairs)} pairs"}


def batch_phase(dev, work):
    """Phase 12; returns the kernels-line entries of K1 at the stream
    window and NB shard shapes and of K4 at the MI shard shape."""
    from avenir_tpu_torch.cli.main import _emit_mi_scores
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.explore import mutual_information as mi
    from avenir_tpu_torch.models import logistic
    from avenir_tpu_torch.models import naive_bayes as nb
    from avenir_tpu_torch.native.loader import transform_file
    from avenir_tpu_torch.ops import cuda_histogram
    from avenir_tpu_torch.utils.config import JobConfig
    from avenir_tpu_torch.utils.dataset import Featurizer
    from avenir_tpu_torch.utils.projection import project_file
    from avenir_tpu_torch.utils.schema import FeatureSchema
    counters = {"K1": cuda_histogram.class_feature_bin_counts,
                "K4": cuda_histogram.pair_counts_multi}
    recorded = {"K1": [], "K4": []}
    launched = {"K1": 0, "K4": 0}
    p = lambda name: os.path.join(work, name)  # noqa: E731
    t_phase = time.perf_counter()

    def keep(label, counts, calls):
        """The card's launches and the K1/K4 calls that launched."""
        for name in recorded:
            launched[name] += counts[name]
            # a table without binned features calls K1 with no column,
            # which launches nothing
            recorded[name] += [(label, a) for n, a, _ in calls
                               if n == name and (name == "K4"
                                                 or a["bins"].shape[1])]

    def run(label, args):
        """One CLI job on the card; returns (stdout, wall s, launches)."""
        stdout, wall, counts, calls = cli_job(12, label, args, "cuda",
                                              counters)
        keep(label, counts, calls)
        return stdout, wall, counts

    def both(label, args_of, outs_of, must=()):
        """``cli_pair``; returns the card's stdout and launches."""
        stdout, counts, calls = cli_pair(12, label, args_of, outs_of, must,
                                         counters)
        keep(label, counts, calls)
        return stdout, counts

    def same(label, a, b):
        same_bytes(f"phase 12 {label}", a, b)

    # -- data -------------------------------------------------------------
    t0 = time.perf_counter()
    churn = G.churn_rows(CHURN_TRAIN, seed=SEED)
    write_tiled(p("churn.csv"), churn, STREAM_CHURN_ROWS)
    split_parts(p("churn.csv"), p("churn_parts"), NB_SHARDS)
    write_tiled(p("churn_1m.csv"), churn, BATCH_ROWS)
    write_tiled(p("elearn.csv"), G.elearn_rows(BATCH_BASE_ROWS, seed=SEED),
                BATCH_ROWS)
    write_tiled(p("hosp.csv"),
                G.hosp_readmit_rows(BATCH_BASE_ROWS, seed=SEED),
                MI_SHARDS * MI_SHARD_ROWS)
    split_parts(p("hosp.csv"), p("hosp_parts"), MI_SHARDS)
    buy = G.buy_xaction_rows(BUY_CUSTOMERS, BUY_DAYS, BUY_FRACTION,
                             seed=SEED)
    write_csv(p("buy.csv"), buy)
    schemas = {"churn": G._CHURN_SCHEMA_JSON,
               "elearn": G.elearn_schema_json(),
               "hosp": G._HOSP_SCHEMA_JSON}
    for name, schema in schemas.items():
        with open(p(f"{name}.json"), "w") as fh:
            json.dump(schema, fh)
        with open(p(f"{name}.properties"), "w") as fh:
            fh.write(f"field.delim.regex=,\nfield.delim=,\n"
                     f"feature.schema.file.path={p(name + '.json')}\n"
                     f"mi.score.algorithms={MI_ALGORITHMS}\n")
    log(f"phase 12 data: {STREAM_CHURN_ROWS} churn rows ({NB_SHARDS} parts "
        f"of {NB_SHARD_ROWS}), {BATCH_ROWS} elearn and churn rows, "
        f"{MI_SHARDS} x {MI_SHARD_ROWS} hospital rows, {len(buy)} purchase "
        f"rows written in {time.perf_counter() - t0:.1f} s")

    def table_of(name, path):
        """The whole file as one table on the card (the native encoder,
        the schema's own vocabularies)."""
        fz = Featurizer(FeatureSchema.from_json(schemas[name]), device=dev)
        return transform_file(fz.fit([]), path, device=dev)

    def in_memory(name, path):
        """The card's in-memory NB train of the whole file, saved as the
        CLI saves it."""
        t0 = time.perf_counter()
        model, meta, _ = nb.train(table_of(name, path))
        nb.save_model(model, meta, p(f"{name}_memory.txt"))
        return time.perf_counter() - t0

    # -- streamed NB ------------------------------------------------------
    for name, path, n in (("churn", p("churn.csv"), STREAM_CHURN_ROWS),
                          ("elearn", p("elearn.csv"), BATCH_ROWS)):
        label = f"BayesianDistribution streaming.train {name} {n} rows"
        _, counts = both(
            label,
            lambda on: ["BayesianDistribution", path,
                        p(f"{name}_stream_{on}.txt"), "--conf",
                        p(f"{name}.properties"), "-D",
                        "streaming.train=true", "-D",
                        f"stream.window.bytes={STREAM_WINDOW_BYTES}"],
            lambda on: [p(f"{name}_stream_{on}.txt")],
            ["K1"] if name == "churn" else [])
        secs = in_memory(name, path)
        same(label, p(f"{name}_stream_cuda.txt"), p(f"{name}_memory.txt"))
        windows = math.ceil(os.path.getsize(path) / STREAM_WINDOW_BYTES)
        log(f"phase 12 {label}: model equal to the card's in-memory train "
            f"({secs:.2f} s); {counts['K1']} K1 launches over {windows} "
            f"windows of {STREAM_WINDOW_BYTES} bytes")

    # -- per-shard NB and MI, and a resume after a dropped shard --------
    for verb, name, parts, n_parts, n_rows in (
            ("BayesianDistribution", "churn", p("churn_parts"), NB_SHARDS,
             NB_SHARD_ROWS),
            ("MutualInformation", "hosp", p("hosp_parts"), MI_SHARDS,
             MI_SHARD_ROWS)):
        kernel = "K1" if name == "churn" else "K4"
        out = lambda on: p(f"{name}_shards_{on}.txt")  # noqa: E731
        args = lambda on: [verb, parts, out(on), "--conf",  # noqa: E731
                           p(f"{name}.properties"), "-D", "shard.parts=true",
                           "-D", "shard.journal=true", "-D",
                           "shard.journal.keep=true"]
        label = f"{verb} shard.parts {n_parts} x {n_rows} {name} rows"
        _, counts = both(label, args, lambda on: [out(on)], [kernel])
        if counts[kernel] != n_parts:
            raise AssertionError(f"phase 12 {label}: {counts[kernel]} "
                                 f"{kernel} launches, not one a shard")
        if name == "churn":
            same(label, out("cuda"), p("churn_memory.txt"))
        else:
            dists = mi.compute_distributions(table_of(name, p("hosp.csv")))
            _emit_mi_scores(JobConfig.from_file(p("hosp.properties")),
                            p("hosp_merged.txt"),
                            mi.compute_scores(dists, device=dev))
            same(label, out("cuda"), p("hosp_merged.txt"))
        with open(out("cuda"), "rb") as fh:
            whole = fh.read()
        os.remove(os.path.join(out("cuda") + ".shards",
                               f"shard-{DROPPED_SHARD:05d}.json"))
        stdout, wall, counts = run(f"{label} --resume",
                                   args("cuda") + ["--resume"])
        report = json.loads(stdout.splitlines()[-1])
        with open(out("cuda"), "rb") as fh:
            resumed = fh.read()
        if ((report["shards_resumed"], report["shards_computed"])
                != (n_parts - 1, 1) or counts[kernel] != 1
                or resumed != whole):
            raise AssertionError(f"phase 12 {label} --resume: {report}, "
                                 f"{counts[kernel]} {kernel} launches")
        log(f"phase 12 {label}: equal to the merged job; --resume after "
            f"dropping shard {DROPPED_SHARD}'s commit: {wall:.2f} s, "
            f"{report['shards_resumed']} resumed and "
            f"{report['shards_computed']} computed, 1 {kernel} launch, the "
            "same bytes")

    # -- LogisticRegressionJob ------------------------------------------
    with open(p("lr.properties"), "w") as fh:
        fh.write("field.delim.regex=,\nfeature.field.ordinals="
                 "1,2,3,4,5,6,7,8,9\nclass.attr.ord=10\n"
                 f"positive.class.value=fail\niteration.limit={LR_ITERATIONS}"
                 "\n")

    def lr_args(tag, *extra):
        return ["LogisticRegressionJob", p("elearn.csv"), p(f"lr_{tag}.txt"),
                "--conf", p("lr.properties"), "-D",
                f"coeff.file.path={p(f'lr_{tag}_hist.txt')}", *extra]

    for loop, extra in (("f32", ()),
                        ("f64", ("-D", "convergence.threshold=1e-5"))):
        report, _ = both(
            f"LogisticRegressionJob {loop} loop {BATCH_ROWS} rows",
            lambda on: lr_args(f"{loop}_{on}", *extra),
            lambda on: [p(f"lr_{loop}_{on}.txt"),
                        p(f"lr_{loop}_{on}_hist.txt")])
        log(f"phase 12 LogisticRegressionJob {loop} loop: {report.strip()}")
    # the split run through the library on the card, the rows encoded
    # once (the CLI parses BATCH_ROWS rows a run)
    table = table_of("elearn", p("elearn.csv"))
    y = (table.labels == table.class_values.index("fail")).float()
    t0 = time.perf_counter()
    for limit in (LR_SPLIT, LR_ITERATIONS):
        w, iters, _ = logistic.train(
            table.numeric, y, logistic.LogisticConfig(max_iterations=limit),
            p("lr_split_hist.txt"))
    torch.cuda.synchronize()
    same("LogisticRegressionJob resumed", p("lr_split_hist.txt"),
         p("lr_f32_cuda_hist.txt"))
    with open(p("lr_f32_cuda.txt")) as fh:
        uninterrupted = fh.read()
    if (",".join(repr(float(v)) for v in w) + "\n" != uninterrupted
            or iters != LR_ITERATIONS):
        raise AssertionError("phase 12 LogisticRegressionJob resumed: the "
                             "coefficients differ from the uninterrupted "
                             "run's")
    log(f"phase 12 LogisticRegressionJob split at iteration {LR_SPLIT} and "
        f"resumed from its history ({time.perf_counter() - t0:.2f} s, "
        "logistic.train on the card): history and coefficients equal the "
        "uninterrupted run's")

    # -- FisherDiscriminant, the samplers, Projection -------------------
    both(f"FisherDiscriminant {BATCH_ROWS} elearn rows",
         lambda on: ["FisherDiscriminant", p("elearn.csv"),
                     p(f"fisher_{on}.txt"), "--conf",
                     p("elearn.properties")],
         lambda on: [p(f"fisher_{on}.txt")])
    with open(p("sample.properties"), "w") as fh:
        fh.write(f"field.delim.regex=,\nclass.attr.ord=6\nrandom.seed={SEED}"
                 f"\nbatch.size={BAG_BATCH}\n")
    bootstrap = ("-D", "streaming.bootstrap=true")
    for label, extra in (("exact", ()), ("streaming.bootstrap", bootstrap)):
        both(f"UnderSamplingBalancer {label} {BATCH_ROWS} churn lines",
             lambda on: ["UnderSamplingBalancer", p("churn_1m.csv"),
                         p(f"under_{label}_{on}.txt"), "--conf",
                         p("sample.properties"), *extra],
             lambda on: [p(f"under_{label}_{on}.txt")])
    both(f"BaggingSampler batch.size={BAG_BATCH} {BATCH_ROWS} churn lines",
         lambda on: ["BaggingSampler", p("churn_1m.csv"), p(f"bag_{on}.txt"),
                     "--conf", p("sample.properties")],
         lambda on: [p(f"bag_{on}.txt")])
    with open(p("buyhist.properties"), "w") as fh:
        fh.write("field.delim.regex=,\nfield.delim.out=,\n"
                 "projection.operation=groupingOrdering\nkey.field=0\n"
                 "orderBy.field=2\nprojection.field=2,3\n"
                 "format.compact=true\n")
    both(f"Projection {len(buy)} purchase rows",
         lambda on: ["Projection", p("buy.csv"), p(f"proj_{on}.txt"),
                     "--conf", p("buyhist.properties")],
         lambda on: [p(f"proj_{on}.txt")])
    t0 = time.perf_counter()
    project_file(p("buy.csv"), p("proj_python.txt"), 0, 2, [2, 3],
                 force_python=True)
    same("Projection", p("proj_cuda.txt"), p("proj_python.txt"))
    log(f"phase 12 Projection: the native pass equal to the Python pass "
        f"({time.perf_counter() - t0:.2f} s)")

    # -- K1 and K4 at this phase's shapes --------------------------------
    entries = []
    for name, kernel, timer, replaces, what in (
            ("K1", "cfb_counts (K1-stream) at the stream-window and "
             "NB-shard shapes", time_k1_at,
             "avenir_tpu/ops/pallas_histogram.py:114",
             ("streaming.train", "shard.parts")),
            ("K4", "pair_counts_multi (K4-shard) at the MI-shard shape",
             time_k4_at, "avenir_tpu/ops/pallas_histogram.py:178",
             ("shard.parts",))):
        shapes = []
        for key in what:
            job, a = next((label, a) for label, a in recorded[name]
                          if key in label)
            t = timer(dev, a)
            t["job"] = job
            calls = sum(key in label for label, _ in recorded[name])
            log(f"phase 12 {name} at {t['shape']} ({job}): {calls} "
                f"calls, {t['ms']:.4f} ms chained, {t['graph_ms']:.4f} ms "
                f"from HBM ({t['bound_ms'] / t['graph_ms']:.1%} of bound "
                f"{t['bound_ms']:.4f}, {t['bound_by']}), plain "
                f"{t['plain_ms']:.4f}, bincount {t['library_ms']:.4f}")
            shapes.append(t)
        widest = max(shapes, key=lambda t: t["bound_ms"])
        entries.append({
            "name": kernel, "route": "cuda",
            "source": "avenir_tpu_torch/csrc/hist.cu", "replaces": replaces,
            "launches": launched[name], "max_abs_err": 0.0,
            **{key: widest[key] for key in (
                "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape")},
            "shapes": shapes})
    log(f"phase 12 wall {time.perf_counter() - t_phase:.1f} s")
    return entries


# --------------------------------------------------------------------------
# phase 3: the CLI path
# --------------------------------------------------------------------------

def write_csv(path, rows):
    with open(path, "w") as fh:
        fh.write("\n".join(",".join(r) for r in rows) + "\n")


def run_cli(args):
    """Run one CLI job in-process; return its last stdout JSON line."""
    lines = [line for line in cli_lines(args) if line.strip()]
    return json.loads(lines[-1]) if lines else {}


def cli_lines(args):
    """Run one CLI job in-process; return its stdout lines."""
    from avenir_tpu_torch.cli.main import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    if rc != 0:
        raise AssertionError(f"CLI {args[0]} returned {rc}")
    return buf.getvalue().splitlines()


@contextlib.contextmanager
def recording(calls):
    """Record every call of the kernel wrappers of K1-K4 (K1 also in its
    integer mode, ``class_feature_bin_sums``; K4 through
    ``pair_counts_multi``, the wrapper the MI and correlation jobs call,
    and ``pair_counts``, the Markov path's) while the main path
    runs — its operands and the result the path went on with — so that
    each can be held against its plain version afterwards. The wrappers
    themselves run unchanged and count their launches: they count through
    their module-level name, which names the stand-in meanwhile, so the
    stand-in carries the count and hands it back on exit."""
    from avenir_tpu_torch.ops import cuda_distance, cuda_fused, cuda_histogram
    sites = [(cuda_histogram, "class_feature_bin_counts", "K1"),
             (cuda_histogram, "class_feature_bin_sums", "K1-int"),
             (cuda_distance, "topk_raw", "K2"),
             (cuda_fused, "fused_topk_raw", "K3"),
             (cuda_histogram, "pair_counts_multi", "K4"),
             (cuda_histogram, "pair_counts", "K4-pair")]
    originals = [getattr(module, attr) for module, attr, _ in sites]

    def recorder(fn, name):
        signature = inspect.signature(fn)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            calls.append((name, dict(bound.arguments), out))
            return out
        call.launches = fn.launches
        return call

    stand_ins = [recorder(fn, name)
                 for (_, _, name), fn in zip(sites, originals)]
    for (module, attr, _), stand_in in zip(sites, stand_ins):
        setattr(module, attr, stand_in)
    try:
        yield
    finally:
        for (module, attr, _), fn, stand_in in zip(sites, originals,
                                                   stand_ins):
            fn.launches = stand_in.launches
            setattr(module, attr, fn)


def host_ms(fn):
    """Wall time of one call of ``fn``, the card synchronized around it,
    and its result."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def profile_job(label, args, kernel):
    """One more run of a CLI job under ``torch.profiler`` (launch counts
    untouched): its wall time, the device time of each kernel and copy the
    card ran, their sum over the wall time (the device's busy share), the
    launches and device time of ``kernel`` and the count and device time
    of the copies. Prints "not measured" where the profiler recorded no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_cli(args + ["--device", "cuda"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not device:
        log(f"phase 3 {label} under torch.profiler: wall {wall:.1f} ms; "
            "device time not measured (the profiler recorded none)")
        return
    busy = sum(e.self_device_time_total for e in device) / 1e3
    mine = [e for e in device if kernel in e.key]
    copies = [e for e in device if "Memcpy" in e.key]
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:4]
    log(f"phase 3 {label} under torch.profiler: wall {wall:.1f} ms, device "
        f"busy {busy:.3f} ms ({busy / wall:.3%}); {kernel} "
        f"{sum(e.count for e in mine)} launches, "
        f"{sum(e.self_device_time_total for e in mine) / 1e3:.3f} ms on the "
        f"device; copies {sum(e.count for e in copies)}, "
        f"{sum(e.self_device_time_total for e in copies) / 1e3:.3f} ms ("
        + ", ".join(f"{e.key} x{e.count}" for e in copies)
        + "); largest: " + "; ".join(
            f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
            for e in top))


def hold_main_path(label, calls, n_attrs, phase=3):
    """Hold each kernel call a job made against the plain version on the
    same operands (K1 and K4 exact, K2/K3 by ``compare_topk``, K3 also
    bit-identical to K2 on the normalized chunk), and time the kernels at
    the job's own shapes; the lines name ``phase``."""
    from avenir_tpu_torch.ops import cuda_distance as D
    from avenir_tpu_torch.ops import cuda_fused as F
    from avenir_tpu_torch.ops import cuda_histogram as H
    for name in ("K1", "K2", "K3", "K4"):
        mine = [(a, out) for n, a, out in calls if n == name]
        if not mine:
            continue
        ms = plain_ms = n_bytes = n_ops = 0.0
        shapes, checks = [], []
        for a, out in mine:
            if name == "K4":
                ids, pairs, cards, w = (a["ids"], a["pairs"], a["cards"],
                                        a["weights"])
                n = ids.shape[1]
                n_bytes += multi_bytes(ids, pairs, cards, w is not None)
                n_ops += n * len(pairs)
                plain_t, want = host_ms(lambda: H.pair_counts_multi_plain(
                    ids, pairs, cards, w))
                exact = w is None or bool(((w == 0) | (w == 1)).all())
                same = (torch.equal(out, want) if exact else
                        torch.allclose(out, want, rtol=1e-5, atol=0.0))
                if not same:
                    raise AssertionError(f"{label}: K4 counts differ from "
                                         "plain on the path's operands")
                ms += cuda_ms(lambda: H.pair_counts_multi(ids, pairs, cards,
                                                          w), 5)
                shapes.append(f"{n}:{len(pairs)} pairs")
                checks.append("exact" if exact else "rtol 1e-5")
                plain_ms += plain_t
                continue
            if name == "K1":
                n, f = a["bins"].shape
                cells = f * a["n_classes"] * a["n_bins"]
                n_bytes += n * (f + 1) * 4 + cells * 4
                n_ops += n * f
                w = a["weights"]
                plain_t, want = host_ms(
                    lambda: H.class_feature_bin_counts_plain(
                        a["bins"], a["labels"], a["n_classes"], a["n_bins"],
                        w))
                exact = w is None or bool(((w == 0) | (w == 1)).all())
                same = (torch.equal(out, want) if exact else
                        torch.allclose(out, want, rtol=1e-5, atol=0.0))
                if not same:
                    raise AssertionError(f"{label}: K1 counts differ from "
                                         "plain on the path's operands")
                ms += cuda_ms(lambda: H.class_feature_bin_counts(
                    a["bins"], a["labels"], a["n_classes"], a["n_bins"], w),
                    5)
                shapes.append("x".join(map(str, a["bins"].shape)))
                checks.append("exact" if exact else "rtol 1e-5")
                plain_ms += plain_t
                continue
            y, y2, k = a["y"], a["y2"], a["k"]
            if name == "K2":
                x = a["x"]
                plain_t, want = host_ms(lambda: plain_with_next(
                    D.topk_raw_plain, x, y, y2, k))
                ms += cuda_ms(lambda: D.topk_raw(x, y, y2, k), 5)
            else:
                raw, mins, span = a["x_raw"], a["mins"], a["span"]
                x = F.normalize(raw, mins, span)
                if not all(torch.equal(p, q) for p, q in
                           zip(out, D.topk_raw(x, y, y2, k))):
                    raise AssertionError(f"{label}: K3 is not bit-identical"
                                         " to K2 on the normalized chunk")
                plain_t, want = host_ms(lambda: plain_with_next(
                    F.fused_topk_raw_plain, raw, y, y2, k, mins, span))
                ms += cuda_ms(lambda: F.fused_topk_raw(raw, y, y2, mins,
                                                       span, k), 5)
            plain_ms += plain_t
            checks.append(compare_topk(f"{label} {name}", out, want, x, y,
                                       y2, n_attrs))
            (m, d), n = x.shape, y.shape[0]
            n_bytes += (m * d + n * d + n) * 4 + m * k * 8
            n_ops += 2.0 * m * n * d
            if name == "K3":
                n_bytes += 2 * d * 4
                n_ops += 2.0 * m * d
            shapes.append(f"{m}x{n}x{d}")
        if name in ("K1", "K4"):
            verdict = ", ".join(sorted(set(checks)))
            shapes = [f"{c} x {s}" if c > 1 else s
                      for s, c in sorted(collections.Counter(shapes).items())]
        else:
            verdict = summary({
                "rows": sum(c["rows"] for c in checks),
                "sets": sum(c["sets"] for c in checks),
                "metric_err": max(c["metric_err"] for c in checks),
                "int_err": max(c["int_err"] for c in checks)})
            if name == "K3":
                verdict += "; bit-identical to K2 on each normalized chunk"
        bound, by = bound_ms(n_bytes, n_ops)
        log(f"phase {phase} {label}: {name} on the path's operands, "
            f"{len(mine)} "
            f"call(s) [{', '.join(shapes)}]: {verdict}; kernel {ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms (host clock), bound {bound:.4g} ms "
            f"({by})")


def bits_equal(a, b) -> bool:
    """Two encoded tables equal bit for bit (floats compared as bits)."""
    return (torch.equal(a.binned, b.binned)
            and torch.equal(a.numeric.view(torch.int32),
                            b.numeric.view(torch.int32))
            and torch.equal(a.labels, b.labels) and a.ids == b.ids)


def native_vs_python(path, train_rows):
    """The part dir's test rows, as one file, through the native encoder
    at 1 thread and at the host's default, and through the port's Python
    path: the same table bit for bit; each one's host time."""
    from avenir_tpu_torch import native
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.native import loader as L
    from avenir_tpu_torch.utils.dataset import Featurizer
    from avenir_tpu_torch.utils.schema import FeatureSchema
    t0 = time.perf_counter()
    lib = native.build()
    native.load()
    build_s = time.perf_counter() - t0
    fz = Featurizer(FeatureSchema.from_json(G.elearn_schema_json()),
                    device="cpu").fit(train_rows)
    tables, secs = {}, {}
    for label, fn in (
            ("python", lambda: L.transform_file(fz, path, force_python=True)),
            ("native, 1 thread", lambda: L.encode_file(fz, path,
                                                       n_threads=1)),
            ("native, default threads", lambda: L.encode_file(fz, path))):
        t0 = time.perf_counter()
        tables[label] = fn()
        secs[label] = time.perf_counter() - t0
    ref = tables["python"]
    for label, table in tables.items():
        if not bits_equal(table, ref):
            raise AssertionError(f"{label} encode differs from the Python "
                                 "path's table")
    log(f"phase 3 native encode ({lib.name}, g++ {build_s:.1f} s, "
        f"{os.cpu_count()} host cores) of {ref.n_rows} elearn rows: "
        "binned, numeric, labels and ids bit-identical to the Python path; "
        "host time " + ", ".join(f"{label} {t:.3f} s"
                                 for label, t in secs.items())
        + f"; Python over native default {secs['python'] / secs['native, default threads']:.1f}x")


def write_parts(directory, rows):
    os.makedirs(directory)
    for i in range(PART_FILES):
        write_csv(os.path.join(directory, f"part-{i:05d}"),
                  rows[i * PART_ROWS:(i + 1) * PART_ROWS])
    open(os.path.join(directory, "_SUCCESS"), "w").close()


def plant_bad_rows(rows, rng):
    """A copy of ``rows`` with one in ``BAD_EVERY`` of each part made bad:
    ragged, non-numeric and unseen-class rows in turn (elearn's one
    categorical column is its class). Returns the rows and the planted
    {(part file, physical line): (id, reason)}."""
    rows = [list(r) for r in rows]
    planted = {}
    reasons = ("ragged", "non-numeric", "unseen-class")
    for part in range(PART_FILES):
        picks = rng.choice(PART_ROWS, PART_ROWS // BAD_EVERY, replace=False)
        for j, r in enumerate(sorted(picks)):
            row = rows[part * PART_ROWS + r]
            reason = reasons[j % 3]
            planted[(f"part-{part:05d}", int(r) + 1)] = (row[0], reason)
            if reason == "ragged":
                rows[part * PART_ROWS + r] = row[:3]
            elif reason == "non-numeric":
                row[4] = "n/a"
            else:
                row[-1] = "withdrawn"
    return rows, planted


def part_file_jobs(p, job, knn_conf, n_attrs):
    """NearestNeighbor over the part dir: the shard-by-shard path (K2 once
    a shard, each call held against plain) byte-identical to the merged
    path; the quarantine of planted bad rows; a resume after three shard
    records were lost."""
    from avenir_tpu_torch.datagen import generators as G
    n_test = PART_FILES * PART_ROWS
    rows = G.elearn_rows(n_test, seed=SEED + 2)
    write_csv(p("elearn_parts_test.csv"), rows)
    native_vs_python(p("elearn_parts_test.csv"),
                     [line.split(",") for line in
                      open(p("elearn_train.csv")).read().splitlines()])
    write_parts(p("elearn_parts"), rows)
    knn = ["NearestNeighbor", p("elearn_parts")]
    label = (f"NearestNeighbor elearn {ELEARN_TRAIN}x{n_test} part dir of "
             f"{PART_FILES} files")
    sharded, sharded_s = job(label, knn + [p("knn_parts.txt")] + knn_conf,
                             0.8, ["K2"], n_attrs=n_attrs,
                             launches={"K2": PART_FILES})
    merged, merged_s = job(label + " shard.prefetch=false",
                           knn + [p("knn_merged.txt")] + knn_conf
                           + ["-D", "shard.prefetch=false"], 0.8, ["K2"],
                           n_attrs=n_attrs, launches={"K2": 1})
    clean = open(p("knn_parts.txt"), "rb").read()
    if clean != open(p("knn_merged.txt"), "rb").read() or sharded != merged:
        raise AssertionError("part-file KNN output or report differs from "
                             "the merged path's")
    log(f"phase 3 part dir: output and Validation JSON byte-identical to the "
        f"merged path; job wall part-file {sharded_s:.2f} s, merged "
        f"{merged_s:.2f} s ({merged_s / sharded_s:.2f}x)")
    profile_job(label, knn + [p("knn_parts_prof.txt")] + knn_conf,
                "topk_kernel")

    bad_rows, planted = plant_bad_rows(rows, np.random.default_rng(SEED))
    write_parts(p("elearn_parts_bad"), bad_rows)
    report, _ = job(label + ", 1% bad rows, on.bad.row=quarantine",
                 ["NearestNeighbor", p("elearn_parts_bad"),
                  p("knn_parts_bad.txt")] + knn_conf
                 + ["-D", "on.bad.row=quarantine"], None, ["K2"],
                 n_attrs=n_attrs, launches={"K2": PART_FILES})
    gone = {row_id for row_id, _ in planted.values()}
    want = [line for line in clean.decode().splitlines()
            if line.split(",")[0] not in gone]
    if open(p("knn_parts_bad.txt")).read().splitlines() != want:
        raise AssertionError("quarantine: surviving rows differ from the "
                             "clean run's")
    if report.get("rows_quarantined") != len(planted):
        raise AssertionError(f"quarantine report {report}, planted "
                             f"{len(planted)}")
    listed = {}
    qdir = p("elearn_parts_bad/quarantine")
    for name in sorted(os.listdir(qdir)):
        for line in open(os.path.join(qdir, name)):
            rec = json.loads(line)
            listed[(os.path.basename(rec["file"]), rec["line"])] = \
                rec["reason"]
    if listed != {k: reason for k, (_, reason) in planted.items()}:
        raise AssertionError("quarantine sidecars do not list exactly the "
                             "planted rows")
    log(f"phase 3 quarantine: {len(planted)} planted rows ("
        f"{PART_FILES} parts, ragged, non-numeric, unseen-class) reported "
        f"and listed in {len(os.listdir(qdir))} sidecars exactly; the "
        "surviving rows' output equals the clean run's lines")

    out = p("knn_parts_resume.txt")
    keep = ["-D", "shard.journal.keep=true"]
    job(label + " shard.journal.keep=true", knn + [out] + knn_conf + keep,
        0.8, ["K2"], n_attrs=n_attrs, launches={"K2": PART_FILES})
    journal = out + ".shards"
    dropped = (1, 4, 6)
    nonces = {i: json.load(open(f"{journal}/shard-{i:05d}.json"))["run"]
              for i in range(PART_FILES)}
    for i in dropped:
        os.remove(f"{journal}/shard-{i:05d}.json")
    report, _ = job(label + " --resume after 3 lost shard records",
                 knn + [out] + knn_conf + keep + ["--resume"], None, ["K2"],
                 n_attrs=n_attrs, launches={"K2": len(dropped)})
    after = {i: json.load(open(f"{journal}/shard-{i:05d}.json"))["run"]
             for i in range(PART_FILES)}
    if (open(out, "rb").read() != clean
            or report.get("shards_resumed") != PART_FILES - len(dropped)
            or report.get("shards_computed") != len(dropped)
            or any(after[i] != nonces[i] for i in range(PART_FILES)
                   if i not in dropped)
            or any(after[i] == nonces[i] for i in dropped)):
        raise AssertionError(f"resume: report {report}, output equal "
                             f"{open(out, 'rb').read() == clean}")
    log(f"phase 3 resume: shards_resumed {report['shards_resumed']}, "
        f"shards_computed {report['shards_computed']}, output byte-identical, "
        f"the {PART_FILES - len(dropped)} kept records' nonces unchanged")


def mi_card_vs_cpu(p, hosp_conf, churn_conf):
    """MI and correlation on small inputs, card against CPU: the MI count
    families equal, the MI output values within rtol 1e-5 (f32 logs of
    the two devices differ in the last ulps; atol 1e-6 for values near 0,
    where cancellation leaves no relative precision), the correlation
    files byte-identical (numpy statistics over equal counts)."""
    from avenir_tpu_torch.cli.main import main
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.explore import mutual_information as mi
    from avenir_tpu_torch.utils.dataset import Featurizer
    from avenir_tpu_torch.utils.schema import FeatureSchema
    rows = [line.split(",") for line in
            open(p("hosp_small.csv")).read().splitlines()]
    schema = FeatureSchema.from_json(G._HOSP_SCHEMA_JSON)
    dists = {dev: mi.compute_distributions(
        Featurizer(schema, device=dev).fit(rows).transform(rows))
        for dev in ("cuda", "cpu")}
    for family in ("class_counts", "feature", "feature_class",
                   "feature_pair", "feature_pair_class"):
        if not np.array_equal(getattr(dists["cuda"], family),
                              getattr(dists["cpu"], family)):
            raise AssertionError(f"MI {family} differs card vs CPU")
    outs = {}
    for dev in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            main(["MutualInformation", p("hosp_small.csv"), p(f"mi_{dev}.txt"),
                  *hosp_conf, "--device", dev])
            for verb in ("CramerCorrelation",
                         "HeterogeneityReductionCorrelation"):
                main([verb, p("churn_small.csv"), p(f"{verb}_{dev}.txt"),
                      *churn_conf, "-D", "correlation.attr.pairs=3:6,2:6,1:2",
                      "--device", dev])
        outs[dev] = {name: open(p(f"{name}_{dev}.txt")).read() for name in
                     ("mi", "CramerCorrelation",
                      "HeterogeneityReductionCorrelation")}
    mi_err = 0.0
    card_lines = outs["cuda"]["mi"].splitlines()
    cpu_lines = outs["cpu"]["mi"].splitlines()
    if len(card_lines) != len(cpu_lines):
        raise AssertionError("MI output line counts differ card vs CPU")
    for a, b in zip(card_lines, cpu_lines):
        fa, fb = a.split(","), b.split(",")
        va, vb = float(fa[-1]), float(fb[-1])
        if fa[:-1] != fb[:-1] or not abs(va - vb) <= 1e-6 + 1e-5 * abs(vb):
            raise AssertionError(f"MI output differs card vs CPU: {a} / {b}")
        mi_err = max(mi_err, abs(va - vb))
    for verb in ("CramerCorrelation", "HeterogeneityReductionCorrelation"):
        if outs["cuda"][verb] != outs["cpu"][verb]:
            raise AssertionError(f"{verb} output differs card vs CPU")
    log(f"phase 3 card vs CPU (hosp 3000-row MI, churn 2000-row "
        f"correlation): MI families equal, {len(card_lines)} MI lines in the "
        f"same order, max abs diff {mi_err:.3g}; correlation files "
        "byte-identical")


def cli_phase(work: str):
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.ops import cuda_distance, cuda_fused, cuda_histogram
    counters = {"K1": [cuda_histogram.class_feature_bin_counts],
                "K2": [cuda_distance.topk_raw],
                "K3": [cuda_fused.fused_topk_raw],
                "K4": [cuda_histogram.pair_counts_multi],
                "K4-one": [cuda_histogram.pair_counts]}
    totals = {name: 0 for name in counters}

    def job(label, args, bar, must_launch, n_attrs=None, launches=None):
        calls = []
        for fns in counters.values():
            for fn in fns:
                fn.launches = 0
        t0 = time.perf_counter()
        with recording(calls):
            report = run_cli(args + ["--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {name: sum(fn.launches for fn in fns)
                  for name, fns in counters.items()}
        for name, c in counts.items():
            totals[name] += c
        missing = [name for name in must_launch if counts[name] < 1]
        if missing:
            raise AssertionError(f"{label}: {missing} not launched")
        for name, want in (launches or {}).items():
            if counts[name] != want:
                raise AssertionError(f"{label}: {name} launched "
                                     f"{counts[name]} times, not {want}")
        acc = report.get("Validation.Accuracy")
        if bar is not None and not (acc is not None and acc > bar):
            raise AssertionError(f"{label}: accuracy {acc} not above {bar}")
        log(f"phase 3 {label}: {secs:.2f} s, launches {counts}"
            + (f", accuracy {acc:.4f} (bar {bar})" if bar else ""))
        hold_main_path(label, calls, n_attrs)
        return report, secs

    p = lambda name: os.path.join(work, name)  # noqa: E731
    churn = G.churn_rows(CHURN_TRAIN + CHURN_TEST, seed=SEED)
    write_csv(p("churn_train.csv"), churn[:CHURN_TRAIN])
    write_csv(p("churn_test.csv"), churn[CHURN_TRAIN:])
    write_csv(p("churn_small.csv"), churn[:2000])
    with open(p("churn.json"), "w") as fh:
        json.dump(G._CHURN_SCHEMA_JSON, fh)
    with open(p("churn.properties"), "w") as fh:
        fh.write(f"field.delim.regex=,\nfield.delim=,\n"
                 f"feature.schema.file.path={p('churn.json')}\n"
                 f"bayesian.model.file.path={p('model.txt')}\n"
                 f"train.data.path={p('churn_train.csv')}\n"
                 "validation.mode=true\npositive.class.value=closed\n"
                 "laplace.smoothing=1.0\n")
    elearn = G.elearn_rows(ELEARN_TRAIN + ELEARN_TEST, seed=SEED)
    write_csv(p("elearn_train.csv"), elearn[:ELEARN_TRAIN])
    write_csv(p("elearn_test.csv"), elearn[ELEARN_TRAIN:])
    with open(p("elearn.json"), "w") as fh:
        json.dump(G.elearn_schema_json(), fh)
    with open(p("knn.properties"), "w") as fh:
        fh.write(f"field.delim.regex=,\n"
                 f"feature.schema.file.path={p('elearn.json')}\n"
                 f"train.data.path={p('elearn_train.csv')}\n"
                 "top.match.count=5\nkernel.function=none\n"
                 "distance.scale=1000\nvalidation.mode=true\n"
                 "positive.class.value=fail\n")
    from avenir_tpu_torch.utils.schema import FeatureSchema
    churn_attrs = len(FeatureSchema.from_json(
        G._CHURN_SCHEMA_JSON).get_feature_fields())
    elearn_attrs = len(FeatureSchema.from_json(
        G.elearn_schema_json()).get_feature_fields())
    churn_conf = ["--conf", p("churn.properties")]
    knn_conf = ["--conf", p("knn.properties")]

    # the tutorials' planted-signal bars (tests/test_tutorials.py)
    job(f"BayesianDistribution churn {CHURN_TRAIN} rows",
        ["BayesianDistribution", p("churn_train.csv"), p("model.txt")]
        + churn_conf, None, ["K1"])
    job(f"BayesianPredictor churn {CHURN_TEST} rows",
        ["BayesianPredictor", p("churn_test.csv"), p("pred.txt")]
        + churn_conf, 0.75, [])
    shape = f"{ELEARN_TRAIN}x{ELEARN_TEST}"
    job(f"NearestNeighbor elearn {shape} staged",
        ["NearestNeighbor", p("elearn_test.csv"), p("knn_staged.txt")]
        + knn_conf, 0.8, ["K2"], n_attrs=elearn_attrs)
    job(f"NearestNeighbor elearn {shape} feed.chunk.rows={FEED_CHUNK_ROWS}",
        ["NearestNeighbor", p("elearn_test.csv"), p("knn_fused.txt")]
        + knn_conf + ["-D", f"feed.chunk.rows={FEED_CHUNK_ROWS}"], 0.8,
        ["K3"], n_attrs=elearn_attrs)
    with open(p("knn_staged.txt"), "rb") as a, \
            open(p("knn_fused.txt"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("staged (K2) and fused (K3) KNN outputs "
                                 "differ")
    log("phase 3 staged (K2) and chunked fused (K3) outputs byte-identical")
    # knn.quantized and knn.ann take precedence over K2 and K3; the index
    # build counts its lists with K1
    for key, tag, must in (("knn.quantized", "quant", []),
                           ("knn.ann", "ann", ["K1"])):
        for chunk in (0, FEED_CHUNK_ROWS):
            feed = [] if not chunk else ["-D", f"feed.chunk.rows={chunk}"]
            job(f"NearestNeighbor elearn {shape} {key}=true"
                + (f" feed.chunk.rows={chunk}" if chunk else ""),
                ["NearestNeighbor", p("elearn_test.csv"),
                 p(f"knn_{tag}_{chunk}.txt")] + knn_conf
                + ["-D", f"{key}=true"] + feed, 0.8, must,
                n_attrs=elearn_attrs, launches={"K2": 0, "K3": 0})
        with open(p(f"knn_{tag}_0.txt"), "rb") as a, \
                open(p(f"knn_{tag}_{FEED_CHUNK_ROWS}.txt"), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{key}: chunked output differs from "
                                     "one-shot")
        log(f"phase 3 {key}=true: one-shot and chunked outputs "
            "byte-identical")
    part_file_jobs(p, job, knn_conf, elearn_attrs)
    job(f"NearestNeighbor churn {CHURN_TRAIN}x{CHURN_TEST} "
        "class.condtion.weighted",
        ["NearestNeighbor", p("churn_test.csv"), p("knn_churn.txt")]
        + churn_conf + ["-D", "class.condtion.weighted=true"], 0.75,
        ["K1", "K2"], n_attrs=churn_attrs)

    # mutual information and categorical correlation (K4)
    hosp = G.hosp_readmit_rows(HOSP_ROWS, seed=SEED)
    write_csv(p("hosp.csv"), hosp)
    write_csv(p("hosp_small.csv"), hosp[:3000])
    with open(p("hosp.json"), "w") as fh:
        json.dump(G._HOSP_SCHEMA_JSON, fh)
    with open(p("hosp.properties"), "w") as fh:
        fh.write(f"field.delim.regex=,\n"
                 f"feature.schema.file.path={p('hosp.json')}\n"
                 f"mi.score.algorithms={MI_ALGORITHMS}\n")
    hosp_conf = ["--conf", p("hosp.properties")]
    n_hosp = len(FeatureSchema.from_json(
        G._HOSP_SCHEMA_JSON).get_feature_fields())
    job(f"MutualInformation hosp {HOSP_ROWS} rows",
        ["MutualInformation", p("hosp.csv"), p("mi.txt")] + hosp_conf, None,
        ["K4"], launches={"K4": 1})
    mi_lines = [line.split(",") for line in
                open(p("mi.txt")).read().splitlines()]
    fc = {int(f[1]): float(f[2]) for f in mi_lines if f[0] == "featureClass"}
    ranked = collections.Counter(f[0] for f in mi_lines
                                 if f[0] in MI_ALGORITHMS.split(","))
    # followUp (ordinal 8, planted +0.08) over height (3, interaction only)
    if not (len(fc) == n_hosp and fc[8] > fc[3]
            and all(math.isfinite(v) for v in fc.values())):
        raise AssertionError(f"MI planted signal missing: featureClass {fc}")
    if sorted(ranked.values()) != [n_hosp] * 5:
        raise AssertionError(f"MI rankings incomplete: {dict(ranked)}")
    log(f"phase 3 MI planted signal: featureClass followUp(8) "
        f"{fc[8]:.6g} > height(3) {fc[3]:.6g}; five rankings of {n_hosp}")
    profile_job(f"MutualInformation hosp {HOSP_ROWS} rows",
                ["MutualInformation", p("hosp.csv"), p("mi_prof.txt")]
                + hosp_conf, "pair_counts_multi_kernel")

    job(f"CramerCorrelation churn {CHURN_TRAIN} rows pairs 3:6,2:6",
        ["CramerCorrelation", p("churn_train.csv"), p("cramer.txt")]
        + churn_conf + ["-D", "correlation.attr.pairs=3:6,2:6"], None,
        ["K4"], launches={"K4": 1})
    corr = {tuple(int(v) for v in line.split(",")[:2]):
            float(line.split(",")[2])
            for line in open(p("cramer.txt")).read().splitlines()}
    # CSCalls's planted shift is stronger than dataUsed's
    if not (0 <= corr[(2, 6)] <= 1 and 0 <= corr[(3, 6)] <= 1
            and corr[(3, 6)] > corr[(2, 6)] > 0.05):
        raise AssertionError(f"Cramer planted signal missing: {corr}")
    log(f"phase 3 Cramer planted signal: corr(3,6) {corr[(3, 6)]:.6g} > "
        f"corr(2,6) {corr[(2, 6)]:.6g} > 0.05")
    n_churn = len(FeatureSchema.from_json(
        G._CHURN_SCHEMA_JSON).get_feature_fields())
    n_pairs = n_churn * (n_churn - 1) // 2
    job(f"HeterogeneityReductionCorrelation churn {CHURN_TRAIN} rows, "
        f"{n_pairs} pairs",
        ["HeterogeneityReductionCorrelation", p("churn_train.csv"),
         p("hetero.txt")] + churn_conf, None, ["K4"],
        launches={"K4": 1})
    hetero = [float(line.split(",")[2])
              for line in open(p("hetero.txt")).read().splitlines()]
    # Goodman-Kruskal tau lies in [0, 1]; f32 rounding may put an
    # independent pair a few ulps below 0
    if len(hetero) != n_pairs or not all(
            math.isfinite(v) and -1e-6 <= v <= 1 + 1e-6 for v in hetero):
        raise AssertionError(f"heterogeneity output malformed: {hetero}")

    # card against CPU on a small input: same files
    small = G.elearn_rows(2500, seed=SEED + 1)
    write_csv(p("small_train.csv"), small[:2000])
    write_csv(p("small_test.csv"), small[2000:])
    outs = {}
    for dev in ("cuda", "cpu"):
        from avenir_tpu_torch.cli.main import main
        with contextlib.redirect_stdout(io.StringIO()):
            main(["NearestNeighbor", p("small_test.csv"), p(f"s_{dev}.txt"),
                  *knn_conf, "-D", f"train.data.path={p('small_train.csv')}",
                  "--device", dev])
            main(["BayesianDistribution", p("churn_small.csv"),
                  p(f"m_{dev}.txt"), *churn_conf, "--device", dev])
        outs[dev] = [open(p(f"{name}_{dev}.txt")).read()
                     for name in ("s", "m")]
    knn_rows = list(zip(outs["cuda"][0].splitlines(),
                        outs["cpu"][0].splitlines()))
    n_diff = sum(a != b for a, b in knn_rows)
    if n_diff > 0.01 * len(knn_rows) or outs["cuda"][1] != outs["cpu"][1]:
        raise AssertionError(f"card and CPU disagree: {n_diff} KNN rows, "
                             f"model equal {outs['cuda'][1] == outs['cpu'][1]}")
    log(f"phase 3 card vs CPU (elearn 2000x500 KNN, churn 2000-row NB): "
        f"KNN rows differing {n_diff}, NB model files identical")
    mi_card_vs_cpu(p, hosp_conf, churn_conf)
    log(f"kernels {json.dumps(totals)}")
    return totals


PLAN_TRAIN, PLAN_TEST = 1_048_576, 50_000
PLAN_MIN_SPLITS = 8
PLAN_CACHE_BYTES = 512 << 20   # plan.cache.budget.bytes' default


def _report_names(path):
    """The span, counter and gauge names of a ``--metrics-out`` report."""
    from avenir_tpu_torch.obs.exporters import read_jsonl
    return {e["name"]: e for e in read_jsonl(path)
            if e["type"] in ("span", "counter", "gauge")}


def _encode_ms(report, verb):
    """The host wall of a plan's encode and stage of its train table, from
    the report's spans."""
    return sum(e["sum_ms"] for name, e in report.items()
               if name.endswith((f"plan.{verb}.encode:train",
                                 f"plan.{verb}.stage:train")))


def plan_phase(dev, work):
    """Phase 13: the plan path of NB then KNN (see the module docstring).
    Returns the launches of K1, K2 and K3 in its plan-path jobs."""
    from avenir_tpu_torch import plan as tplan
    from avenir_tpu_torch.cli.main import main as cli_main
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.obs import exporters as tex
    from avenir_tpu_torch.ops import cuda_distance, cuda_fused, cuda_histogram
    counters = {"K1": cuda_histogram.class_feature_bin_counts,
                "K2": cuda_distance.topk_raw, "K3": cuda_fused.fused_topk_raw}
    totals = dict.fromkeys(counters, 0)
    p = lambda name: os.path.join(work, name)  # noqa: E731
    write_tiled(p("train.csv"), G.churn_rows(CHURN_TRAIN, seed=SEED + 13),
                PLAN_TRAIN)
    write_csv(p("test.csv"), G.churn_rows(PLAN_TEST, seed=SEED + 14))
    with open(p("schema.json"), "w") as fh:
        json.dump(G._CHURN_SCHEMA_JSON, fh)
    split_bytes = min(os.path.getsize(p("train.csv")),
                      os.path.getsize(p("test.csv"))) // PLAN_MIN_SPLITS
    workers = min(8, os.cpu_count() or 1)
    with open(p("job.properties"), "w") as fh:
        fh.write("".join(f"{k}={v}\n" for k, v in {
            "field.delim.regex": ",", "field.delim": ",",
            "feature.schema.file.path": p("schema.json"),
            "train.data.path": p("train.csv"), "validation.mode": "true",
            "positive.class.value": "closed", "laplace.smoothing": "1.0",
            "ingest.workers": workers, "ingest.split.bytes": split_bytes,
            "plan.cache.budget.bytes": PLAN_CACHE_BYTES}.items()))

    def run(label, verb, data, out, *extra, plan_on=True):
        """One job on the card: stdout, host wall s, launches, last_run."""
        for fn in counters.values():
            fn.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            if cli_main([verb, p(data), p(out), "--conf", p("job.properties"),
                         "--device", "cuda", *extra]) != 0:
                raise AssertionError(f"phase 13 {label} failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in counters.items()}
        if plan_on:
            for name, c in counts.items():
                totals[name] += c
        return buf.getvalue(), wall, counts, tplan.last_run()

    tplan.reset_cache()
    tex.hub().reset()
    nb = run("NB plan", "BayesianDistribution", "train.csv", "nb_plan.txt",
             "--metrics-out", p("nb.jsonl"))
    splits = nb[3]["ingest"]["train"]["splits"]
    knn = run("KNN plan", "NearestNeighbor", "test.csv", "knn_plan.txt",
              "--metrics-out", p("knn.jsonl"))
    outcomes = knn[3]["outcomes"]
    if (outcomes["encode:train"], outcomes["stage:train"]) != \
            ("skipped", "hit"):
        raise AssertionError(f"phase 13: KNN did not hit the staged train "
                             f"table: {outcomes}")
    test_splits = knn[3]["ingest"]["test"]["splits"]
    if min(splits, test_splits) < PLAN_MIN_SPLITS:
        raise AssertionError(f"phase 13: {splits} train and {test_splits} "
                             f"test splits, fewer than {PLAN_MIN_SPLITS}")
    names = set(_report_names(p("knn.jsonl"))) | \
        set(_report_names(p("nb.jsonl")))
    for want in ("plan.", "feed.h2d", "ingest.", "job."):
        if not any(want in n for n in names):
            raise AssertionError(f"phase 13: no {want} name in the reports")
    for path in (p("nb.jsonl.prom"), p("knn.jsonl.prom")):
        if not os.path.getsize(path):
            raise AssertionError(f"phase 13: {path} is empty")
    log(f"phase 13 plan path: NB {nb[1]:.2f} s ({splits} splits x "
        f"{workers} workers, launches {nb[2]}), KNN {knn[1]:.2f} s with "
        f"the warm staged train table ({test_splits} test splits, "
        f"launches {knn[2]}, outcomes {outcomes}); report names hold "
        "plan.*, feed.h2d, ingest.*, job.*")

    # NB's encode with the split pool against one thread of the Python
    # featurizer (ingest.parallel=false), a cold cache each
    tplan.reset_cache()
    tex.hub().reset()
    serial = run("NB serial encode", "BayesianDistribution", "train.csv",
                 "nb_serial.txt", "-D", "ingest.parallel=false",
                 "--metrics-out", p("nb_serial.jsonl"), plan_on=False)
    same_bytes("phase 13 NB serial encode", p("nb_serial.txt"),
               p("nb_plan.txt"))
    par_ms = _encode_ms(_report_names(p("nb.jsonl")), "BayesianDistribution")
    ser_ms = _encode_ms(_report_names(p("nb_serial.jsonl")),
                        "BayesianDistribution")
    st = nb[3]["ingest"]["train"]
    log(f"phase 13 NB encode of {PLAN_TRAIN:,} rows (host wall): parallel "
        f"{par_ms:.1f} ms ({workers} workers), ingest.parallel=false "
        f"{ser_ms:.1f} ms, {ser_ms / max(par_ms, 1e-9):.2f}x; the pool's "
        f"sums over its splits: read {st['decode_ms']:.1f} ms, encode "
        f"{st['encode_ms']:.1f} ms, the caller's wait {st['wait_ms']:.1f} "
        f"ms (ingest.overlap_fraction {st['overlap_fraction']:.4f}); feed "
        f"{st['feed']['chunks']} chunks, staging {st['feed']['h2d_ms']} ms")

    # the hand-wired bodies: the same bytes, the same launches
    off = {}
    for verb, data, out in (("BayesianDistribution", "train.csv", "nb"),
                            ("NearestNeighbor", "test.csv", "knn")):
        off[out] = run(f"{out} plan.enable=false", verb, data,
                       f"{out}_off.txt", "-D", "plan.enable=false",
                       plan_on=False)
        same_bytes(f"phase 13 {out} plan against plan.enable=false",
                   p(f"{out}_plan.txt"), p(f"{out}_off.txt"))
    if off["nb"][0] != nb[0] or off["knn"][0] != knn[0]:
        raise AssertionError("phase 13: stdout differs from the "
                             "plan.enable=false run")
    if (off["nb"][2]["K1"], off["knn"][2]["K2"]) != (nb[2]["K1"],
                                                     knn[2]["K2"]) \
            or nb[2]["K1"] < 1 or knn[2]["K2"] < 1:
        raise AssertionError(f"phase 13: launches differ: plan NB "
                             f"{nb[2]}, KNN {knn[2]}; off NB {off['nb'][2]},"
                             f" KNN {off['knn'][2]}")
    log(f"phase 13 plan.enable=false: NB {off['nb'][1]:.2f} s, KNN "
        f"{off['knn'][1]:.2f} s; files, stdout and K1/K2 launches equal "
        "to the plan path's")

    # K3 through the threaded DeviceFeed (the train table hits the cache
    # the NB run above refilled)
    fed = {}
    for depth in (2, 1):
        tex.hub().reset()
        fed[depth] = run(f"KNN feed.depth={depth}", "NearestNeighbor",
                         "test.csv", f"knn_fed{depth}.txt", "-D",
                         f"feed.chunk.rows={FEED_CHUNK_ROWS}", "-D",
                         f"feed.depth={depth}", "--metrics-out",
                         p(f"fed{depth}.jsonl"))
        if fed[depth][2]["K3"] < 1:
            raise AssertionError(f"phase 13: K3 not launched at feed.depth="
                                 f"{depth}")
    same_bytes("phase 13 feed.depth=2 against 1", p("knn_fed2.txt"),
               p("knn_fed1.txt"))
    overlap = {d: _report_names(p(f"fed{d}.jsonl"))[
        "feed.overlap_fraction"]["value"] for d in fed}
    log(f"phase 13 KNN feed.chunk.rows={FEED_CHUNK_ROWS}: depth 2 "
        f"{fed[2][1]:.2f} s, depth 1 {fed[1][1]:.2f} s (host wall), "
        f"launches {fed[2][2]}, feed.overlap_fraction depth 2 "
        f"{overlap[2]:.4f}, depth 1 {overlap[1]:.4f}; files equal")

    # a table staged on the CPU serves no job on the card, and
    # --profile-dir's traces name the kernels: NB with --device cpu, then
    # NB and KNN on the card in this process, each with --profile-dir, on
    # the test rows as both tables. The card's NB misses the CPU's table
    # and launches K1; KNN hits the card's table and launches K2. The two
    # card jobs run once more in a fresh process, as a user runs the CLI.
    with open(p("job.properties")) as fh:
        props = fh.read().replace(p("train.csv"), p("test.csv"))
    with open(p("profile.properties"), "w") as fh:
        fh.write(props)

    def job(verb, tag, on):
        return [verb, p("test.csv"), p(f"{tag}_{verb}.txt"), "--conf",
                p("profile.properties"), "--device", on] + (
            ["--profile-dir", p(f"trace-{tag}-{verb}")] if on == "cuda"
            else [])

    tplan.reset_cache()
    with contextlib.redirect_stdout(io.StringIO()):
        if cli_main(job("BayesianDistribution", "cpu", "cpu")) != 0:
            raise AssertionError("phase 13: NB --device cpu failed")
    mixed = {}
    for verb, must, stage in (("BayesianDistribution", "K1", "miss"),
                              ("NearestNeighbor", "K2", "hit")):
        for fn in counters.values():
            fn.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            if cli_main(job(verb, "inproc", "cuda")) != 0:
                raise AssertionError(f"phase 13 {verb} --profile-dir "
                                     "failed")
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counters.items()}
        outcome = tplan.last_run()["outcomes"]["stage:train"]
        if counts[must] < 1 or outcome != stage:
            raise AssertionError(
                f"phase 13: {verb} on the card after NB on the CPU: "
                f"launches {counts}, stage:train {outcome} (want {must} "
                f"launched, stage:train {stage})")
        mixed[verb] = (counts, outcome)
    same_bytes("phase 13 NB on the card against the CPU",
               p("inproc_BayesianDistribution.txt"),
               p("cpu_BayesianDistribution.txt"))
    log("phase 13 NB --device cpu then on the card: " + "; ".join(
        f"{verb} launches {c}, stage:train {o}"
        for verb, (c, o) in mixed.items())
        + "; NB's model equal to the CPU's")
    # each fresh process runs one card job: its trace is the process's
    # first profiler session. In a process that profiled before,
    # torch.profiler can place the card's records outside the session and
    # drop them (PERF.md §7), so only the fresh traces must name the
    # kernels; the in-process ones must exist and hold the job's host ops,
    # and trace() warns where they name no kernel
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from avenir_tpu_torch.cli.main "
         "import main; sys.exit(main(" + repr(job(verb, "fresh", "cuda"))
         + "))"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for verb in ("BayesianDistribution", "NearestNeighbor")]
    errs = []
    try:
        for proc in procs:
            errs.append(proc.communicate(timeout=600)[1])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if any(proc.returncode != 0 for proc in procs):
        raise AssertionError(f"phase 13 --profile-dir failed: "
                             f"{[e[-2000:] for e in errs]}")
    wall = time.perf_counter() - t0
    for tag in ("inproc", "fresh"):
        for verb, kernel in (("BayesianDistribution", "cfb_counts_kernel"),
                             ("NearestNeighbor", "topk_kernel")):
            tdir = p(f"trace-{tag}-{verb}")
            (trace,) = [os.path.join(tdir, f) for f in os.listdir(tdir)]
            with open(trace) as fh:
                events = json.load(fh)["traceEvents"]
            hits = [e for e in events if kernel in str(e.get("name", ""))
                    and e.get("cat") == "kernel"]
            host_ops = sum(e.get("cat") == "cpu_op" for e in events)
            if not host_ops or (tag == "fresh" and not hits):
                seen = sorted({str(e.get("name", ""))[:60] for e in events
                               if e.get("cat") == "kernel"})[:12]
                raise AssertionError(
                    f"phase 13: the {tag} --profile-dir trace of {verb} "
                    f"holds {host_ops} host ops and no {kernel} kernel "
                    f"event (kernel events {seen})")
            log(f"phase 13 --profile-dir {verb} ({tag}): {len(events)} "
                f"trace events, {host_ops} host ops, {len(hits)} {kernel} "
                f"kernel events ({os.path.getsize(trace) / 2**20:.1f} MiB)")
    log(f"phase 13 --profile-dir: the card's jobs in this process, and "
        f"each in a fresh one ({wall:.1f} s host wall)")

    # --explain: the plan printed, nothing launched
    explained = run("KNN --explain", "NearestNeighbor", "test.csv",
                    "explained.txt", "--explain", plan_on=False)
    if any(explained[2].values()) or "plan NearestNeighbor" not in \
            explained[0] or os.path.exists(p("explained.txt")):
        raise AssertionError(f"phase 13: --explain ran work: "
                             f"{explained[2]}")
    log(f"phase 13 --explain: {len(explained[0].splitlines())} lines, "
        f"launches {explained[2]}")
    tplan.reset_cache()
    return totals


# phase 14: the online bandit loop (ReinforcementLearnerTopology)
# E events through the verb (the card's legs and the --device cpu legs in
# processes side by side), the events of run() timed alone on the card,
# and the step() events the simulator drives
ONLINE_EVENTS = 4096
ONLINE_RATE_EVENTS = 1024
ONLINE_STEPS = 256
ONLINE_TYPES = ("randomGreedy", "upperConfidenceBoundOne",
                "upperConfidenceBoundTwo", "softMax", "actionPursuit",
                "rewardComparison", "exponentialWeight", "sampsonSampler",
                "optimisticSampsonSampler", "intervalEstimator")
ONLINE_PROFILED = ("randomGreedy", "softMax", "upperConfidenceBoundTwo")
# the card legs that each take a process of their own: their 64-step
# scans take most of the legs' time; the rest run in the script's process
ONLINE_OWN_PROCESS = ("upperConfidenceBoundOne", "upperConfidenceBoundTwo")
ONLINE_CONF = {"random.selection.prob": 0.5,
               "prob.reduction.algorithm": "linear",
               "prob.reduction.constant": 150, "reward.scale": 100}


def online_inputs(work, n_events):
    """The tutorial-shaped event file (one session id a line) and a reward
    file of ``LeadGenSimulator`` rewards (``action,reward``) over its three
    actions, a reward for every fourth event."""
    from avenir_tpu_torch.datagen import LeadGenSimulator
    sim = LeadGenSimulator(sel_count_threshold=1, seed=SEED % 1000)
    rng = np.random.default_rng(SEED)
    events = os.path.join(work, "events.txt")
    rewards = os.path.join(work, "rewards.txt")
    with open(events, "w") as fh:
        fh.write("".join(sim.next_event_id() + "\n"
                         for _ in range(n_events)))
    with open(rewards, "w") as fh:
        for _ in range(n_events // 4):
            action, reward = sim.observe_action(
                sim.actions[int(rng.integers(0, len(sim.actions)))])
            fh.write(f"{action},{reward}\n")
    return sim.actions, events, rewards


def online_properties(work, actions, rewards) -> None:
    """The verb's ``rl.properties``: the actions, the reward file, seed 7
    and ``ONLINE_CONF``."""
    with open(os.path.join(work, "rl.properties"), "w") as fh:
        fh.write(f"action.list={','.join(actions)}\n"
                 f"reward.data.path={rewards}\nrandom.seed=7\n"
                 + "".join(f"{k}={v}\n" for k, v in ONLINE_CONF.items()))


def online_loop(learner_type, actions, events, rewards, on, n_events=None,
                **kw):
    """An ``OnlineLearnerLoop`` on ``on`` over in-process queues filled
    from the event and reward files, as the verb fills them; with
    ``n_events``, the first ``n_events`` events and a quarter as many
    rewards (the files' ratio)."""
    from avenir_tpu_torch.stream.loop import InProcQueues, OnlineLearnerLoop
    queues = kw.pop("queues", None) or InProcQueues()
    loop = OnlineLearnerLoop(learner_type, actions,
                             dict(ONLINE_CONF, **{"random.seed": 7}),
                             queues, seed=7, device=on, **kw)
    fill_online_queues(queues, events, rewards, loop.resumed_events,
                       n_events)
    return loop


def online_engine(learner_type, actions, events, rewards, on, n_events=None,
                  **kw):
    """A ``ServingEngine`` on ``on`` over queues filled as
    :func:`online_loop`'s."""
    from avenir_tpu_torch.stream.engine import ServingEngine
    from avenir_tpu_torch.stream.loop import InProcQueues
    queues = kw.pop("queues", None) or InProcQueues()
    engine = ServingEngine(learner_type, actions,
                           dict(ONLINE_CONF, **{"random.seed": 7}), queues,
                           seed=7, device=on, **kw)
    fill_online_queues(queues, events, rewards, 0, n_events)
    return engine


def fill_online_queues(queues, events, rewards, skip, n_events):
    """The event file's ids past the first ``skip`` and the reward file's
    pairs into ``queues`` (the first ``n_events`` ids and a quarter as many
    rewards where it is given)."""
    from avenir_tpu_torch.stream.loop import InProcQueues
    with open(events) as fh:
        event_ids = fh.read().split()[skip:]
    with open(rewards) as fh:
        reward_lines = fh.read().split()
    if n_events is not None:
        event_ids = event_ids[:n_events]
        reward_lines = reward_lines[:n_events // 4]
    if isinstance(queues, InProcQueues):
        for line in event_ids:
            queues.push_event(line)
        for line in reward_lines:
            action, reward = line.split(",")
            queues.push_reward(action, float(reward))
        return
    # a broker: one multi-value LPUSH a chunk (left to right, as pushes
    # one by one)
    for i in range(0, len(event_ids), 512):
        queues._r.lpush(queues.event_queue, *event_ids[i:i + 512])
    for i in range(0, len(reward_lines), 512):
        queues._r.lpush(queues.reward_queue,
                        *[f"{a},{float(r)}" for a, r in (
                            line.split(",") for line in
                            reward_lines[i:i + 512])])


def drain_actions(queues):
    out = []
    while True:
        entry = queues.pop_action()
        if entry is None:
            return out
        out.append(entry)


def online_profile_child(events, rewards) -> None:
    """Run in a fresh process (its first profiler session keeps the card's
    records, PERF.md §7): one 64-event ``run()`` batch of each of
    ``ONLINE_PROFILED`` on the card under ``torch.profiler``, after a
    batch of warm-up; prints one JSON line: the torch ops, the card's
    kernels and the busy share (kernel time over the batch's wall) of
    each. It sets up (imports, the card's context, the loops and their
    queues) while the parent works, and touches the card only once a line
    arrives on its stdin."""
    from torch.profiler import ProfilerActivity, profile
    from avenir_tpu_torch.datagen import LeadGenSimulator
    actions = LeadGenSimulator().actions
    torch.cuda.init()
    loops = {t: online_loop(t, actions, events, rewards, "cuda")
             for t in ONLINE_PROFILED}
    sys.stdin.readline()
    out = {}
    for learner_type, loop in loops.items():
        loop.run(max_events=64)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loop.run(max_events=64)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        path = os.path.join(tempfile.mkdtemp(), "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)["traceEvents"]
        ops = sum(1 for e in trace if e.get("cat") == "cpu_op"
                  and str(e.get("name", "")).startswith("aten::"))
        device = [e for e in trace if e.get("cat") in (
            "kernel", "gpu_memcpy", "gpu_memset")]
        out[learner_type] = {
            "ops": ops, "kernels": len(device),
            "busy": sum(e.get("dur", 0) for e in device) / 1e6 / wall,
            "wall_ms": wall * 1e3}
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    print(json.dumps(out), flush=True)


def online_verb_legs(work, events, on, types=ONLINE_TYPES, child=False,
                     engine=False):
    """ReinforcementLearnerTopology for each of ``types`` on ``on`` into
    ``actions-<type>-<on>.txt`` (with ``engine``, ``serving.engine=true``
    into ``engine-<type>-<on>.txt``): {type: (JSON line, host wall s)};
    on the CPU, without ``engine``, also ``step()``'s drive (``"step"``).
    A child process prints it as JSON."""
    from avenir_tpu_torch.cli.main import main as cli_main
    out = {}
    for learner_type in types:
        path = os.path.join(work, f"{'engine' if engine else 'actions'}-"
                                  f"{learner_type}-{on}.txt")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["ReinforcementLearnerTopology", events, path,
                          "--conf", os.path.join(work, "rl.properties"),
                          "-D", f"learner.type={learner_type}",
                          "-D", f"serving.engine={str(engine).lower()}",
                          "--device", on])
        if on == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"phase {15 if engine else 14} "
                                 f"{learner_type} on {on}: exit {rc}")
        out[learner_type] = (buf.getvalue(), wall)
    if on == "cpu" and not engine:
        out["step"] = online_step_drive("cpu")
    if child:
        print(json.dumps(out), flush=True)
    return out


def online_step_drive(on) -> dict:
    """``LeadGenSimulator.drive`` of ``ONLINE_STEPS`` events through
    ``step()`` on ``on`` (the tutorial's randomGreedy), then 25 more
    picks: the actions written, the picks, the rewards sent, the state
    (as lists) and the drive's host wall."""
    from avenir_tpu_torch.datagen import LeadGenSimulator
    from avenir_tpu_torch.stream.loop import InProcQueues, OnlineLearnerLoop
    sim = LeadGenSimulator(sel_count_threshold=5, seed=1)
    loop = OnlineLearnerLoop("randomGreedy", sim.actions, ONLINE_CONF,
                             InProcQueues(), seed=0, device=on)
    recorded = []
    pop = loop.queues.pop_action

    def pop_recorded():
        entry = pop()
        if entry is not None:
            recorded.append([entry[0], list(entry[1])])
        return entry
    loop.queues.pop_action = pop_recorded
    t0 = time.perf_counter()
    sent = sim.drive(loop, ONLINE_STEPS)
    if torch.device(on).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = [loop.learner.next_actions()[0] for _ in range(25)]
    state = {k: v.tolist() for k, v in loop.learner.state.to_numpy().items()}
    return {"picks": recorded, "after": after, "sent": sent,
            "state": state, "wall": wall}


def online_phase(dev, work):
    """Phase 14: ReinforcementLearnerTopology and the loop under it on the
    card, each against the CPU: the verb for each of the ten learners
    (actions files and JSON lines byte-equal), ``step()`` driven by the
    lead-generation simulator (the same picks, converging to the best
    action), the Redis wire over an in-process MiniRedis (the in-process
    queues' actions), a checkpoint resume (the saved state), and the
    loop's dispatch: decisions/s of ``run()`` and ``step()``, the torch ops
    and busy share of one 64-event ``run()`` batch. It launches none of
    the port's kernels: the learners are torch ops."""
    t_phase = time.perf_counter()
    actions, events, rewards = online_inputs(work, ONLINE_EVENTS)
    online_properties(work, actions, rewards)
    # the profiled batches' process sets up now and runs last, alone on
    # the card
    profiler = subprocess.Popen(
        [sys.executable, "-c", "import sys; import chip_smoke; "
         f"chip_smoke.online_profile_child({events!r}, {rewards!r})"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        return online_legs(dev, work, actions, events, rewards, profiler,
                           t_phase)
    finally:
        if profiler.poll() is None:
            profiler.kill()
            profiler.wait()


def online_wire_and_resume(dev, work, actions, events, rewards) -> str:
    """Phase 14's checks that time nothing: one loop over ``RedisQueues``
    on an in-process MiniRedis (a pending ledger armed) against the same
    loop over in-process queues, and a ``checkpoint.dir`` resume on the
    card; the line to log."""
    from avenir_tpu_torch.models.bandits.learners import FIELDS
    from avenir_tpu_torch.stream.loop import RedisQueues
    from avenir_tpu_torch.stream.miniredis import (
        MiniRedisClient, MiniRedisServer)
    server = MiniRedisServer("localhost", 0).start()
    try:
        client = MiniRedisClient("localhost", server.port)
        redis_q = RedisQueues(client=client, pending_queue="pendingQueue")
        loop = online_loop("softMax", actions, events, rewards, dev,
                           queues=redis_q)
        loop.run()
        wire = [raw.decode() for raw in reversed(
            client.lrange("actionQueue", 0, -1))]
        pending = client.llen("pendingQueue")
        client.close()
    finally:
        server.close()
    inproc = online_loop("softMax", actions, events, rewards, dev)
    inproc.run()
    local = [",".join([e] + sel) for e, sel in drain_actions(inproc.queues)]
    if wire != local or pending != 0:
        raise AssertionError(f"phase 14 Redis wire: {len(wire)} actions, "
                             f"{pending} pending, differ from in-process")

    # the restored state is the saved one, no reward folded twice
    ckdir = os.path.join(work, "ck")
    first = online_loop("exponentialWeight", actions, events, rewards, dev,
                        checkpoint_dir=ckdir, checkpoint_interval=256)
    first.run()
    first.close()
    resumed = online_loop("exponentialWeight", actions, events, rewards,
                          dev, checkpoint_dir=ckdir, checkpoint_interval=256)
    for name, _ in FIELDS:
        a, b = getattr(first.learner.state, name), \
            getattr(resumed.learner.state, name)
        if b.device != a.device or not torch.equal(a, b):
            raise AssertionError(f"phase 14 resume: state {name} differs")
    if resumed.resumed_events != ONLINE_EVENTS or \
            resumed.stats.rewards != first.stats.rewards:
        raise AssertionError(f"phase 14 resume: counters {resumed.stats}")
    resumed.run()
    if resumed.stats.rewards != first.stats.rewards:
        raise AssertionError("phase 14 resume folded a reward twice")
    resumed.close()
    return (f"phase 14 RedisQueues over MiniRedis: {len(wire)} actions "
            "equal to InProcQueues', pending ledger empty; checkpoint.dir "
            "resume on the card: state equal to the saved one at event "
            f"{resumed.resumed_events}, no reward folded twice")


def online_legs(dev, work, actions, events, rewards, profiler, t_phase):
    """Phase 14's legs (``online_phase``), the profiling process waiting
    for its go."""
    from avenir_tpu_torch.datagen import LeadGenSimulator

    def at():
        return f" [{time.perf_counter() - t_phase:.1f} s into the phase]"

    # the verb for each learner: with --device cpu in one process, on the
    # card for each of ONLINE_OWN_PROCESS in a process of its own and for
    # the rest in this one, side by side (the legs are host-bound: one
    # Python thread each, the card mostly idle); then, while those
    # processes finish, the checks that time nothing
    here = [t for t in ONLINE_TYPES if t not in ONLINE_OWN_PROCESS]
    children = {}
    for tag, on, types in [("cpu", "cpu", ONLINE_TYPES)] + [
            (t, "cuda", (t,)) for t in ONLINE_OWN_PROCESS]:
        children[tag] = subprocess.Popen(
            [sys.executable, "-c", "import torch; torch.set_num_threads(2); "
             "import chip_smoke; chip_smoke.online_verb_legs("
             f"{work!r}, {events!r}, {on!r}, {types!r}, child=True)"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        card = online_verb_legs(work, events, "cuda", here)
        checks = online_wire_and_resume(dev, work, actions, events, rewards)
        done = {}
        for tag, proc in children.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"phase 14 {tag} legs: {err[-2000:]}")
            done[tag] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    cpu = done.pop("cpu")
    for got in done.values():
        card.update(got)
    for learner_type in ONLINE_TYPES:
        same_bytes(f"phase 14 {learner_type} actions",
                   os.path.join(work, f"actions-{learner_type}-cuda.txt"),
                   os.path.join(work, f"actions-{learner_type}-cpu.txt"))
        if card[learner_type][0] != cpu[learner_type][0]:
            raise AssertionError(
                f"phase 14 {learner_type}: JSON lines differ: "
                f"{card[learner_type][0]!r} {cpu[learner_type][0]!r}")
    summary = json.loads(card["randomGreedy"][0])
    verb_walls = {t: card[t][1] for t in ONLINE_TYPES}
    log(f"phase 14 ReinforcementLearnerTopology, {ONLINE_EVENTS} events, "
        f"{summary['rewards']} rewards, 3 actions, 10 learners: actions "
        "files and JSON lines byte-identical to --device cpu; the verb's "
        "host wall (card / CPU, s; files, parsing and set-up included; "
        f"{', '.join(ONLINE_OWN_PROCESS)} in processes of their own, the "
        "CPU's legs in another, side by side): " + ", ".join(
            f"{t} {card[t][1]:.2f}/{cpu[t][1]:.2f}" for t in ONLINE_TYPES)
        + at())
    log(checks + at())

    # run() alone on the card, every other process done: the loop over
    # in-process queues filled before the clock starts; a learner whose
    # verb ran in another process first runs a 64-event warm-up loop here
    rates = {}
    for learner_type in ONLINE_TYPES:
        if learner_type in ONLINE_OWN_PROCESS:
            online_loop(learner_type, actions, events, rewards, dev,
                        n_events=64).run()
        loop = online_loop(learner_type, actions, events, rewards, dev,
                           n_events=ONLINE_RATE_EVENTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = loop.run()
        torch.cuda.synchronize()
        rates[learner_type] = ONLINE_RATE_EVENTS / (time.perf_counter() - t0)
        if stats.events != ONLINE_RATE_EVENTS or \
                stats.rewards != ONLINE_RATE_EVENTS // 4:
            raise AssertionError(f"phase 14 run() {learner_type}: {stats}")
    log(f"phase 14 run() decisions/s on the card (OnlineLearnerLoop.run "
        f"alone, host clock; {ONLINE_RATE_EVENTS} events in 64-event "
        f"batches, {ONLINE_RATE_EVENTS // 4} rewards folded first, "
        "in-process queues): " + ", ".join(
            f"{t} {r:.0f}" for t, r in rates.items()) + at())

    # step(): the simulator drives the loop one event at a time (the
    # CPU's drive ran in the --device cpu process)
    card_step = online_step_drive(dev)
    step_rate = ONLINE_STEPS / card_step["wall"]
    for key in ("picks", "after", "sent", "state"):
        if card_step[key] != cpu["step"][key]:
            raise AssertionError(f"phase 14 step(): the card's {key} differ "
                                 "from the CPU's")
    after = card_step["after"]
    best = max(set(after), key=after.count)
    if best != LeadGenSimulator().best_action:
        raise AssertionError(f"phase 14 step(): most picked {best}, not "
                             f"{LeadGenSimulator().best_action}")
    log(f"phase 14 step(): {ONLINE_STEPS} events driven by "
        f"LeadGenSimulator, {card_step['sent']} rewards: picks and state "
        f"equal to the CPU's, most picked {best}; {step_rate:.0f} "
        "decisions/s on the card (host clock)" + at())

    # one 64-event run() batch under torch.profiler, in the fresh process
    prof_out, prof_err = profiler.communicate("go\n", timeout=600)
    if profiler.returncode != 0:
        raise AssertionError(f"phase 14 profile: {prof_err[-2000:]}")
    prof = json.loads(prof_out.strip().splitlines()[-1])
    log("phase 14 one 64-event run() batch on the card (torch.profiler, a "
        "fresh process): " + "; ".join(
            f"{t} {v['ops']} torch ops, {v['kernels']} kernels and copies, "
            f"busy {v['busy']:.3f} of {v['wall_ms']:.1f} ms"
            for t, v in prof.items()) + at())
    if any(v["kernels"] < 1 for v in prof.values()):
        raise AssertionError(f"phase 14: a profiled batch ran nothing on "
                             f"the card: {prof}")
    log(f"phase 14 wall: {time.perf_counter() - t_phase:.1f} s")
    return {"run": rates, "verb_wall": verb_walls, "step": step_rate,
            "profile": prof}


# phase 15: the serving engine and the snapshot lifecycle. The engine's
# verb legs on the first ENGINE_SHORT_EVENTS of phase 14's ids (UCB1's and
# UCB2's in processes of their own, the other eight in a third; phase 14
# and engine_rates hold the engine against the loop), the dispatch under
# the sync check at ENGINE_SYNC_SIZES decisions, and the engine against
# run() on ENGINE_RATE_EVENTS prefilled ids (UCB1/UCB2 on
# ENGINE_RATE_UCB_EVENTS)
ENGINE_SHORT_EVENTS = 1024
ENGINE_SYNC_SIZES = (1, 64, 256, 64 + 9)
ENGINE_RATE_EVENTS = 1024
ENGINE_RATE_UCB_EVENTS = 256
ENGINE_ADMISSION_HIGH = 512


def engine_phase(dev, work):
    """Phase 15: the serving engine (``stream/engine.py``) and the snapshot
    lifecycle (``lifecycle/``) on the card: ``serving.engine=true``
    through the verb for each of the ten learners on the first
    ``ENGINE_SHORT_EVENTS`` ids, each actions file byte-equal to the
    first lines of phase 14's loop file on the card (the engine equals the
    loop on filled queues); the engine over ``RedisQueues`` on an
    in-process MiniRedis equal to its in-process file; each learner's
    ``next_action_batch_async`` under ``torch.cuda.set_sync_debug_mode
    ("error")``; a ``lifecycle.dir`` round trip and the ``Lifecycle``
    verb, card against CPU; the admission gate, card against CPU; and the
    engine's decisions/s against ``OnlineLearnerLoop.run()`` on the same
    prefilled events. Run alone (``python3 chip_smoke.py engine_phase``)
    it first writes phase 14's inputs and runs its loop legs on the card.
    It launches none of the port's kernels."""
    from avenir_tpu_torch.datagen import LeadGenSimulator
    t_phase = time.perf_counter()
    events = os.path.join(work, "events.txt")
    rewards = os.path.join(work, "rewards.txt")
    if not os.path.exists(os.path.join(work, "rl.properties")):
        actions, events, rewards = online_inputs(work, ONLINE_EVENTS)
        online_properties(work, actions, rewards)
        online_verb_legs(work, events, "cuda")
        log(f"phase 15 alone: phase 14's loop legs on the card "
            f"({time.perf_counter() - t_phase:.1f} s)")
    actions = LeadGenSimulator().actions
    short = os.path.join(work, "events-short.txt")
    with open(events) as fh:
        ids = fh.read().split()
    with open(short, "w") as fh:
        fh.write("".join(i + "\n" for i in ids[:ENGINE_SHORT_EVENTS]))
    # the verb legs on the short file in processes beside this one's
    # checks: UCB1 and UCB2 each in its own, the other eight in a third
    rest = tuple(t for t in ONLINE_TYPES if t not in ONLINE_OWN_PROCESS)
    legs = [(t,) for t in ONLINE_OWN_PROCESS] + [rest]
    children = {types: subprocess.Popen(
        [sys.executable, "-c", "import torch; torch.set_num_threads(2); "
         "import chip_smoke; chip_smoke.online_verb_legs("
         f"{work!r}, {short!r}, 'cuda', {types!r}, child=True, engine=True)"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for types in legs}
    card = {}
    try:
        checks = [engine_wire(dev, work, actions, events, rewards),
                  engine_dispatch_sync_free(dev, actions),
                  engine_lifecycle(work, short, rewards),
                  engine_admission(work, events)]
        for types, proc in children.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"phase 15 {', '.join(types)} legs: "
                                     f"{err[-2000:]}")
            card.update(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    n = ENGINE_SHORT_EVENTS
    for t in ONLINE_TYPES:
        with open(os.path.join(work, f"engine-{t}-cuda.txt")) as fh:
            got = fh.read().splitlines()
        with open(os.path.join(work, f"actions-{t}-cuda.txt")) as fh:
            want = fh.read().splitlines()[:n]
        line = json.loads(card[t][0])
        if got != want or len(got) != n:
            raise AssertionError(f"phase 15 {t}: the engine's actions "
                                 "differ from the loop's")
        overlap = line.pop("overlap_fraction")
        expect = {"events": n, "rewards": ONLINE_EVENTS // 4, "actions": n,
                  "batches": -(-n // 64)}
        if line != expect or not 0.0 <= overlap <= 1.0:
            raise AssertionError(f"phase 15 {t}: JSON line {card[t][0]!r}")
    log(f"phase 15 ReinforcementLearnerTopology serving.engine=true, ten "
        f"learners, the first {n} of phase 14's {ONLINE_EVENTS} events "
        f"({', '.join(ONLINE_OWN_PROCESS)} each in a process of its own, "
        "the other eight in a third, beside the checks below): "
        "actions files byte-identical to phase 14's loop files on the "
        "card; the verb's host wall (s; files and set-up included): "
        + ", ".join(f"{t} {card[t][1]:.2f}" for t in ONLINE_TYPES)
        + f" [{time.perf_counter() - t_phase:.1f} s into the phase]")
    for line in checks:
        log(line)
    rates = engine_rates(dev, actions, events, rewards)
    log(f"phase 15 wall: {time.perf_counter() - t_phase:.1f} s")
    return {"verb_wall": {t: card[t][1] for t in ONLINE_TYPES},
            "rates": rates}


def engine_wire(dev, work, actions, events, rewards) -> str:
    """softMax's engine over ``RedisQueues`` on an in-process MiniRedis (a
    pending ledger armed) against phase 14's in-process loop file."""
    from avenir_tpu_torch.stream.loop import RedisQueues
    from avenir_tpu_torch.stream.miniredis import (
        MiniRedisClient, MiniRedisServer)
    server = MiniRedisServer("localhost", 0).start()
    try:
        client = MiniRedisClient("localhost", server.port)
        queues = RedisQueues(client=client, pending_queue="pendingQueue")
        calls0 = client.calls
        stats = online_engine("softMax", actions, events, rewards, dev,
                              queues=queues).run()
        trips = client.calls - calls0
        wire = [raw.decode() for raw in reversed(
            client.lrange("actionQueue", 0, -1))]
        pending = client.llen("pendingQueue")
        client.close()
    finally:
        server.close()
    with open(os.path.join(work, "actions-softMax-cuda.txt")) as fh:
        local = fh.read().splitlines()
    if wire != local or pending != 0:
        raise AssertionError(f"phase 15 Redis wire: {len(wire)} actions, "
                             f"{pending} pending, differ from in-process")
    return (f"phase 15 engine over RedisQueues on MiniRedis: {len(wire)} "
            f"actions equal to the in-process loop's file (which the "
            f"in-process engine's equals), pending ledger empty, {trips} "
            f"broker round trips for {stats.batches} batches")


def engine_dispatch_sync_free(dev, actions) -> str:
    """Each learner's ``next_action_batch_async`` at ``ENGINE_SYNC_SIZES``
    under ``torch.cuda.set_sync_debug_mode("error")``: a synchronizing
    call raises there and fails the phase. The resolved actions equal a
    CPU learner's ``next_action_batch`` of the same sizes."""
    from avenir_tpu_torch.models.bandits.learners import Learner
    pairs = [(actions[i % len(actions)], float(10 * (i % 7)))
             for i in range(40)]
    synced, host_ms = {}, {}
    for t in ONLINE_TYPES:
        card = Learner(t, actions, ONLINE_CONF, 7, device=dev)
        cpu = Learner(t, actions, ONLINE_CONF, 7, device="cpu")
        for learner in (card, cpu):
            learner.set_reward_batch(pairs)
        torch.cuda.synchronize()
        handles = []
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            for n in ENGINE_SYNC_SIZES:
                handles.append(card.next_action_batch_async(n))
        except RuntimeError:
            import traceback
            synced[t] = traceback.format_exc()[-1500:]
        finally:
            host_ms[t] = (time.perf_counter() - t0) * 1e3
            torch.cuda.set_sync_debug_mode(0)
        if t in synced:
            continue
        got = [card.resolve_action_batch(h) for h in handles]
        if got != [cpu.next_action_batch(n) for n in ENGINE_SYNC_SIZES]:
            raise AssertionError(f"phase 15 dispatch {t}: the card's "
                                 "actions differ from the CPU's")
    if synced:
        raise AssertionError("phase 15: a synchronizing call in "
                             "next_action_batch_async: " + "\n".join(
                                 f"{t}: {tb}" for t, tb in synced.items()))
    return ("phase 15 next_action_batch_async under set_sync_debug_mode("
            f"'error') at {ENGINE_SYNC_SIZES} decisions: no synchronizing "
            "call in any of the ten learners, actions equal to the CPU's; "
            "host ms to queue the four: " + ", ".join(
                f"{t} {ms:.1f}" for t, ms in host_ms.items()))


def engine_verb(work, events, out, on, *extra, verb=None):
    """The verb (``ReinforcementLearnerTopology`` with the engine, or
    ``verb``) on ``on`` into ``out`` under ``work``: its JSON line."""
    from avenir_tpu_torch.cli.main import main as cli_main
    args = ([verb] if verb else ["ReinforcementLearnerTopology"]) + [
        events, os.path.join(work, out), "--conf",
        os.path.join(work, "rl.properties"), "--device", on]
    if not verb:
        args += ["-D", "serving.engine=true"]
    for kv in extra:
        args += ["-D", kv]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(args)
    if rc != 0:
        raise AssertionError(f"phase 15 {' '.join(args)}: exit {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def payload_diff(reg_a, reg_b, version):
    """The leaves of a version's payload that differ between two
    registries: each leaf's dtype, shape and bits equal, but a NaN equal
    to any NaN (EXP3's weights overflow to inf over 1,024 rewards, as the
    JAX package's do, and the card's NaN bits are not the CPU's)."""
    def leaves(reg):
        path = os.path.join(reg, f"v{version:07d}", "payload.npz")
        with np.load(path) as zf:
            return {k: zf[k] for k in zf.files}
    a, b = leaves(reg_a), leaves(reg_b)
    if sorted(a) != sorted(b):
        return sorted(set(a) ^ set(b))
    out = []
    for k in sorted(a):
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape:
            out.append(k)
            continue
        nan = np.isnan(x) if x.dtype.kind == "f" else np.zeros(x.shape, bool)
        if x.dtype.kind == "f" and not np.array_equal(nan, np.isnan(y)):
            out.append(k)
        elif x[~nan].tobytes() != y[~nan].tobytes():
            out.append(k)
    return out


def engine_lifecycle(work, events, rewards) -> str:
    """A ``lifecycle.dir`` round trip (exponentialWeight): a card run
    publishes v1; a second card run restores it and publishes v2, as a
    ``--device cpu`` run does over a copy of the card's registry (the
    files and the v2 payloads equal); ``Lifecycle retrain`` on the card
    and the CPU (payloads equal), ``list``, ``show`` and ``prune``."""
    reg, reg_cpu = os.path.join(work, "reg"), os.path.join(work, "reg-cpu")
    learner = "learner.type=exponentialWeight"
    first = engine_verb(work, events, "life-1.txt", "cuda", learner,
                        f"lifecycle.dir={reg}")
    shutil.copytree(reg, reg_cpu)
    second = {}
    for on, d in (("cuda", reg), ("cpu", reg_cpu)):
        second[on] = engine_verb(work, events, f"life-2-{on}.txt", on,
                                 learner, f"lifecycle.dir={d}")
        second[on].pop("overlap_fraction")
    same_bytes("phase 15 lifecycle.dir restore",
               os.path.join(work, "life-2-cuda.txt"),
               os.path.join(work, "life-2-cpu.txt"))
    diff = payload_diff(reg, reg_cpu, 2)
    if first["lifecycle_version"] != 1 or second["cuda"] != second["cpu"] \
            or second["cuda"]["lifecycle_version"] != 2 or diff:
        raise AssertionError(f"phase 15 lifecycle.dir: {first} {second}, "
                             f"v2 leaves differing {diff}")
    for on, d in (("cuda", reg), ("cpu", reg_cpu)):
        line = engine_verb(work, rewards, f"retrain-{on}.json", on, learner,
                           f"lifecycle.dir={d}", "lifecycle.command=retrain",
                           verb="Lifecycle")
        if line != {"lifecycle.published": 3,
                    "lifecycle.train_rows": ONLINE_EVENTS // 4}:
            raise AssertionError(f"phase 15 Lifecycle retrain: {line}")
    diff = payload_diff(reg, reg_cpu, 3)
    if diff:
        raise AssertionError("phase 15 Lifecycle retrain: the card's "
                             f"payload differs from the CPU's in {diff}")
    listed = engine_verb(work, rewards, "list.jsonl", "cuda",
                         f"lifecycle.dir={reg}", "lifecycle.command=list",
                         verb="Lifecycle")
    shown = engine_verb(work, rewards, "show.json", "cuda",
                        f"lifecycle.dir={reg}", "lifecycle.command=show",
                        verb="Lifecycle")
    pruned = engine_verb(work, rewards, "prune.txt", "cuda",
                         f"lifecycle.dir={reg}", "lifecycle.command=prune",
                         "lifecycle.max.keep=2", verb="Lifecycle")
    if (listed != {"lifecycle.versions": 3, "lifecycle.head": 3}
            or shown != {"lifecycle.head": 3}
            or pruned != {"lifecycle.pruned": [1], "lifecycle.head": 3}):
        raise AssertionError(f"phase 15 Lifecycle: {listed} {shown} "
                             f"{pruned}")
    return ("phase 15 lifecycle.dir on the card: v1 published, v2 restored "
            "from it and published, equal to a --device cpu run over a copy "
            "of the card's registry (actions file, JSON line, v2 payload "
            "bit for bit, NaN as NaN); Lifecycle retrain v3 payload equal "
            "card to CPU; list 3 "
            "versions, show head 3, prune removed [1]")


def engine_admission(work, events) -> str:
    """``engine.admission.high`` on softMax, card and CPU: shed_total +
    events = the events produced, the files and JSON lines equal."""
    keys = ("learner.type=softMax",
            f"engine.admission.high={ENGINE_ADMISSION_HIGH}",
            "engine.shed.chunk=256")
    lines = {}
    for on in ("cuda", "cpu"):
        lines[on] = engine_verb(work, events, f"admit-{on}.txt", on, *keys)
        lines[on].pop("overlap_fraction")
    same_bytes("phase 15 admission", os.path.join(work, "admit-cuda.txt"),
               os.path.join(work, "admit-cpu.txt"))
    got = lines["cuda"]
    if got != lines["cpu"] or got["shed_total"] <= 0 or \
            got["shed_total"] + got["events"] != ONLINE_EVENTS:
        raise AssertionError(f"phase 15 admission: {lines}")
    return (f"phase 15 admission (high {ENGINE_ADMISSION_HIGH}, chunk 256, "
            "reject-new): "
            f"{got['events']} served + {got['shed_total']} shed = "
            f"{ONLINE_EVENTS} produced, file and JSON line equal card to CPU")


def engine_rates(dev, actions, events, rewards) -> dict:
    """The engine's decisions/s against ``OnlineLearnerLoop.run()`` on the
    card, each on its own prefilled queues of the same events (host
    clock, a 64-event warm-up of each first), with the engine's overlap
    fraction and its host ms a batch waiting for the card and queueing
    the card's work; the two runs' actions equal."""
    rates = {}
    for t in ONLINE_TYPES:
        n = (ENGINE_RATE_UCB_EVENTS if t in ONLINE_OWN_PROCESS
             else ENGINE_RATE_EVENTS)
        online_loop(t, actions, events, rewards, dev, n_events=64).run()
        online_engine(t, actions, events, rewards, dev, n_events=64).run()
        loop = online_loop(t, actions, events, rewards, dev, n_events=n)
        engine = online_engine(t, actions, events, rewards, dev, n_events=n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stats = engine.run()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if drain_actions(loop.queues) != drain_actions(engine.queues):
            raise AssertionError(f"phase 15 rates {t}: the engine's actions "
                                 "differ from run()'s")
        rates[t] = {"events": n, "run": n / (t1 - t0),
                    "engine": n / (t2 - t1),
                    "overlap": stats.overlap_fraction,
                    "select_wait_ms": stats.select_wait_ms / stats.batches,
                    "dispatch_ms": stats.dispatch_ms / stats.batches}
    log(f"phase 15 decisions/s on the card ({nvidia_smi_line()}; host "
        f"clock; {ENGINE_RATE_EVENTS} prefilled events, "
        f"{', '.join(ONLINE_OWN_PROCESS)} {ENGINE_RATE_UCB_EVENTS}; a "
        "quarter as many rewards folded first), engine / run(), the "
        "engine's overlap_fraction, select_wait_ms and dispatch_ms a "
        "batch: " + "; ".join(
            f"{t} {r['engine']:.0f} / {r['run']:.0f}, {r['overlap']:.3f}, "
            f"{r['select_wait_ms']:.2f}, {r['dispatch_ms']:.2f}"
            for t, r in rates.items()))
    return rates


# --------------------------------------------------------------------------
# phase 16: the live ANN index and the live observability layer
# --------------------------------------------------------------------------

LIVE_BASE_ROWS = SCALE_N      # phase 6's IVF at scale: nlist auto (1,024)
LIVE_BATCHES, LIVE_BATCH_ROWS = 32, 4096
LIVE_QUERIES, LIVE_RING, LIVE_RECALL_ROWS = 64, 4096, 512
LIVE_TAIL_BUDGET, LIVE_REBUILD_FILL = 512, 0.125
LIVE_MIN_RECALL, LIVE_SWAP_P99_MS = 0.98, 250.0


def live_stream(dev):
    """The live ANN index on the card: a base of ``LIVE_BASE_ROWS`` rows
    (phase 6's width, nlist auto, 15 Lloyd steps) with a ``RetrainDaemon``
    thread bound to it, then ``LIVE_BATCHES`` appends of
    ``LIVE_BATCH_ROWS``, each followed by ``LIVE_QUERIES`` queries served
    through a ``ServingEngine`` over an ``AnnServingLearner`` (k = 5),
    whose swap source adopts each published wave. Gates: no query error,
    a wave requested, published and adopted mid-stream, the row count,
    recall against K2's exact top-k over the union, full probing equal to
    a fresh build over the union, the swap's p99, no daemon error; every
    K1 call held against its plain version. Returns K1's kernels-line
    entry at the append shape."""
    from avenir_tpu_torch.lifecycle.registry import SnapshotRegistry
    from avenir_tpu_torch.lifecycle.retrain import RetrainDaemon
    from avenir_tpu_torch.models.live_ann import (IVF_SNAPSHOT_KIND,
                                                  LiveAnnIndex)
    from avenir_tpu_torch.obs import exporters, telemetry
    from avenir_tpu_torch.ops import cuda_distance as D
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.ops import ivf
    from avenir_tpu_torch.stream.engine import (AnnServingLearner,
                                                ServingEngine)
    from avenir_tpu_torch.stream.loop import InProcQueues
    rng = np.random.default_rng(SEED + 16)
    d, k = BENCH_D, BENCH_K
    base = rng.random((LIVE_BASE_ROWS, d), dtype=np.float32)
    batches = [rng.random((LIVE_BATCH_ROWS, d), dtype=np.float32)
               for _ in range(LIVE_BATCHES)]
    ring_rows = rng.random((LIVE_RING, d), dtype=np.float32)
    hub = exporters.hub()
    enabled_here = not hub.enabled
    hub.enable()
    hub.reset()               # the phase's spans only
    work = tempfile.mkdtemp(prefix="smoke-live-", dir=os.path.dirname(
        os.path.abspath(__file__)))
    registry = SnapshotRegistry(os.path.join(work, "registry"),
                                max_to_keep=2)
    watcher = registry.subscribe()
    restore_ms, wave_s = [], []

    def swap_source():
        snap = watcher.poll()
        if snap is None or snap.manifest.get("kind") != IVF_SNAPSHOT_KIND:
            return None
        t0 = time.perf_counter()
        payload = (snap.restore(), snap.manifest.get("extra") or {})
        restore_ms.append((time.perf_counter() - t0) * 1e3)
        return snap.version, payload

    H.class_feature_bin_counts.launches = 0
    calls = []
    daemon = None
    try:
        with recording(calls):
            build_ms, live = host_ms(lambda: LiveAnnIndex(
                base, nlist=0, n_iters=15, seed=0,
                tail_budget=LIVE_TAIL_BUDGET,
                rebuild_tail_fill=LIVE_REBUILD_FILL, device=dev))
            train = live.make_train_fn()

            def timed_wave():
                t0 = time.perf_counter()
                out = train()
                wave_s.append(time.perf_counter() - t0)
                return out
            daemon = RetrainDaemon(registry, timed_wave)
            live.bind_daemon(daemon)
            daemon.start()
            learner = AnnServingLearner(live, ring_rows, k=k)
            learner.warm(LIVE_QUERIES)
            queues = InProcQueues()
            engine = ServingEngine("", learner.actions, {}, queues,
                                   learner=learner, min_batch=LIVE_QUERIES,
                                   max_batch=LIVE_QUERIES,
                                   swap_source=swap_source, device=dev)
            append_s, q_wave_ms, q_quiet_ms = 0.0, [], []
            errors, swap_batches, n_expected = 0, [], LIVE_BASE_ROWS
            for bi, batch in enumerate(batches):
                ms, _ = host_ms(lambda: live.append(batch))
                append_s += ms / 1e3
                n_expected += LIVE_BATCH_ROWS
                in_flight = (live.rebuild_requests
                             > live.swaps - live.inline_rebuilds)
                swaps = engine.stats.swaps
                for i in range(LIVE_QUERIES):
                    queues.push_event(f"q{bi}-{i}")
                ms, _ = host_ms(engine.run)
                (q_wave_ms if in_flight else q_quiet_ms).append(ms)
                got = [a for _, acts in list(queues.actions)[:LIVE_QUERIES]
                       for a in acts]
                queues.actions.clear()
                if len(got) != LIVE_QUERIES or not all(
                        0 <= int(a) < live.n_total for a in got):
                    errors += 1
                if engine.stats.swaps > swaps:
                    swap_batches.append(bi)
            # the daemon's wave in flight lands; an empty run adopts it
            daemon.stop()
            if registry.latest_version() != engine.stats.model_version:
                engine.run()
            torch.cuda.synchronize()
        launches = H.class_feature_bin_counts.launches
        report = hub.report()
    finally:
        if daemon is not None:
            daemon.stop()
        if enabled_here:
            hub.disable()
        shutil.rmtree(work, ignore_errors=True)
    held, _ = hold_k1_calls("phase 16 live ANN", calls)
    if held != launches:
        raise AssertionError(f"phase 16: {launches} K1 launches, {held} "
                             "recorded")
    if daemon.errors:
        raise AssertionError(f"phase 16: a wave raised: "
                             f"{daemon.last_error!r}")
    if live.n_total != n_expected:
        raise AssertionError(f"phase 16: n_total {live.n_total} != "
                             f"{n_expected}")
    if errors:
        raise AssertionError(f"phase 16: {errors} query batches errored")
    if live.inline_rebuilds:
        raise AssertionError(f"phase 16: {live.inline_rebuilds} inline "
                             "rebuilds (the tail budget is too small)")
    if not (live.rebuild_requests and daemon.waves and live.swaps):
        raise AssertionError(
            f"phase 16: requests {live.rebuild_requests}, waves "
            f"{daemon.waves}, swaps {live.swaps}")
    if not [b for b in swap_batches if b < LIVE_BATCHES - 1]:
        raise AssertionError(f"phase 16: no swap mid-stream "
                             f"({swap_batches})")
    swap_span = report["spans"].get("lifecycle.swap")
    if not swap_span or swap_span["count"] < live.swaps:
        raise AssertionError(f"phase 16: lifecycle.swap span {swap_span}")
    if swap_span["p99_ms"] > LIVE_SWAP_P99_MS:
        raise AssertionError(f"phase 16: swap p99 {swap_span['p99_ms']} "
                             f"ms > {LIVE_SWAP_P99_MS}")

    # recall against K2's exact top-k over the union, then full probing
    # against a fresh build over the union (neither counts as the path)
    union = np.concatenate([base] + batches)
    union_dev = torch.from_numpy(union).to(dev)
    xq = rng.random((LIVE_RECALL_ROWS, d), dtype=np.float32)
    xq_dev = torch.from_numpy(xq).to(dev)
    _, exact_ids = D.pairwise_topk_cuda(xq_dev, union_dev, k=k)
    _, live_ids = live.query(xq, k=k)
    exact_ids, live_ids = exact_ids.cpu().numpy(), live_ids.cpu().numpy()
    recall = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                            for a, b in zip(exact_ids, live_ids)]))
    if recall < LIVE_MIN_RECALL:
        raise AssertionError(f"phase 16: recall {recall:.4f} < "
                             f"{LIVE_MIN_RECALL}")
    nlist = live.index.nlist
    fresh_ms, fresh = host_ms(lambda: ivf.build_ivf(
        union_dev, nlist=nlist, n_iters=15, seed=0, device=dev))
    full = live.query(xq[:LIVE_QUERIES], k=k, n_probe=nlist)
    want = ivf.ann_topk(fresh, xq_dev[:LIVE_QUERIES], k=k, n_probe=nlist)
    if not all(torch.equal(a, b) for a, b in zip(full, want)):
        raise AssertionError("phase 16: full probing differs from a fresh "
                             "build over the union")
    del fresh, union_dev

    # K1 at the append shape (one class, one feature, nlist bins)
    append_calls = [a for n, a, _ in calls
                    if n == "K1" and a["bins"].shape[0] == LIVE_BATCH_ROWS]
    k1 = time_k1_at(dev, append_calls[-1])
    rows = LIVE_BATCHES * LIVE_BATCH_ROWS
    med = lambda v: statistics.median(v) if v else float("nan")  # noqa
    log(f"phase 16 live ANN: base {LIVE_BASE_ROWS} rows x {d}, nlist "
        f"{nlist}, built in {build_ms / 1e3:.2f} s; {LIVE_BATCHES} appends "
        f"of {LIVE_BATCH_ROWS} rows, {rows / append_s:,.0f} rows/s "
        f"(host clock, the card synchronized); tail budget "
        f"{LIVE_TAIL_BUDGET}, rebuild at fill {LIVE_REBUILD_FILL}: "
        f"{live.rebuild_requests} requests, {daemon.waves} waves "
        f"({', '.join(f'{s:.2f}' for s in wave_s)} s each on the "
        f"daemon's stream), {live.swaps} swaps after batches "
        f"{swap_batches}, version {live.version}, tail cap "
        f"{live.tail_cap}, n_total {live.n_total}; {LIVE_QUERIES} queries "
        f"a batch through the engine, k={k}: median "
        f"{med(q_wave_ms):.1f} ms with a wave in flight "
        f"({len(q_wave_ms)} batches), {med(q_quiet_ms):.1f} ms with none "
        f"({len(q_quiet_ms)}); lifecycle.swap p50 "
        f"{swap_span['p50_ms']:.1f} / p99 {swap_span['p99_ms']:.1f} ms "
        f"(bound {LIVE_SWAP_P99_MS:.0f}), the snapshot's restore "
        f"{', '.join(f'{v:.1f}' for v in restore_ms)} ms before it; "
        f"recall {recall:.4f} on {LIVE_RECALL_ROWS} rows against K2's "
        f"exact top-k over the union (bar {LIVE_MIN_RECALL}); full probing "
        f"equal to a fresh build over the union ({fresh_ms / 1e3:.2f} s)")
    log(f"phase 16 K1: {held} launches on the path, each exact against "
        f"plain; at the append shape {k1['shape']}: {k1['ms']:.4f} ms "
        f"chained, {k1['graph_ms']:.4f} ms from graph replays reading HBM "
        f"({k1['bound_ms'] / k1['graph_ms']:.1%} of bound), plain "
        f"{k1['plain_ms']:.4f} ms, bincount {k1['library_ms']:.4f} ms, "
        f"bound {k1['bound_ms']:.7f} ms ({k1['bound_by']})")
    return {"name": "cfb_counts (K1-live) at the live-ANN append shape (a "
                    "batch's list counts, C = 1, F = 1, B = nlist)",
            "route": "cuda", "source": "avenir_tpu_torch/csrc/hist.cu",
            "replaces": "avenir_tpu/ops/pallas_histogram.py:57",
            "launches": launches, "max_abs_err": 0.0,
            **{key: k1[key] for key in ("ms", "graph_ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms", "shape")}}


class ArmedJob:
    """A CLI job in a fresh process with the scrape endpoint armed
    (``--obs-port 0``), its endpoint scraped on a thread while it runs
    (``/metrics``, parsed, and ``/healthz``); ``want_gauge`` names a
    metric a scrape must find. :meth:`result` waits for it: (its stdout
    lines after the port's, the scrape counts)."""

    def __init__(self, label, args, want_gauge=None):
        import threading
        self.label, self.want_gauge = label, want_gauge
        self.scrapes = {"metrics": 0, "healthz": 0, "gauge": 0}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "avenir_tpu_torch"] + args
            + ["--obs-port", "0", "--device", "cuda"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.out = self.err = None
        self.thread = threading.Thread(target=self._scrape, daemon=True)
        self.thread.start()

    def _scrape(self):
        from avenir_tpu_torch.obs.exporters import parse_prometheus_text
        line = self.proc.stdout.readline()
        try:
            base = f"http://localhost:{json.loads(line)['obs_port']}"
        except ValueError:
            base = None
        while base and self.proc.poll() is None:
            try:
                with urllib.request.urlopen(base + "/metrics",
                                            timeout=5) as r:
                    names = {n for n, _, _ in parse_prometheus_text(
                        r.read().decode())}
                self.scrapes["metrics"] += 1
                self.scrapes["gauge"] += bool(self.want_gauge) and any(
                    self.want_gauge in n for n in names)
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=5) as r:
                    self.scrapes["healthz"] += bool(json.loads(r.read())["ok"])
            except OSError:
                break                 # the job ended and closed its port
            time.sleep(0.02)
        self.out, self.err = self.proc.communicate(timeout=600)

    def result(self):
        self.thread.join(timeout=660)
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.proc.returncode != 0:
            raise AssertionError(f"phase 16 {self.label}: exit "
                                 f"{self.proc.returncode}: "
                                 f"{(self.err or '')[-2000:]}")
        s = self.scrapes
        if not (s["metrics"] and s["healthz"]
                and (s["gauge"] or not self.want_gauge)):
            raise AssertionError(f"phase 16 {self.label}: scrapes {s}")
        return self.out.splitlines(), s


def live_cli_jobs(dev, work):
    """The live verb and the live observability layer through the CLI:
    phase 3's elearn NearestNeighbor job and the engine verb
    (``serving.engine=true``, UCB2 on the first ``ENGINE_SHORT_EVENTS`` of
    phase 14's ids) each in a fresh process with the endpoint armed (the
    elearn one also with ``--metrics-out`` and ``alerts.enable=true``),
    ``/metrics`` and ``/healthz`` scraped while they run (the engine's
    gauges among the metrics), beside this process's jobs:
    NearestNeighbor with ``knn.ann.live=true`` at the elearn shape, its
    file byte-equal to ``knn.ann.live=false``'s; the two jobs unarmed,
    whose lines and files the armed ones' equal; a failing job, which
    leaves ``<metrics-out>.flight.jsonl``."""
    from avenir_tpu_torch.datagen import generators as G
    from avenir_tpu_torch.models import live_ann
    p = lambda name: os.path.join(work, name)  # noqa: E731
    elearn = G.elearn_rows(ELEARN_TRAIN + ELEARN_TEST, seed=SEED)
    write_csv(p("elearn_train.csv"), elearn[:ELEARN_TRAIN])
    write_csv(p("elearn_test.csv"), elearn[ELEARN_TRAIN:])
    with open(p("elearn.json"), "w") as fh:
        json.dump(G.elearn_schema_json(), fh)
    with open(p("knn.properties"), "w") as fh:
        fh.write(f"field.delim.regex=,\n"
                 f"feature.schema.file.path={p('elearn.json')}\n"
                 f"train.data.path={p('elearn_train.csv')}\n"
                 "top.match.count=5\nkernel.function=none\n"
                 "distance.scale=1000\nvalidation.mode=true\n"
                 "positive.class.value=fail\n")
    events = os.path.join(work, "events.txt")
    if not os.path.exists(os.path.join(work, "rl.properties")):
        actions, events, rewards = online_inputs(work, ONLINE_EVENTS)
        online_properties(work, actions, rewards)
    short = p("events-live.txt")
    with open(events) as fh:
        ids = fh.read().split()[:ENGINE_SHORT_EVENTS]
    with open(short, "w") as fh:
        fh.write("".join(i + "\n" for i in ids))
    knn = ["NearestNeighbor", p("elearn_test.csv")]
    conf = ["--conf", p("knn.properties"), "--device", "cuda"]
    ucb2 = "learner.type=upperConfidenceBoundTwo"
    m = p("m.jsonl")
    armed_knn = ArmedJob("armed NearestNeighbor", knn + [
        p("armed.txt"), "--conf", p("knn.properties"), "--metrics-out", m,
        "-D", "alerts.enable=true"])
    # UCB2, the slowest learner: the scrapes see its batches
    armed_rl = ArmedJob("armed engine", [
        "ReinforcementLearnerTopology", short, p("rl_armed.txt"), "--conf",
        p("rl.properties"), "-D", "serving.engine=true", "-D", ucb2],
        want_gauge="engine_overlap_fraction")
    walls = {}
    for tag, live in (("frozen", "false"), ("live", "true")):
        t0 = time.perf_counter()
        run_cli(knn + [p(f"ann_{tag}.txt")] + conf
                + ["-D", "knn.ann=true", "-D", f"knn.ann.live={live}"])
        walls[tag] = time.perf_counter() - t0
    same_bytes("phase 16 knn.ann.live=true", p("ann_live.txt"),
               p("ann_frozen.txt"))
    slot = live_ann.peek_live_index().describe()
    live_ann._LIVE_SLOT.clear()
    want = cli_lines(knn + [p("plain.txt")] + conf)
    line = engine_verb(work, short, "rl_plain.txt", "cuda", ucb2)
    # a failing job leaves its flight record
    failed = False
    try:
        run_cli(knn + [p("fail.txt")] + conf
                + ["-D", f"train.data.path={p('missing.csv')}", "-D",
                   "obs.live=true", "--metrics-out", p("f.jsonl")])
    except FileNotFoundError:
        failed = True
    with open(p("f.jsonl.flight.jsonl")) as fh:
        meta = json.loads(fh.readline())
    if not failed or meta.get("reason") != "crash:cli":
        raise AssertionError(f"phase 16 failing job: {failed}, {meta}")

    got, knn_scrapes = armed_knn.result()
    if got != want:
        raise AssertionError(f"phase 16 armed NearestNeighbor: {got} != "
                             f"{want}")
    same_bytes("phase 16 armed NearestNeighbor", p("armed.txt"),
               p("plain.txt"))
    for suffix in (".prom", ".alerts.jsonl"):
        if not os.path.exists(m + suffix):
            raise AssertionError(f"phase 16: no {m + suffix}")
    got, rl_scrapes = armed_rl.result()
    got = json.loads(got[-1])
    # the share of the host's time that overlapped the card varies a run
    if {**got, "overlap_fraction": 0} != {**line, "overlap_fraction": 0}:
        raise AssertionError(f"phase 16 armed engine: {got} != {line}")
    same_bytes("phase 16 armed engine", p("rl_armed.txt"),
               p("rl_plain.txt"))
    log(f"phase 16 NearestNeighbor knn.ann.live=true on elearn "
        f"{ELEARN_TRAIN} / {ELEARN_TEST}: file byte-equal to "
        f"knn.ann.live=false's ({walls['live']:.2f} s against "
        f"{walls['frozen']:.2f}; the live slot {slot}); in fresh processes "
        f"beside it, the elearn job armed (--obs-port 0, --metrics-out, "
        f"alerts.enable=true): {knn_scrapes['metrics']} /metrics and "
        f"{knn_scrapes['healthz']} /healthz scrapes while it ran, lines and "
        f"file the unarmed job's, .prom and .alerts.jsonl written; the "
        f"engine verb (UCB2, {ENGINE_SHORT_EVENTS} ids) armed: "
        f"{rl_scrapes['gauge']} of {rl_scrapes['metrics']} scrapes named "
        f"its engine gauges, its JSON line and file the unarmed run's; a "
        f"failing job left <metrics-out>.flight.jsonl ({meta['reason']}, "
        f"{meta['windows']} windows)")


def live_phase(dev, work):
    """Phase 16: the live ANN index (``live_stream``) and the live
    observability layer through the CLI (``live_cli_jobs``). Returns K1's
    kernels-line entry at the append shape."""
    t_phase = time.perf_counter()
    k1 = live_stream(dev)
    live_cli_jobs(dev, work)
    log(f"phase 16 wall: {time.perf_counter() - t_phase:.1f} s")
    return k1


# --------------------------------------------------------------------------
# phase 17: boosted serving, the grouped engine and the broker fleet
# --------------------------------------------------------------------------

SERVE_EVENTS = 65_536         # the boosted engine's scoring requests
SERVE_REWARDS = SERVE_EVENTS // 4
SERVE_DRAIN_MAX = 256         # rewards folded a batch: the shift streams in
SERVE_P99_MS = 500.0          # scripts/boost_smoke.py's decision-p99 bar
GROUPED_GROUPS = 16           # docs/TUTORIALS.md:768
GROUPED_EVENTS = ENGINE_SHORT_EVENTS  # phase 15's first ids
GROUPED_WIRE_TYPES = ("softMax",)
FLEET_IDS = ENGINE_SHORT_EVENTS


def boost_serving_refit(dev, table):
    """The refit wave of ``boost_refit_train_fn`` at phase 10's first
    config on ``table``, timed (host clock, the card synchronized)."""
    from avenir_tpu_torch.lifecycle.retrain import boost_refit_train_fn
    rounds, depth = BOOST_RUNS[0]
    train = boost_refit_train_fn(lambda: table, boost_config(rounds, depth))
    wave_s = []

    def timed_wave():
        t0 = time.perf_counter()
        out = train()
        torch.cuda.synchronize()
        wave_s.append(time.perf_counter() - t0)
        return out
    return timed_wave, wave_s


def boost_serving_margins(dev, tables, bins, cap) -> str:
    """``_serve_margins`` on the card against the CPU for each power-of-two
    batch up to ``cap`` (bits of the margins, the classes), and
    ``BoostServingLearner.next_action_batch_async`` at those sizes under
    ``set_sync_debug_mode("error")``, its classes the CPU's."""
    from avenir_tpu_torch.models import boost as B
    from avenir_tpu_torch.stream.engine import BoostServingLearner
    cpu_tables = {k: v.cpu() for k, v in tables.items()}
    depth = BOOST_RUNS[0][1]
    sizes, m = [], 1
    while m <= cap:
        sizes.append(m)
        m *= 2
    rows = np.arange(bins.shape[0])
    for m in sizes:
        idx = (rows[:m] * 4099) % bins.shape[0]
        card = B._serve_margins(tables, torch.from_numpy(bins[idx]).to(dev),
                                depth=depth)
        cpu = B._serve_margins(cpu_tables, torch.from_numpy(bins[idx]),
                               depth=depth)
        if not (card[0].cpu().numpy().tobytes()
                == cpu[0].numpy().tobytes()
                and torch.equal(card[1].cpu(), cpu[1])):
            raise AssertionError(f"phase 17 margins at a batch of {m}: the "
                                 "card's differ from the CPU's")
    card = BoostServingLearner(tables, bins, ["no", "yes"], depth=depth)
    cpu = BoostServingLearner(cpu_tables, bins, ["no", "yes"], depth=depth)
    card.warm(cap)
    cpu.warm(cap)
    torch.cuda.synchronize()
    handles = []
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    try:
        for m in sizes:
            handles.append(card.next_action_batch_async(m))
    finally:
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.set_sync_debug_mode(0)
    got = [card.resolve_action_batch(h) for h in handles]
    if got != [cpu.resolve_action_batch(cpu.next_action_batch_async(m))
               for m in sizes]:
        raise AssertionError("phase 17 BoostServingLearner: the card's "
                             "classes differ from the CPU's")
    return (f"phase 17 _serve_margins on the card at batches {sizes}: "
            "margins bit-equal to the CPU's, classes equal; "
            "BoostServingLearner.next_action_batch_async at those sizes "
            "under set_sync_debug_mode('error'): no synchronizing call, "
            f"{host_ms:.1f} ms of host time to queue the {len(sizes)}")


def boost_serving(dev, work):
    """(a): boosted margins behind a ``ServingEngine`` over MiniRedis at
    phase 10's tutorial shape (``retarget_big_table``, 8 rounds at depth
    3, the budgets ``boost_refit_train_fn`` pins). A first refit wave
    gives the served tables; a reward regime shift through a Page-Hinkley
    ``DriftMonitor`` requests a second wave from the ``RetrainDaemon``
    thread while ``SERVE_EVENTS`` events are scored, and the swap source
    installs each published wave at a batch boundary. Gates: every event
    answered, the pending ledger empty, a drift-requested wave published
    and swapped in mid-drain, no daemon error, the decision p99 under
    ``SERVE_P99_MS``, every K1 integer-mode call (the waves') exact
    against its plain version. Returns (K1-int's launches on this path,
    its lines)."""
    from avenir_tpu_torch.lifecycle.drift import DriftMonitor, PageHinkley
    from avenir_tpu_torch.lifecycle.registry import SnapshotRegistry
    from avenir_tpu_torch.lifecycle.retrain import RetrainDaemon
    from avenir_tpu_torch.models import boost as B
    from avenir_tpu_torch.obs import exporters
    from avenir_tpu_torch.ops import cuda_histogram as H
    from avenir_tpu_torch.stream.engine import (BoostServingLearner,
                                                ServingEngine)
    from avenir_tpu_torch.stream.loop import RedisQueues
    from avenir_tpu_torch.stream.miniredis import (MiniRedisClient,
                                                   MiniRedisServer)
    lines = []
    table = retarget_big_table(dev)
    bins = B.serving_bins(table)
    classes = list(table.class_values)
    registry = SnapshotRegistry(os.path.join(work, "boost-registry"))
    wave, wave_s = boost_serving_refit(dev, table)
    hub = exporters.hub()
    enabled_here = not hub.enabled
    hub.enable()
    hub.reset()
    daemon = None
    server = MiniRedisServer("localhost", 0).start()
    calls, batch_of_swap = [], []
    try:
        client = MiniRedisClient("localhost", server.port)
        for i in range(0, SERVE_EVENTS, 4096):
            client.lpush("eventQueue", *[f"s{j:06d}" for j in
                                         range(i, min(i + 4096,
                                                      SERVE_EVENTS))])
        # the regime shifts after the first eighth of the rewards, which
        # fold SERVE_DRAIN_MAX a batch: the monitor alarms within the
        # first ~10 batches, and its wave lands while the drain goes on
        rng = np.random.default_rng(SEED + 17)
        shift = SERVE_REWARDS // 8
        rewards = [f"{classes[i % 2]},"
                   f"{float(i < shift) + 0.05 * rng.standard_normal()}"
                   for i in range(SERVE_REWARDS)]
        for i in range(0, SERVE_REWARDS, 4096):
            client.lpush("rewardQueue", *rewards[i:i + 4096])
        queues = RedisQueues(client=client, pending_queue="pendingQueue")
        H.class_feature_bin_sums.launches = 0
        with recording(calls):
            daemon = RetrainDaemon(registry, wave)
            if daemon.run_once() is None:
                raise AssertionError(f"phase 17: the first refit wave "
                                     f"failed: {daemon.last_error!r}")
            head = registry.latest()
            tables = head.restore(like=B.serving_tables(
                B.BoostedModel([], classes, 0.0, 0.3), table,
                rounds_budget=BOOST_RUNS[0][0],
                node_budget=(BOOST_RUNS[0][1] + 1)
                * boost_config(*BOOST_RUNS[0]).tree.device_node_budget))
            lines.append(boost_serving_margins(dev, tables, bins, 64))
            learner = BoostServingLearner(tables, bins, classes,
                                          depth=BOOST_RUNS[0][1])
            learner.warm(64)
            monitor = DriftMonitor(
                {"reward": PageHinkley(delta=0.005, threshold=5.0,
                                       min_samples=30)},
                on_drift=daemon.request, cooldown_s=0.0)
            daemon.start()
            watcher = registry.subscribe()
            box = {}

            def swap_source():
                snap = watcher.poll()
                if snap is None:
                    return None
                batch_of_swap.append(box["engine"].stats.batches)
                return snap.version, snap.restore(
                    like=box["engine"].learner.state)
            engine = ServingEngine("boost", classes, {}, queues,
                                   learner=learner, swap_source=swap_source,
                                   drift_monitor=monitor,
                                   drain_max=SERVE_DRAIN_MAX, device=dev)
            box["engine"] = engine
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = engine.run()
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            published = daemon.wait_for_waves(2, timeout=120)
            daemon.stop()
            torch.cuda.synchronize()
        launches = H.class_feature_bin_sums.launches
        report = hub.report()
        answered = client.llen("actionQueue")
        pending = client.llen("pendingQueue")
        ids = {raw.split(b",")[0] for raw in
               client.lrange("actionQueue", 0, -1)}
        client.close()
    finally:
        if daemon is not None:
            daemon.stop()
        if enabled_here:
            hub.disable()
        server.close()
    held, _ = hold_k1_calls("phase 17 refit waves", calls, "K1-int")
    per_wave = boost_k1_launches(table, boost_config(*BOOST_RUNS[0]))
    if held != launches or launches != per_wave * daemon.waves:
        raise AssertionError(f"phase 17: {launches} K1 integer-mode "
                             f"launches, {held} recorded, {per_wave} a "
                             f"wave x {daemon.waves} waves expected")
    if daemon.errors or daemon.last_error is not None:
        raise AssertionError(f"phase 17: a refit wave raised: "
                             f"{daemon.last_error!r}")
    if not published or monitor.alarms < 1:
        raise AssertionError(f"phase 17: waves {daemon.waves}, drift "
                             f"alarms {monitor.alarms}")
    if (stats.events != SERVE_EVENTS or answered != SERVE_EVENTS
            or len(ids) != SERVE_EVENTS or pending != 0):
        raise AssertionError(f"phase 17: {stats.events} served, {answered} "
                             f"answers ({len(ids)} ids), {pending} pending "
                             f"of {SERVE_EVENTS}")
    mid = [b for b in batch_of_swap if 0 < b < stats.batches]
    if not mid:
        raise AssertionError(f"phase 17: no swap mid-drain (swaps before "
                             f"batches {batch_of_swap} of {stats.batches})")
    lat = report["spans"].get("engine.decision_latency") or {}
    swap = report["spans"].get("lifecycle.swap") or {}
    if not lat or lat["p99_ms"] > SERVE_P99_MS:
        raise AssertionError(f"phase 17: decision latency {lat}")
    lines.append(
        f"phase 17 boosted serving on {table.n_rows} retarget rows, "
        f"{BOOST_RUNS[0][0]} rounds at depth {BOOST_RUNS[0][1]} "
        f"({nvidia_smi_line()}; host clock): {SERVE_EVENTS} events over "
        f"MiniRedis in {serve_s:.2f} s, {SERVE_EVENTS / serve_s:,.0f} "
        f"decisions/s, {stats.batches} batches; decision p50 "
        f"{lat['p50_ms']:.2f} / p99 {lat['p99_ms']:.2f} ms (bar "
        f"{SERVE_P99_MS:.0f}); {monitor.alarms} drift alarms, "
        f"{daemon.waves} refit waves ({', '.join(f'{s:.2f}' for s in wave_s)}"
        f" s each, the second requested by the monitor, no error), "
        f"{stats.swaps} swaps before batches {batch_of_swap}, "
        f"lifecycle.swap p50 {swap.get('p50_ms', float('nan')):.2f} / p99 "
        f"{swap.get('p99_ms', float('nan')):.2f} ms; every event answered "
        f"once, the pending ledger empty")
    widest = max((a for n, a, _ in calls if n == "K1-int"
                  and a["n_classes"] == 2), key=lambda a: a["n_bins"])
    del calls
    k1 = time_k1_int(dev, widest)
    lines.append(
        f"phase 17 K1 integer mode in the refit waves: {launches} launches "
        f"({per_wave} a wave), each exact against plain; at the widest "
        f"level, {k1['shape']}: {k1['ms']:.4f} ms chained, "
        f"{k1['graph_ms']:.4f} ms from graph replays reading HBM "
        f"({k1['bound_ms'] / k1['graph_ms']:.1%} of bound), plain "
        f"{k1['plain_ms']:.4f} ms, bincount {k1['library_ms']:.4f} ms, "
        f"bound {k1['bound_ms']:.4f} ms ({k1['bound_by']})")
    return launches, lines


def grouped_files(work, on, types, queues_kind="inproc"):
    """Each learner type's ``GroupedServingEngine`` on ``on`` over
    ``GROUPED_GROUPS`` contexts: phase 14's event ids, event i in group
    i mod 16, and its rewards, reward j in group j mod 16; the action
    queue written to ``grouped-<type>-<on>-<queues_kind>.txt``. Returns
    {type: (decisions/s of run() on the host clock, the engine's
    batches)}."""
    from avenir_tpu_torch.datagen import LeadGenSimulator
    from avenir_tpu_torch.stream.engine import GroupedServingEngine
    from avenir_tpu_torch.stream.loop import InProcQueues, RedisQueues
    from avenir_tpu_torch.stream.miniredis import (MiniRedisClient,
                                                   MiniRedisServer)
    actions = LeadGenSimulator().actions
    groups = [f"g{i}" for i in range(GROUPED_GROUPS)]
    with open(os.path.join(work, "events.txt")) as fh:
        ids = fh.read().split()[:GROUPED_EVENTS]
    with open(os.path.join(work, "rewards.txt")) as fh:
        pairs = [line.split(",") for line in fh.read().split()]
    events = [f"{groups[i % len(groups)]}:{e}" for i, e in enumerate(ids)]
    rewards = [(f"{groups[j % len(groups)]}:{a}", float(r))
               for j, (a, r) in enumerate(pairs)]
    out = {}
    for t in types:
        server = client = None
        if queues_kind == "inproc":
            queues = InProcQueues()
            for e in events:
                queues.push_event(e)
            for a, r in rewards:
                queues.push_reward(a, r)
        else:
            server = MiniRedisServer("localhost", 0).start()
            client = MiniRedisClient("localhost", server.port)
            queues = RedisQueues(client=client, pending_queue="pendingQueue")
            for i in range(0, len(events), 512):
                client.lpush("eventQueue", *events[i:i + 512])
            client.lpush("rewardQueue", *[f"{a},{r}" for a, r in rewards])
        try:
            engine = GroupedServingEngine(
                t, groups, actions, dict(ONLINE_CONF, **{"random.seed": 7}),
                queues, seed=7, device=on)
            if on != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = engine.run()
            if on != "cpu":
                torch.cuda.synchronize()
            rate = stats.events / (time.perf_counter() - t0)
            if queues_kind == "inproc":
                lines = [f"{e},{acts[0]}" for e, acts in drain_actions(queues)]
            else:
                lines = [raw.decode() for raw in
                         reversed(client.lrange("actionQueue", 0, -1))]
                if client.llen("pendingQueue"):
                    raise AssertionError(f"phase 17 grouped {t}: ledger "
                                         "entries left")
        finally:
            if client is not None:
                client.close()
            if server is not None:
                server.close()
        if stats.events != len(events) or len(lines) != len(events):
            raise AssertionError(f"phase 17 grouped {t} on {on}: "
                                 f"{stats.events} served, {len(lines)} "
                                 f"answers of {len(events)}")
        with open(os.path.join(work, f"grouped-{t}-{on}-{queues_kind}.txt"),
                  "w") as fh:
            fh.write("".join(line + "\n" for line in lines))
        out[t] = (rate, stats.batches)
    return out


def grouped_dispatch_sync_free(dev) -> str:
    """Each learner's ``GroupedLearner.next_all_async`` over
    ``GROUPED_GROUPS`` contexts, four waves under
    ``torch.cuda.set_sync_debug_mode("error")`` after a masked reward
    fold: no synchronizing call, the actions the CPU's."""
    from avenir_tpu_torch.datagen import LeadGenSimulator
    from avenir_tpu_torch.stream.loop import GroupedLearner
    actions = LeadGenSimulator().actions
    n = GROUPED_GROUPS
    idx = [g % len(actions) for g in range(n)]
    rew = [float(10 * (g % 7)) for g in range(n)]
    mask = [g % 3 != 0 for g in range(n)]
    host_ms = {}
    for t in ONLINE_TYPES:
        learners = [GroupedLearner(t, n, actions, ONLINE_CONF, 7, device=on)
                    for on in (dev, "cpu")]
        for gl in learners:
            gl.reward_masked(idx, rew, mask)
        card, cpu = learners
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            handles = [card.next_all_async() for _ in range(4)]
        finally:
            host_ms[t] = (time.perf_counter() - t0) * 1e3
            torch.cuda.set_sync_debug_mode(0)
        if [card.resolve_actions(h) for h in handles] != \
                [cpu.next_all() for _ in range(4)]:
            raise AssertionError(f"phase 17 grouped dispatch {t}: the "
                                 "card's actions differ from the CPU's")
    return ("phase 17 GroupedLearner.next_all_async, four waves of "
            f"{n} contexts under set_sync_debug_mode('error'): no "
            "synchronizing call in any of the ten learners, actions equal "
            "to the CPU's; host ms to queue the four: " + ", ".join(
                f"{t} {ms:.1f}" for t, ms in host_ms.items()))


def grouped_engines(dev, work) -> str:
    """(b): the grouped engine for each of the ten learners on the card
    over in-process queues (the CPU's legs in a process beside it), each
    action queue equal to the CPU's; and over ``RedisQueues`` on an
    in-process MiniRedis for ``GROUPED_WIRE_TYPES``, equal to the
    in-process files."""
    child = subprocess.Popen(
        [sys.executable, "-c", "import torch; torch.set_num_threads(2); "
         "import json, chip_smoke; print(json.dumps(chip_smoke."
         f"grouped_files({work!r}, 'cpu', chip_smoke.ONLINE_TYPES)))"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        card = grouped_files(work, dev.type, ONLINE_TYPES)
        wire = grouped_files(work, dev.type, GROUPED_WIRE_TYPES, "redis")
        out, err = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise AssertionError(f"phase 17 grouped CPU legs: {err[-2000:]}")
    cpu = json.loads(out.strip().splitlines()[-1])
    # phase 15's ServingEngine (softMax) on the same ids, ungrouped
    from avenir_tpu_torch.datagen import LeadGenSimulator
    actions = LeadGenSimulator().actions
    events = os.path.join(work, "events.txt")
    rewards = os.path.join(work, "rewards.txt")
    online_engine("softMax", actions, events, rewards, dev,
                  n_events=64).run()
    engine = online_engine("softMax", actions, events, rewards, dev,
                           n_events=GROUPED_EVENTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = engine.run().events
    torch.cuda.synchronize()
    single = served / (time.perf_counter() - t0)

    def read(name):
        with open(os.path.join(work, name)) as fh:
            return fh.read()
    for t in ONLINE_TYPES:
        if read(f"grouped-{t}-{dev.type}-inproc.txt") != \
                read(f"grouped-{t}-cpu-inproc.txt"):
            raise AssertionError(f"phase 17 grouped {t}: the card's action "
                                 "queue differs from the CPU's")
    for t in GROUPED_WIRE_TYPES:
        if read(f"grouped-{t}-{dev.type}-redis.txt") != \
                read(f"grouped-{t}-{dev.type}-inproc.txt"):
            raise AssertionError(f"phase 17 grouped {t} over RedisQueues: "
                                 "differs from in-process")
    return (f"phase 17 GroupedServingEngine, {GROUPED_GROUPS} groups, "
            f"{GROUPED_EVENTS} events (phase 14's ids, event i in group i "
            f"mod {GROUPED_GROUPS}) and {ONLINE_EVENTS // 4} rewards, ten "
            "learners: action queues on the card equal to the CPU's; over "
            f"RedisQueues on MiniRedis ({', '.join(GROUPED_WIRE_TYPES)}) "
            "equal to in-process; decisions/s on the card (host clock; "
            f"{nvidia_smi_line()}), in-process / Redis: " + "; ".join(
                f"{t} {card[t][0]:,.0f}"
                + (f" / {wire[t][0]:,.0f}" if t in wire else "")
                for t in ONLINE_TYPES)
            + "; on the CPU: " + ", ".join(
                f"{t} {cpu[t][0]:,.0f}" for t in ONLINE_TYPES)
            + f"; phase 15's ServingEngine, softMax, on the same "
            f"{GROUPED_EVENTS} ids: {single:,.0f}")


def fleet_legs(dev, work) -> str:
    """(c): the verb's ``broker.shards`` over two in-process MiniRedis
    brokers on the first ``FLEET_IDS`` of phase 14's ids, its actions file
    equal to the in-process engine's; the grouped engine over
    ``ShardedQueues`` (softMax, 16 groups routed over the two shards)
    equal to (b)'s file; then the groups re-routed over three shards and
    each moved group's queues migrated with ``migrate_group_queues``:
    every entry on the new shard, none left on the old."""
    from avenir_tpu_torch.datagen import LeadGenSimulator
    from avenir_tpu_torch.stream.engine import GroupedServingEngine
    from avenir_tpu_torch.stream.fleet import (
        BrokerFleet, ShardedQueues, consistent_route, migrate_group_queues)
    from avenir_tpu_torch.stream.miniredis import MiniRedisServer
    short = os.path.join(work, "events-fleet.txt")
    with open(os.path.join(work, "events.txt")) as fh:
        ids = fh.read().split()
    with open(short, "w") as fh:
        fh.write("".join(i + "\n" for i in ids[:FLEET_IDS]))
    servers = [MiniRedisServer("localhost", 0).start() for _ in range(3)]
    fleet = None
    try:
        # one pipelined sweep of 64 pops, the engine's transport unit
        probe = BrokerFleet([f"localhost:{servers[2].port}"]).client(0)
        probe.lpush("probe", *[f"p{i}" for i in range(64 * 21)])
        sweep_ms = []
        for _ in range(21):
            pipe = probe.pipeline()
            for _ in range(64):
                pipe.rpoplpush("probe", "probePending")
            t0 = time.perf_counter()
            pipe.execute()
            sweep_ms.append((time.perf_counter() - t0) * 1e3)
        probe.flushall()
        probe.close()
        spec = ",".join(f"localhost:{s.port}" for s in servers[:2])
        t0 = time.perf_counter()
        sharded = engine_verb(work, short, "fleet-verb.txt", dev.type,
                              "learner.type=softMax",
                              f"broker.shards={spec}")
        verb_s = time.perf_counter() - t0
        local = engine_verb(work, short, "fleet-local.txt", dev.type,
                            "learner.type=softMax")
        with open(os.path.join(work, "fleet-verb.txt")) as fh:
            got = fh.read()
        with open(os.path.join(work, "fleet-local.txt")) as fh:
            want = fh.read()
        sharded.pop("overlap_fraction")
        local.pop("overlap_fraction")
        shard = sharded.pop("broker_shard")
        if got != want or sharded != local:
            raise AssertionError("phase 17 broker.shards: the verb's file "
                                 "or line differs from in-process")
        # the grouped engine over the fan-out
        groups = [f"g{i}" for i in range(GROUPED_GROUPS)]
        routing = consistent_route(groups, range(2))
        fleet = BrokerFleet([f"localhost:{s.port}" for s in servers])
        fleet.flushall()
        with open(os.path.join(work, "rewards.txt")) as fh:
            pairs = [line.split(",") for line in fh.read().split()]
        for i, e in enumerate(ids[:GROUPED_EVENTS]):
            g = groups[i % len(groups)]
            fleet.client(routing[g]).lpush(f"eventQueue:{g}", f"{g}:{e}")
        for j, (a, r) in enumerate(pairs):
            g = groups[j % len(groups)]
            fleet.client(routing[g]).lpush(f"rewardQueue:{g}",
                                           f"{a},{float(r)}")
        queues = ShardedQueues(fleet, groups, routing)
        engine = GroupedServingEngine(
            "softMax", groups, LeadGenSimulator().actions,
            dict(ONLINE_CONF, **{"random.seed": 7}), queues, seed=7,
            device=dev)
        t0 = time.perf_counter()
        stats = engine.run()
        torch.cuda.synchronize()
        fan_s = time.perf_counter() - t0
        answers = sorted(raw.decode() for s in (0, 1) for raw in
                         fleet.client(s).lrange("actionQueue", 0, -1))
        with open(os.path.join(
                work, f"grouped-softMax-{dev.type}-inproc.txt")) as fh:
            inproc = sorted(fh.read().split())
        if (answers != inproc or queues.pending_left()
                or stats.events != GROUPED_EVENTS):
            raise AssertionError("phase 17 ShardedQueues: the grouped "
                                 "engine's answers differ from (b)'s file")
        queues.close()
        # re-route over three shards and migrate each moved group
        rerouted = consistent_route(groups, range(3))
        moved = [g for g in groups if rerouted[g] != routing[g]]
        if not moved:
            raise AssertionError("phase 17: re-routing moved no group")
        before, n_moved = {}, 0
        for g in moved:
            old = fleet.client(routing[g])
            old.lpush(f"eventQueue:{g}", f"{g}:late0", f"{g}:late1")
            old.rpoplpush(f"eventQueue:{g}", f"pendingQueue:{g}")
            old.lpush(f"rewardQueue:{g}", "a,1.0")
            before[g] = sorted(
                old.lrange(f"eventQueue:{g}", 0, -1)
                + old.lrange(f"pendingQueue:{g}", 0, -1)
                + old.lrange(f"rewardQueue:{g}", 0, -1))
            n_moved += migrate_group_queues(fleet, g, routing[g],
                                            rerouted[g])
        for g in moved:
            old, new = fleet.client(routing[g]), fleet.client(rerouted[g])
            left = sum(old.llen(f"{q}:{g}") for q in
                       ("eventQueue", "pendingQueue", "rewardQueue"))
            after = sorted(new.lrange(f"eventQueue:{g}", 0, -1)
                           + new.lrange(f"rewardQueue:{g}", 0, -1))
            if left or after != before[g]:
                raise AssertionError(f"phase 17 migrate {g}: {left} left on "
                                     "the old shard or entries lost")
    finally:
        if fleet is not None:
            fleet.close()
        for s in servers:
            s.close()
    return (f"phase 17 fleet: ReinforcementLearnerTopology broker.shards "
            f"over two MiniRedis brokers (the job's group on shard {shard}) "
            f"on {FLEET_IDS} ids in {verb_s:.2f} s: actions file and JSON "
            "line equal to the in-process engine's; GroupedServingEngine "
            f"over ShardedQueues, {GROUPED_GROUPS} groups on two shards, "
            f"{GROUPED_EVENTS} events in {fan_s:.2f} s: answers equal to "
            f"(b)'s, ledgers empty; {len(moved)} groups re-routed onto a "
            f"third shard, {n_moved} entries migrated, none left on the old "
            "side, none lost; a pipelined sweep of 64 RPOPLPUSHes on "
            f"MiniRedis: median {statistics.median(sweep_ms[1:]):.2f} ms "
            "(host clock)")


def serving_phase(dev, work):
    """Phase 17: boosted serving under the engine (``boost_serving``),
    the grouped engine (``grouped_engines``) and the broker fleet
    (``fleet_legs``). Run alone (``python3 chip_smoke.py
    serving_phase``) it first writes phase 14's inputs (the kernels build
    at the first K1 launch). Returns K1-int's launches on its path."""
    t_phase = time.perf_counter()
    if not os.path.exists(os.path.join(work, "rl.properties")):
        actions, _, rewards = online_inputs(work, ONLINE_EVENTS)
        online_properties(work, actions, rewards)
    launches, lines = boost_serving(dev, work)
    for line in lines:
        log(line)
    log(grouped_dispatch_sync_free(dev))
    log(grouped_engines(dev, work))
    log(fleet_legs(dev, work))
    log(f"phase 17 wall: {time.perf_counter() - t_phase:.1f} s")
    return launches


# --------------------------------------------------------------------------
# phase 18: the scale-out tier (worker processes over one broker)
# --------------------------------------------------------------------------

# run_scaleout's width and the tutorial's sweep (docs/TUTORIALS.md:222-228,
# :365): 8 groups, 4 actions, 1,000 throughput events and 200 paced at
# 100/s; the engine form at 2,000 throughput events; run_chaos(2,
# n_events=400, kill_after=100)
SCALEOUT_EVENTS = 1000
SCALEOUT_PACED = 200
SCALEOUT_RATE = 100.0
SCALEOUT_ENGINE_EVENTS = 2000
SCALEOUT_GROUPS, SCALEOUT_ACTIONS = 8, 4
SCALEOUT_CONF = {"current.decision.round": 1, "batch.size": 8}
CHAOS_EVENTS, CHAOS_KILL_AFTER = 400, 100
CHAOS_MAX_DUPLICATES = {False: 50, True: 128}
# (a): prefilled events and rewards one worker serves on each device
SCALEOUT_PARITY_EVENTS, SCALEOUT_PARITY_REWARDS = 64, 16
SCALEOUT_PARITY_TYPES = ("softMax", "upperConfidenceBoundOne")


def scaleout_parity(dev) -> str:
    """(a): one worker subprocess on the card and one with ``--device
    cpu`` for each learner of ``SCALEOUT_PARITY_TYPES``, through the step
    loop and through the engine, all started together, each over an
    in-process MiniRedis prefilled with the same events, rewards and stop
    sentinels: the card's action queue equal to the CPU's byte for
    byte."""
    from avenir_tpu_torch.stream import scaleout as S
    from avenir_tpu_torch.stream.miniredis import (MiniRedisClient,
                                                   MiniRedisServer)
    groups = [f"g{i}" for i in range(SCALEOUT_GROUPS)]
    actions = [f"a{i}" for i in range(SCALEOUT_ACTIONS)]
    rng = np.random.default_rng(SEED)
    events = [f"{groups[i % len(groups)]}:{i}"
              for i in range(SCALEOUT_PARITY_EVENTS)]
    rewards = [(groups[j % len(groups)],
                f"{actions[int(rng.integers(len(actions)))]},"
                f"{float(rng.integers(0, 2))}")
               for j in range(SCALEOUT_PARITY_REWARDS)]
    legs = [(t, engine, on) for t in SCALEOUT_PARITY_TYPES
            for engine in (False, True) for on in (dev.type, "cpu")]
    servers, procs, queues = [], [], {}
    t0 = time.perf_counter()
    # a worker visits its groups in the order of a set of their names,
    # which string hashing orders per process: two workers write their
    # answers in one order only under one hash seed
    hash_seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = str(SEED % 1000)
    try:
        for t, engine, on in legs:
            server = MiniRedisServer("localhost", 0).start()
            servers.append(server)
            client = MiniRedisClient("localhost", server.port)
            for e in events:
                client.lpush(f"eventQueue:{e.partition(':')[0]}", e)
            for g, r in rewards:
                client.lpush(f"rewardQueue:{g}", r)
            for g in groups:
                client.lpush(f"eventQueue:{g}", S.STOP_SENTINEL)
            procs.append((client, S._spawn_worker(
                "localhost", server.port, 0, 1, groups, t, actions,
                SCALEOUT_CONF, SEED, engine=engine, device=on)))
        for (t, engine, on), (client, p) in zip(legs, procs):
            out, err = S._collect_worker(p, timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"phase 18 (a) {t} worker on {on}: "
                                     f"{err[-1500:]}")
            stats = json.loads(out.splitlines()[-1])
            queues[t, engine, on] = client.lrange("actionQueue", 0, -1)
            if stats["events"] != len(events) or \
                    len(queues[t, engine, on]) != len(events):
                raise AssertionError(f"phase 18 (a) {t} on {on}: {stats}")
    finally:
        if hash_seed is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = hash_seed
        for client, p in procs:
            if p.poll() is None:
                p.kill()
            client.close()
        for server in servers:
            server.close()

    def by_group(lines):
        out = collections.defaultdict(list)
        for line in lines:
            out[line.split(b":")[0]].append(line)
        return out
    for t, engine, on in legs:
        card, cpu = queues[t, engine, on], queues[t, engine, "cpu"]
        if on != "cpu" and card != cpu:
            raise AssertionError(
                f"phase 18 (a) {t} {'engine' if engine else 'step loop'}: "
                "the card's action queue differs from the CPU's ("
                + ("the same answers in another order" if
                   by_group(card) == by_group(cpu) else
                   "the answers differ") + ")")
    return (f"phase 18 (a) one worker process on the card and one on the "
            f"CPU, {SCALEOUT_PARITY_EVENTS} events and "
            f"{SCALEOUT_PARITY_REWARDS} rewards prefilled over "
            f"{SCALEOUT_GROUPS} groups, {', '.join(SCALEOUT_PARITY_TYPES)}, "
            "step loop and engine (eight processes side by side, "
            f"{time.perf_counter() - t0:.1f} s): action queues equal byte "
            "for byte")


def _compute_apps() -> dict:
    """{pid: MiB} of the card's compute processes, as ``nvidia-smi
    --query-compute-apps`` lists them (empty where a container hides
    them)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    apps = {}
    for line in out.stdout.strip().splitlines():
        pid, _, mib = line.partition(",")
        if pid.strip().isdigit() and mib.strip().isdigit():
            apps[int(pid)] = int(mib)
    return apps


def scaleout_run(label, n_workers, on, contexts=None, **kw):
    """One ``run_scaleout`` at the tutorial's width, its gates (every
    event answered once, which the driver also raises on; ownership
    disjoint and total; heartbeats) and its line. ``contexts``, a dict,
    gets the card's memory once every worker is up."""
    from avenir_tpu_torch.stream.scaleout import run_scaleout
    events = kw.pop("throughput_events", SCALEOUT_EVENTS)
    free_before = torch.cuda.mem_get_info()[0]

    def up(start_s):
        if contexts is not None:
            contexts["start_s"] = start_s
            contexts["apps"] = _compute_apps()
            contexts["used_mib"] = (free_before
                                    - torch.cuda.mem_get_info()[0]) / 2 ** 20
    t0 = time.perf_counter()
    r = run_scaleout(n_workers, n_groups=SCALEOUT_GROUPS,
                     n_actions=SCALEOUT_ACTIONS, throughput_events=events,
                     paced_events=SCALEOUT_PACED, paced_rate=SCALEOUT_RATE,
                     seed=SEED % 1000, device=on, on_workers_up=up, **kw)
    wall = time.perf_counter() - t0
    total = sum(w["events"] for w in r.worker_stats)
    owned = [set(w["groups"]) for w in r.worker_stats]
    if total != 4 * SCALEOUT_GROUPS + events + SCALEOUT_PACED \
            or sum(len(g) for g in owned) != SCALEOUT_GROUPS \
            or len(set().union(*owned)) != SCALEOUT_GROUPS \
            or r.heartbeats <= 0:
        raise AssertionError(f"phase 18 {label}: {total} events, ownership "
                             f"{owned}, {r.heartbeats} heartbeats")
    return r, (f"{label} on {on}: {r.decisions_per_sec:,.1f} decisions/s "
               f"({events} events; each worker's from its heartbeats "
               + ", ".join(f"w{w} {t:.1f}" for w, t in
                           sorted(r.worker_throughput.items()))
               + f"), p50 {r.p50_latency_ms:.1f} / p90 "
               f"{r.p90_latency_ms:.1f} ms ({SCALEOUT_PACED} at "
               f"{SCALEOUT_RATE:.0f}/s), best_action_fraction "
               f"{r.best_action_fraction:.3f}, stragglers {r.stragglers}, "
               f"{r.heartbeats} heartbeats, start s "
               + ", ".join(f"{s:.2f}" for _, s in
                           sorted(r.worker_start_s.items()))
               + f"; {wall:.1f} s")


def scaleout_chaos(on, engine) -> str:
    """(c): ``run_chaos`` at the tutorial's call: nothing lost after
    dedup, the ledger empty, duplicates within the crash window."""
    from avenir_tpu_torch.stream.scaleout import run_chaos
    t0 = time.perf_counter()
    r = run_chaos(2, n_events=CHAOS_EVENTS, kill_after=CHAOS_KILL_AFTER,
                  engine=engine, device=on)
    if r.unique_answered != r.n_events or r.pending_left != 0 \
            or r.killed_at < CHAOS_KILL_AFTER \
            or r.duplicates > CHAOS_MAX_DUPLICATES[engine]:
        raise AssertionError(f"phase 18 (c) chaos engine={engine}: {r}")
    return (f"{'engine' if engine else 'step loop'}: killed at "
            f"{r.killed_at}, {r.unique_answered}/{r.n_events} answered, "
            f"{r.duplicates} duplicates (bar "
            f"{CHAOS_MAX_DUPLICATES[engine]}), {r.replayed} replayed, "
            f"{r.pending_left} pending; {time.perf_counter() - t0:.1f} s")


def scaleout_phase(dev, work):
    """Phase 18: the scale-out tier (``stream/scaleout.py``) on the card,
    which launches none of the port's kernels (the workers' learners are
    torch ops): (a) ``scaleout_parity`` and (c) ``run_chaos`` through the
    step loop and the engine, the three side by side (gates, timed only
    as legs); then, one at a time, (b) ``run_scaleout`` through the step
    loop at 4 workers and through the engine at 2 (2,000 throughput
    events); (d) the card's memory and each worker's start once every
    worker of (b)'s 4-worker run is up; (e) ``run_scaleout(2)`` with
    ``device="cpu"`` for scale."""
    from concurrent.futures import ThreadPoolExecutor
    t_phase = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        chaos = [pool.submit(scaleout_chaos, dev.type, e)
                 for e in (False, True)]
        log(scaleout_parity(dev))
        log("phase 18 (c) run_chaos(2, n_events=400, kill_after=100) on "
            "the card, beside (a): " + "; ".join(f.result() for f in chaos))
    contexts = {}
    lines = []
    for label, n, kw in (("4 workers", 4, {}),
                         ("engine, 2 workers", 2, {
                             "engine": True,
                             "throughput_events": SCALEOUT_ENGINE_EVENTS})):
        _, line = scaleout_run(label, n, dev.type,
                               contexts if n == 4 else None, **kw)
        lines.append(line)
    log(f"phase 18 (b) run_scaleout, {SCALEOUT_GROUPS} groups, "
        f"{SCALEOUT_ACTIONS} actions (host clock; {nvidia_smi_line()}): "
        + "; ".join(lines))
    apps = contexts["apps"]
    workers = {pid: mib for pid, mib in apps.items() if pid != os.getpid()}
    log(f"phase 18 (d) 4 workers up on the card ({nvidia_smi_line()}): "
        f"device memory taken since their spawn "
        f"{contexts['used_mib']:,.0f} MiB; nvidia-smi compute apps "
        + (", ".join(f"pid {pid} {mib} MiB" for pid, mib in
                     sorted(workers.items())) or "none listed")
        + "; seconds from spawn to first heartbeat "
        + ", ".join(f"w{w} {s:.2f}" for w, s in
                    sorted(contexts["start_s"].items())))
    _, line = scaleout_run("2 workers", 2, "cpu")
    log(f"phase 18 (e) run_scaleout for scale: {line}")
    log(f"phase 18 wall: {time.perf_counter() - t_phase:.1f} s")


#: the phases that run alone, ``python3 chip_smoke.py <name>``
ALONE = {"online_phase": online_phase, "engine_phase": engine_phase,
         "live_phase": live_phase, "serving_phase": serving_phase,
         "scaleout_phase": scaleout_phase}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if argv:
        # one phase alone (it builds the kernels it launches): its lines,
        # no result
        from avenir_tpu_torch.ops import _build
        from avenir_tpu_torch.utils.device import resolve_device
        if argv[0] not in ALONE:
            print(f"chip_smoke: run alone one of {sorted(ALONE)}",
                  file=sys.stderr)
            return 2
        log(f"{argv[0]} alone: {nvidia_smi_line()}")
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        work = tempfile.mkdtemp(prefix="smoke-alone-",
                                dir=str(_build.BUILD_DIR))
        try:
            ALONE[argv[0]](resolve_device("cuda"), work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0
    from avenir_tpu_torch.ops import _build
    from avenir_tpu_torch.utils.device import resolve_device
    dev = resolve_device("cuda")
    walls, t_mark = {}, [time.perf_counter()]

    def mark(phases):
        """The host-clock seconds since the last mark, under ``phases``."""
        now = time.perf_counter()
        walls[phases] = round(now - t_mark[0], 1)
        t_mark[0] = now

    smi = nvidia_smi_line()
    log(f"phase 1 card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s ({lib_path.name} "
        f"from {len(_build.sources())} sources, sm_90a)")
    log("phase 1 registers per thread, spills (ptxas): " + kernel_registers(
        (lib_path.parent / "build.log").read_text()))
    mma = mma_counts(lib_path)
    log("phase 1 HMMA and IMMA instructions (cuobjdump -sass): " + "; ".join(
        f"{name} {op} {count}" for name, (op, count) in mma.items())
        + " (tc_sweep_kernel<true, S, false> K6, and K9 through its strides; "
        "<false, S, false> K7; <true, S, true> K10, both layouts; K8's "
        "tc_nodot_kernel has no product; tc_int8_sweep_kernel<0, 1, 2> are "
        "K11, K11 with y2, K12)")
    ops = collections.Counter(op for op, count in mma.values() if count)
    # every bf16 sweep (K6 and K7 at four k-steps, K10 at four) and every
    # int8 one must hold tensor-core instructions
    if ops != {"HMMA": 12, "IMMA": 3} or len(mma) != 15:
        raise AssertionError(f"the tensor-core sweeps lack HMMA or IMMA: "
                             f"{mma}")

    rng = np.random.default_rng(SEED)
    k1 = check_k1(dev, rng)
    k4 = check_k4(dev, rng)
    k23 = check_k2_k3(dev)
    check_exact_ties(dev)
    folds = check_fold(dev)
    for name, err in check_tc_edges(dev).items():
        folds[name]["max_abs_err"] = max(folds[name]["max_abs_err"], err)
    folds.update(check_sweep_folds(dev))
    folds["K10"]["max_abs_err"] = max(folds["K10"]["max_abs_err"],
                                      check_raw_edges(dev))
    check_int8_edges(dev)
    check_int8_packing(dev)
    mark("1-2")
    # phases 3-12 run each CLI job cold, as separate processes would: a
    # staged-table cache of 0 bytes keeps nothing (a warm table would also
    # keep KNN's IVF index, whose K1 launches phase 3 counts); phase 13
    # drives the cache with its own plan.cache.budget.bytes
    from avenir_tpu_torch.plan import staged_cache
    staged_cache().set_budget(0)
    work = tempfile.mkdtemp(prefix="smoke-", dir=str(_build.BUILD_DIR))
    try:
        launches = cli_phase(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mark("3")
    launches.update(fold_harnesses(dev))
    mark("4")
    for name, count in sweep_harnesses().items():
        launches[name] = launches.get(name, 0) + count
    mark("5")

    k1_ivf = quantized_ivf_phase(dev)
    mark("6")
    work = tempfile.mkdtemp(prefix="smoke-tree-", dir=str(_build.BUILD_DIR))
    try:
        k1_tree = tree_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mark("7")
    work = tempfile.mkdtemp(prefix="smoke-seq-", dir=str(_build.BUILD_DIR))
    try:
        k4_markov = sequence_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mark("8")
    work = tempfile.mkdtemp(prefix="smoke-forest-",
                            dir=str(_build.BUILD_DIR))
    try:
        k1_forest = forest_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mark("9")
    work = tempfile.mkdtemp(prefix="smoke-boost-", dir=str(_build.BUILD_DIR))
    try:
        k1_boost = boost_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mark("10")
    work = tempfile.mkdtemp(prefix="smoke-modes-", dir=str(_build.BUILD_DIR))
    try:
        k1_text, modes = modes_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mark("11")
    work = tempfile.mkdtemp(prefix="smoke-batch-", dir=str(_build.BUILD_DIR))
    try:
        batch = batch_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mark("12")
    work = tempfile.mkdtemp(prefix="smoke-plan-", dir=str(_build.BUILD_DIR))
    try:
        planned = plan_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mark("13")
    work = tempfile.mkdtemp(prefix="smoke-online-",
                            dir=str(_build.BUILD_DIR))
    try:
        online_phase(dev, work)
        mark("14")
        engine_phase(dev, work)
        mark("15")
        k1_live = live_phase(dev, work)
        mark("16")
        serving_launches = serving_phase(dev, work)
        mark("17")
        scaleout_phase(dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mark("18")
    for name in ("K1", "K2", "K3"):
        launches[name] += modes[name] + planned[name]

    launches["K5"] = k23["K5_launches"]
    launches["K4-one"] = k4["one_launches"]
    kernels = []
    for name, entry in (("K1", k1), ("K2", k23["K2"]),
                        ("K2-sweep", k23["K2-sweep"]),
                        ("K2-nodot", k23["K2-nodot"]), ("K3", k23["K3"]),
                        ("K4-one", k4["one"]), ("K4", k4["multi"]),
                        ("K5", k23["K5"]), *folds.items()):
        entry = dict(entry)
        entry["launches"] = launches[name]
        kernels.append(entry)
    kernels.append(k1_ivf)
    kernels.append(k1_tree)
    kernels.append(k4_markov)
    kernels.append(k1_forest)
    # the boosted engine's refit waves launch K1's integer mode too
    k1_boost["launches"] += serving_launches
    k1_boost["serving_launches"] = serving_launches
    kernels.append(k1_boost)
    kernels.append(k1_text)
    kernels += batch
    kernels.append(k1_live)
    log(f"phase walls (s, host clock): {walls}; total "
        f"{sum(walls.values()):.1f}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
