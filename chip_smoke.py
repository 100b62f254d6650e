#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, each printing its own lines:
  (a) the card (``nvidia-smi`` name and power limit), torch / CUDA
      versions, and the build of the CUDA kernels from the sources in the
      checkout (one ``nvcc`` per source, all started together);
  (b) each kernel (K1, K2 streaming top-k; K4 EmbeddingBag and its
      backward K4T) against its plain PyTorch version on the card, at
      the main-path shapes (K4's at serve_p99, serve_bulk,
      retrieval_cand and train_batch) and at edge shapes: bitwise on integer-valued inputs, within TOL on random
      floats for K1 (K2 only compares and copies, and K4 adds the slots in
      the plain version's order: both bitwise on every input, float and
      bf16 included); K1 also bitwise equal to itself on float inputs
      across row-range counts (one, an odd count, its wrapper's plan) and
      across superchunk sizes (one launch over S = 64, eight over S = 8),
      and K4 across forced plans (tiles of 1, 7 and the most bags shared
      memory holds, crossed with slot passes of 1, 7 and L); K4T, which
      adds each row's contributions in its plain version's order, bitwise
      on every input (tolerance 0, float and bf16 included) at
      train_batch's shapes (DeepFM's ids at D = 10 and 1, Wide&Deep's at
      D = 1; DeepFM's with 5 % of each field on one hot row) and at the
      edges (padding, ids repeated in a bag, all padded, L = 0, B = 0,
      ids >= V, non-finite gradients and weights under padding, V off
      and below one tile, ids only in the first and last rows, a run of
      40,000 equal ids, runs of 31 / 32 / 33, an out 20 bytes into its
      storage), its output filled with NaN before each launch, on two
      launches and at four forced plans (tile bytes x threads x grid x
      an entry's work, K4T_PLANS);
      then each kernel's time, its plain version's, one library call's
      for the same function, and its bound (K1 and K2 at three shapes
      each, K4 at serve_p99, serve_bulk and retrieval_cand for D = 10 and
      1, with the plan each wrapper chose, K4T at train_batch, uniform
      and skewed, with its sort and kernel timed apart and its longest
      run of equal ids, and DeepFM's pair of K4T calls with and without
      one shared sort (``ops.BagKeys``); K2, where it splits, at half,
      one and two blocks per SM; each two-stage kernel's stages' device
      time from torch.profiler comes after phase (f));
  (c) trove-base at full width (12 x 768, bf16, seeded random weights) on
      a synthetic dataset through ``RetrievalEvaluator.evaluate`` /
      ``search`` / ``mine_hard_negatives`` with the backend pairs
      (fused, kernel), (torch, kernel) and (torch, torch);
  (d) serving through ``repro_torch.core.serving.ServeFrontend`` at full
      width on (c)'s corpus, device-resident, S = 64: (d1)
      ``from_evaluator``: the rung warm pass, 8 requests of 32 queries one
      at a time (each timed, request 0 also against an exact float64
      top-k, and the bare ``search_texts`` of each timed before and after
      them as the baseline)
      and 64 single-query requests from 8 threads (p50 / p99 / QPS), each
      request held against its solo ``search_texts`` (scores within TOL,
      ids equal where separated), and the frontend's stats; (d2) the same
      through ``from_cluster`` at W = 2 (``SimulatedCluster``), against
      the W = 1 solos; (d3) ``repro_torch.launch.serve.main`` at
      ``--workers 1``, ``--workers 2`` and ``--mutate`` (64 single-query
      requests from 8 threads over (c)'s dataset), printing p50 / p99 /
      QPS, each request at ``--workers 1`` and ``2`` held against a solo
      W = 1 ``search_texts`` over the launcher's own prepared corpus, and
      on ``--mutate``'s live set its shapes, finite descending scores and
      ids among the corpus's and the run's writes;
  (e) launches per path: every kernel's count is set to 0 just before
      each evaluate / search / mine_hard_negatives call of (c), each
      serving path of (d), each recsys cell of (f), each cached path of
      (g), each W > 1 path of (h), each fault path of (i), each data
      path of (j), each IVF path of (k), each training path of (l) and
      each recsys training path of (m), each LM encoder path of (n),
      each LM training path of (o), each MoE path of (p), each
      decode path of (q), each GNN path of (r), each card path of (s) and
      each rank's (t1) run of (t) and each rank's (u) run,
      and read just after; each kernel
      of that path must have launched exactly as
      often as predicted (``ShardedSearchDriver.stats`` on (c) / (g) /
      (h), summed over ranks, and on (d) and (i) over every round of the
      path, rescores included, recorded by
      wrapping the driver's ``search`` / ``search_async`` in this script:
      one K1 launch per superchunk call, one K2 launch per scored chunk;
      the model on (f): K4 twice per DeepFM forward, once per Wide&Deep
      forward, K2 once per retrieval; on (m) K4 and K4T twice a DeepFM
      step, once a Wide&Deep step, K4 alone on a serve forward), and a
      kernel off the path not at all;
  (f) recsys scoring at the full published widths (seeded random weights
      drawn on the card): DeepFM serve_p99 / serve_bulk / retrieval_cand,
      Wide&Deep serve_p99 / retrieval_cand, AutoInt and BST serve_p99;
      probabilities in (0, 1), 8 DeepFM rows against a float64 host
      recomputation, each retrieval top-k against an exact float64 top-k
      of the same scores; latencies, examples/s and peak memory;
  (g) the embedding cache (trove-base and the dataset of (c), a cache in
      a temporary directory): a cold ``evaluate(cache=)`` that fills it,
      warm ``evaluate`` / ``search`` for the three backend pairs and a
      warm ``mine_hard_negatives``, which must encode no corpus chunk
      ((torch, kernel) == (torch, torch) bitwise, fused within TOL,
      (torch, torch) against an exact float64 top-k over the snapshot's
      float16 rows); a live corpus (512 deletes, 256 re-embeds, 256 adds,
      a compaction) searched through ``prepare_cache_corpus`` +
      ``search_texts``, each search bitwise equal to a search over a
      frozen copy of its pinned snapshot and within TOL of an exact
      float64 top-k over its rows; a second cache of 262,144
      random unit rows searched by 256 queries at S = 64, with the host
      read, the upload of one superchunk and their share of the search;
  (h) W > 1 workers on the one card (the model, dataset, k, C and S of
      (c)): (h1) an online ``evaluate`` / ``search`` at W = 2 through
      ``SimulatedCluster``, each rank encoding its own shard, ranks
      identical and within TOL of (c)'s W = 1; (h2) one device-resident
      prepared corpus at W = 1, 2, 4 for the three backend pairs, a
      256-query ``search_prepared`` and four 32-query ``search_texts``,
      every rank bitwise equal to W = 1, with each rank's round and
      gather + merge ms and each request's wall time; (h3) the prepared
      rows in an ``EmbeddingCache`` at W = 2, bitwise equal to W = 1 over
      the same snapshot, and with 64 rows added between rank 0's and rank
      1's prepare: rank 1's ``GenerationMismatch`` (round not consumed),
      its re-prepare at the agreed key, the same result; (h4) two rank
      processes (this script with ``--h4-rank``) over ``torch.distributed``
      with ``ProcessAllGather``, bitwise equal to W = 1 over one pinned
      snapshot, cutting the corpus identically on the second search.
      Launches on every (h) path: the sum over ranks of each rank's
      prediction;
  (i) faults on the card (the model, dataset, k, C and S of (c), one
      device-resident prepared corpus, 32-query ``search_texts``, a
      round deadline of 0.5 s and stalls of 1 s): (i1) the chaos matrix —
      a resilient ``SimulatedCluster`` at W = 2 and 4 for the (fused,
      kernel) and (torch, kernel) pairs, with a crash, a stall or a
      dropped gather send at worker 1 in round 0, every rank bitwise
      equal to the pair's no-fault W = 1 search with coverage 1, worker
      1's shard rescored once (and only a crashed rank marked dead; the
      clean rounds with no rank dead and nothing rescored), and after a
      crash a second round in which the dead rank's shard is empty;
      each recovered round's time
      against the clean round's and the rescore's share of it; (i2) the
      retry budget spent at W = 2 (coverage 0.5, bitwise equal to a W = 1
      search over rank 0's rows alone), then a request deadline with a
      stalled rescuer at W = 4 (coverage 0.75, resolved within the
      deadline plus a stated slack); (i3) 20 rounds at W = 4 with a crash
      in round 0 and the ranks' acquires staggered (the order that made
      the reference merge a shard twice): no duplicate id, every round
      bitwise equal to W = 1, rank 1 the only rank dead and its round-0
      shard the only one rescored; (i4) ``ServeFrontend.from_cluster`` on a
      resilient W = 2 cluster whose rank 1 crashes in the first
      steady-state round (every request resolved, each non-degraded one
      within TOL of its solo W = 1 ``search_texts``), then
      ``repro_torch.launch.serve.main --workers 2 --resilient --chaos``
      crash / stall / drop with its ``chaos:`` line, held as (d3) holds
      its runs.  Launches on every (i) path: each rank's calls on its own
      shard and on the shards it rescored (``retry_dispatch_rounds`` /
      ``retry_chunks``), summed; a crashed rank dies before its first
      chunk is scored and launches nothing;
  (j) data management on the card (the model, k, C and S of (c)): two
      datasets of 128 queries and 4096 docs (``repro_torch.launch.
      evalsuite.make_synthetic_suite``, seeds 100 and 101, ids "d0-" /
      "d1-") loaded through ``build_scenarios`` (``MaterializedQRel``
      mmap tables, ``TableView``s, hash-keyed qrels): (j1) ``evaluate_
      suite`` online on (fused, kernel) and (torch, kernel), each
      dataset's row equal to a solo ``evaluate``, the combined pass over
      a ``ConcatView`` bitwise equal to a search of the eagerly merged
      dict union (its row equal to the union's metrics), the two pairs
      within TOL; (j2) the suite with one ``EmbeddingCache``: the
      per-dataset passes cold, the combined pass encoding no corpus row
      and bitwise equal to the warm dict union's; (j3) the suite over
      that cache at W = 2 (``SimulatedCluster``), every rank's tables and
      combined rankings equal W = 1's, rank 0 alone writing the tables;
      (j4) ``repro_torch.launch.evalsuite.main`` at full width,
      ``--workers 1`` then ``2`` (64 queries x 1024 docs a dataset), its
      tables equal to an in-process ``evaluate_suite`` on the same files,
      with its wall time; (j5) the paper's memory claim as host RSS
      (after ``benchmarks/bench_memory.py``: a subprocess's peak RSS less
      its import floor, 150,000 docs of 80 words and two parts of 75,000):
      naive loading against ``MaterializedQRel`` (``table1``) and a naive
      union dict against a streamed ``ConcatView`` of ``TableView``s
      (``concat_view``), beside the reference's container figures; it
      fails only if the streamed union takes more than the naive one.
      Launches on every (j) path: the sum over its driver rounds;
  (k) the IVF index on the card (the model, dataset, k, C and S of (c),
      64 clusters, pruned rounds probing 8): (k2) a cold ``evaluate(
      cache=)`` that builds and saves ``{cache}/ivf_k64``, two warm
      searches (the first rebuilds under the pinned snapshot's digest, as
      the reference does, the second loads it, 0 builds, bitwise equal),
      warm evaluates flat and pruned and a warm ``mine_hard_negatives``;
      (k1) device-resident prepared corpora over the warm cache's rows on
      (fused, kernel) and (torch, kernel): a full probe against flat
      (scores bitwise, ids equal outside runs of exactly equal scores),
      nprobe 8 against an exact float64 top-k over the selected rows for
      the 256-query batch and for single queries, with rows scanned and
      recall@100 against flat; (k3) W = 1 (twice), 2 and 4, every rank
      building its own index from its own cache copy: centroids, perm and
      offsets bitwise equal across ranks and builds, every rank bitwise
      equal to W = 1, every cut on a cluster edge; then a crash at W = 2
      (the snapped shard rescored, bitwise equal to W = 1) and the round
      after it (the dead rank's shard empty, cuts on edges); (k4)
      ``ServeFrontend.from_evaluator`` at nprobe 64 driven as (d1) is,
      each request held against its flat solo ``search_texts``; at nprobe
      8 each request against an exact float64 top-k over its
      micro-batch's selection (recorded by wrapping ``round_for``) and at
      least its solo pruned search; ``serve.main --index-impl ivf`` at
      ``--workers 1`` and ``2``; (k2) a live corpus through
      ``prepare_cache_corpus`` (deletes and adds, a compaction into
      ``cluster_order``), one build per generation, each search against an
      exact float64 top-k over its snapshot's selected rows; (k5) 262,144
      seeded unit rows around 512 topics drawn on the card (the
      reference's ``_clustered`` recipe), 512 clusters (k-means and
      assignment times), 8 requests of 32 queries at nprobe 8, 32, 512
      and flat (ms, rows scanned, recall@100; nprobe 512 held as (k1)
      holds a full probe), and K1 timed on the nprobe-8 round's first
      superchunk.  Launches on every (k) path: the sum over its driver
      rounds and ranks;
  (l) retrieval training on the card: (l1) ``repro_torch.launch.train`` at
      trove-base's full width (bf16, seeded weights, each layer checkpointed
      in the backward: ``remat``) on its own synthetic dataset (256 queries,
      2048 docs), 20 steps of 8 queries x 2 passages (32 / 128 tokens at
      most) at a learning rate of 1e-4, async checkpoints every 10 steps:
      every logged loss and grad_norm finite, the loss falling, every weight
      matrix changed, ``step_00000010`` / ``step_00000020`` in the
      reference's layout with the last one's bf16 leaves decoded bit-exact
      straight from the npz; the median step ms split into forward /
      backward / clip + optimizer (CUDA events), tokens/s and peak memory;
      (l2) the same run with a failure injected at step 15 (step 10
      restored) against an uninterrupted one, both under
      ``torch.use_deterministic_algorithms``: final parameters bitwise
      equal, and a third such run with ``remat`` off: its final parameters
      bitwise the run's with it; (l3) ``serve.main --ckpt-dir`` on (l1)'s
      checkpoint: the restored params bitwise equal to the trainer's, 8
      requests of 32 queries each within TOL of a solo ``search_texts``;
      (l4) the paper's round trip: ``mine_hard_negatives`` with the trained
      params on (fused, kernel) and (torch, kernel), the two TSVs equal line
      for line in their documents where scores are separated and in their
      scores within TOL, a retrain of 5 steps from (l1)'s last checkpoint on
      a ``BinaryDataset`` of the mined negatives, then ``evaluate`` on
      (fused, kernel) of the seeded, the trained and the retrained params.
      Launches: 0 on every training path, the driver's prediction on the
      serving, mining and evaluation paths;
  (m) recsys training at the full published widths (seeded random
      weights drawn on the card), the ``train_batch`` cell (B = 65,536;
      BCE, backward, clip, AdamW): (m1) DeepFM, Wide&Deep, AutoInt and BST
      10 steps each on one seeded batch, every loss and grad_norm finite
      and the loss falling (a smoke check: the lowest of the second half
      below the first, as AdamW's first steps may overshoot), the step
      median in CUDA
      events split into forward / loss and backward / clip and AdamW,
      examples/s and peak memory against the parameters' bytes; (m3)
      DeepFM's and Wide&Deep's gradients of ``table``, the bag table
      (``linear_table`` / ``wide_table``, on the rows 512 examples touch)
      and ``mlp_w0`` against a float64 host recomputation of the
      reference's formula, within 1e-4 of each tensor's largest
      |gradient|, and one step of the cell on those examples from a fresh
      AdamW state against AdamW's first step computed on the host in
      float64 from those gradients (dense parameters and touched rows,
      with the stated per-element tolerance; untouched rows moved by
      weight decay alone); (m4) the
      trained DeepFM through the serve_p99 cell, probabilities in (0, 1);
      (m2) DeepFM and Wide&Deep 3 steps twice from one seed under
      ``torch.use_deterministic_algorithms``, final parameters bitwise
      equal;
  (n) the dense LM encoders at their published widths (bf16, seeded
      weights drawn on the card, each model freed before the next):
      qwen2-0.5b (24 x 896, GQA 14 / 2, QKV biases), stablelm-3b (32 x
      2560, head_dim 80, LayerNorm) and gemma-7b (28 x 3072, 16 x 256,
      GeGLU, the bf16 sqrt(d) embedding scale): (n1) ``evaluate`` over
      (c)'s recipe at N1_DOCS docs (256 queries) on (fused, kernel), (torch,
      kernel) and (torch, torch), (torch, kernel) == (torch, torch)
      bitwise, fused within
      TOL of torch, K1's scores within TOL of a float64 host product of
      the very embeddings the (fused, kernel) pass scored (recorded by
      wrapping the driver's ``search`` and the encode pipeline's chunk
      source) and its ranking within TOL of the exact top-k, then
      ``mine_hard_negatives`` on (fused, kernel); pass time, padded
      tokens/s, peak memory and parameter bytes; (n3) the ``LMArch``
      ``prefill_32k`` encode cell at one row of 32,768 tokens, its
      attention in 8 chunks of 4096 (the calls counted by wrapping the
      score function), ms and peak memory, and chunked against one pass
      at 8,192 tokens; (n4) 64 passages and 64 queries encoded with the
      bf16 weights and with the same weights cast to float32 (gemma-7b:
      its first 4 layers), each row's cosine and the overlap of the
      queries' top-10 over the passages; K1 at each width (Q = 256, S =
      64, C = 32, k = 100) within TOL of its plain version and timed as
      in (b); then (n2) ``repro_torch.launch.serve.main --arch`` at
      ``--workers 1`` for trove-base, qwen2-0.5b, stablelm-3b and
      gemma-7b one after the other on one ``--data-dir`` (S pinned to
      64): each encodes its whole corpus into its own cache directory,
      each request within TOL of a solo ``search_texts`` over the
      launcher's own prepared corpus; and ``repro_torch.launch.evalsuite.
      main --arch qwen2-0.5b``.  Launches on every (n) path: the driver's
      prediction, summed over its rounds;
  (o) the dense LM encoders under training, each freed before the
      next: (o1) ``repro_torch.launch.train --arch`` for qwen2-0.5b and
      stablelm-3b (AdamW) and gemma-7b (Adafactor) at full width, bf16,
      remat, seeded, (l)'s dataset and batch, 5 steps, only the final
      checkpoint written: step ms split into forward / backward / clip +
      optimizer, padded tokens/s, peak memory against its reckoning,
      finite losses, the checkpoint's bytes and the disk free before;
      (o3) the trained weights through ``evaluate`` on the three pairs
      and ``mine_hard_negatives`` on (fused, kernel) at 1024 docs with
      (n1)'s rules, K1 held against its plain version at every shape the
      passes gave it, and qwen2-0.5b's checkpoint through
      ``serve.main --ckpt-dir`` (restored params bitwise the trainer's,
      each request within TOL of a solo search, the cache directory
      named by the checkpoint's step and manifest digest); each
      checkpoint deleted then; (o2) the ``train_4k`` cell (Adafactor) on
      the same weights at 4096 tokens, its batch cut to 4 / 2 / 2
      queries and as many passages, 2 steps: ms, tokens/s, peak, loss;
      then qwen2-0.5b's cell at 2 x 1024 tokens with remat on and off
      under deterministic algorithms: gradients and updated parameters
      bitwise equal.  Launches: 0 on the training paths, the driver's
      prediction on the scoring paths;
  (p) the MoE encoders at published widths: granite-moe-3b-a800m
      evaluated, mined, trained (launcher, ``train_4k``, remat on vs
      off) and llama4-maverick cut to one (dense, MoE) pair evaluated;
      the launchers;
  (q) the KV-cache decode, run inside each LM arch's turn of (n) and (p)
      on the weights already drawn (qwen2-0.5b, stablelm-3b, gemma-7b,
      granite-moe-3b-a800m, llama4-maverick's pair): the ``LMArch``
      serve cells ``decode_32k`` and ``long_500k`` at the cuts of
      ``Q_CUTS`` (batch for decode_32k, depth for long_500k), a cache of
      seeded N(0, 1) values stepped 4 times through the cell to its last
      position: step ms (CUDA events), tokens/s, the cache's GB/s, the
      bound (cache and weights read over 3.35 TB/s; for an MoE only the
      chosen experts), peak GiB against its reckoning; (q2) rows 0 and
      B - 1 against batch-1 steps on their slices of the cache, (q3)
      sampled positions other than ``len`` unchanged and ``len`` one
      more, (q4) finite (B, V) logits; qwen2-0.5b's decode_32k step
      traced (idle share, the costliest device operations); (q1)
      2 x 64 tokens decoded teacher-forced from an empty cache against
      ``lm_logits(forward_hidden)``, in bf16 at full depth and in
      float32 on 4 layers (TF32 off, the reference test's tolerance),
      an MoE's capacity factor raised until its prefill drops nothing.
      Launches: 0 on every (q) path;
  (r) the GNN, graphsage-reddit (2 x 128, mean, float32, seeded weights
      drawn on the card): (r1) its four ``GNNArch`` train cells at
      published shape — full_graph_sm (3,072 x 1,433 padded, 10,752
      edges, 1,024 pairs), minibatch_lg (1,024 anchors and their
      positives, 15 x 10 blocks sampled by the port's ``NeighborSampler``
      over ``make_random_graph(232,965, 25)``, d 602), ogb_products
      (2,449,408 x 100, 61,859,328 edges, 8,192 pairs) and molecule (128
      graphs of 30 nodes and 64 edges, d 64), inputs drawn on the card: a
      warm-up and 3 timed steps, twice from one seed, the losses and
      parameters of the two runs bitwise equal (a full graph's run builds
      its neighbour table once and carries it in the batch; a molecule
      step builds its views' tables); step ms split forward and loss /
      backward / clip + AdamW, peak GiB against its reckoning, the
      neighbour table's slots against the edges; one more ogb_products
      step traced after the last phase; (r2) K4 and K4T at every shape
      (r1) gave them (recorded by wrapping the wrappers,
      ``chip_smoke.BagCalls``), on that shape's first inputs, bitwise equal
      to their plain versions (K4T's whole call, on the path's kept sort,
      on every gradient row, 262,144 rows at a time), each timed beside
      its plain version, the library's
      ``F.embedding_bag`` (forward, or its backward) and its bound; (r3)
      ``GNNEncoder.encode`` over ogb_products with (r1)'s trained weights,
      256 query nodes searched over all 2,449,408 through
      ``ShardedSearchDriver`` at (fused, kernel), k = 100, S = 64, C = 32,
      against an exact float64 top-k computed on the card, K1 held and
      timed at d = 128; on full_graph_sm's nodes the nine score x heap
      pairs (each score's kernel heap bitwise its torch heap, its python
      heap equal off exact ties).  Launches: K4 per layer mean and for
      the pairs' rows, K4T per mean past layer 0 and for the pairs' rows,
      0 on minibatch_lg; the search's K1 as the driver predicts;
  (s) the analysis tools (``repro_torch.launch.{dryrun,roofline,memmodel,
      report}``): (s1) ``dryrun.run_cell`` for all 40 (arch x shape) cells
      at published shape on meta, on the host (a pool of S_WORKERS
      processes forked from a preloaded fork server; nothing reaches the
      card), each record complete with FLOPs > 0 and the ``flops_source``
      its step gives (``analytic: file:line`` where the step reads a
      device value on the host: the LM serve cells, the full and batched
      graphs), ``report.table`` printed as one line; (s2) qwen2-0.5b
      train_4k at (o2)'s 4 x 4096, DeepFM train_batch (K4, K4T) and
      graphsage-reddit minibatch_lg stepped on the card: a warm step, one
      step under ``CostMode`` whose FLOPs by dtype, bytes and kernel
      reports must equal, as integers, the meta count of the same cell at
      the same shape, three steps in CUDA events (the peak over the last),
      printed against the counted roofline bound, the bound with
      ``analytic_bytes`` and the memory model's total (no ratio asserted).
      Launches: DeepFM's K4 and K4T twice a step, 0 elsewhere;
  (t) the device mesh: four rank processes (this script with
      ``--t-rank``) over a gloo group on the one card, a bound (data 2,
      model 2) mesh (``repro_torch.sharding``), with the parent computing
      one-process oracles on the same seeded weights and batches beside
      them: (t1) DeepFM train_batch at published shape on the psum lookup
      (K4 over each rank's row shard in bags of one, other shards' ids -1,
      a bf16 all-reduce over "model"; K4T over the same ids), T_STEPS
      AdamW steps twice, bitwise equal, every rank's local shapes the
      rules', the looked-up rows bitwise the bf16 rounding of a one-process
      lookup, loss and every updated leaf within T_TOL of the parent's
      one-process step with the lookup rounded to bf16 (a test oracle),
      K4 / K4T bitwise against their plain versions at each rank's shard
      shapes; (t2) qwen2-0.5b train_4k at published width cut to
      T2_LAYERS layers, batch T2_BATCH of T2_LEN tokens, the same checks
      (bf16: the moments leaf by leaf), then one
      ``RetrievalTrainer(dp_mode="shard_map")`` int8 step with error
      feedback, twice, against the oracle's int8 step, then (t2f) the
      same LM in float32, held entry by entry and on every step's loss;
      (t3) (t2)'s state saved on (2, 2) through
      ``CheckpointManager.save(shardings=)`` and restored onto (4, 1) in
      the same group and onto this process,
      every leaf bitwise (SHA-256 of each rank's slices); each step's ms
      and collective bytes per rank printed; K4 / K4T timed at rank (0,
      0)'s shard shapes.  Launches: K4 and K4T twice a (t1) step on each
      rank, 0 on (t2) and (t2f);
  (u) the LM cells on a mesh: four rank processes (this script with
      ``--u-rank``) over a gloo group on the one card, bound (2, 2) and
      (1, 4) meshes, the parent running one-process oracles on the same
      seeded weights, caches and tokens beside them: the serve cells
      (``build_cell(shape, device, mesh)``, each rank its block of a cache
      laid out by ``cache_logical_axes``, filled from seeded draws, from
      ``len = S - U_STEPS``): (u1) qwen2-0.5b long_500k at published width
      and depth, 1 x 524,288, on both meshes; (u2) qwen2-0.5b decode_32k at
      batch 16, on both; (u3) granite-moe-3b-a800m decode_32k at 2 layers,
      batch 16, on (2, 2); each (u1) / (u2) cell with a float32 twin at 2
      layers; (u4) qwen2-0.5b prefill_32k at U4_BATCH x U4_LEN on (2, 2);
      (u5) granite train_4k at U5_LAYERS layers, U5_BATCH x U5_LEN, T_STEPS
      AdamW steps twice, then its float32 twin, as (t2) / (t2f), with the
      whole-batch aux that each rank's meshed forward returns held
      against the oracle's.  Held:
      the float32 twins' logits within U_F32_TOL of the oracle's, the bf16
      cells' within ``u_bf16_bound`` (relative 2-norm of a row), two runs
      bitwise and every rank alike, each step's collective calls and
      bytes equal to what its layout predicts (``u_decode_counts``,
      ``u_encode_counts``, ``u_train_counts``); step ms a rank, bytes a
      step and peak GiB against the reckoning printed.  Launches: 0 on
      every (u) path on every rank.
Each phase's wall seconds follow it (``[a] (x) ...: N s``), all of them
on one ``[a] seconds by phase`` line at the end.
The second-to-last line is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero without that line.  It imports nothing of JAX and nothing
of the reference package ``repro``.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# Score tolerance for float inputs: unit vectors in float32, summed in a
# different order by the kernel and by cuBLAS (each dot product of
# d = 768 terms carries ~1e-7 of rounding; 1e-5 leaves two decades).
TOL = 1e-5
# Main-path shapes: a query batch, trove-base's width, the default depth,
# a superchunk of 64 chunks of encode_batch_size = 32 rows (K1; K2 merges
# one such chunk of 32 scores per launch on the (torch, kernel) path), and
# a larger K2 chunk of 4096 scores.
Q, D, K, S, C, C2 = 256, 768, 100, 64, 32, 4096
# the recsys path's shapes: candidates per user at retrieval_cand (top-K
# of them), and K4's batches (serve_p99, serve_bulk, retrieval_cand)
NC = 1_000_000
BAG_BATCHES = (512, 262144, NC)
# the recsys training shape (B = 65,536): DeepFM's 39 fields and
# Wide&Deep's 40 at train_batch, where K4 runs forward and K4T backward
TRAIN_SHAPE = "train_batch"
# Cycles the card spins before each timed call (~0.2 ms at 1.98 GHz:
# longer than a wrapper takes to enqueue one launch).
SPIN_CYCLES = 400_000
# (timing entry, call, reset, kernel names) of each K1 / K2 timing whose
# two kernels torch.profiler times after the last phase: its CUDA tracing
# may leave a cost on every launch that follows it.
PROFILED = []
K1_STAGES = ("score_range_kernel", "fused_merge_kernel")
K2_STAGES = ("range_topk_kernel", "merge_partials_kernel")


def fail(msg: str) -> None:
    raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, reset, n: int = 30) -> float:
    """Median time of ``fn`` between two CUDA events, ``reset`` run
    outside the events before every call (the in-place kernels would
    otherwise find the state already full and do less work).

    A spin of SPIN_CYCLES on the card precedes the start event, so the
    card is still busy while the host enqueues ``fn``: the events then
    time the device's work, not the wrapper's Python before the launch
    (which otherwise lands between the events when ``fn`` is short)."""
    import torch
    for _ in range(3):
        reset()
        fn()
    times = []
    for _ in range(n):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def separated(vals) -> "torch.Tensor":
    """Mask of slots whose value is more than TOL from both neighbours:
    there a float comparison must agree on the id."""
    import torch
    inf = torch.full_like(vals[:, :1], float("inf"))
    up = torch.cat([inf, vals[:, :-1]], 1) - vals
    down = vals - torch.cat([vals[:, 1:], -inf], 1)
    return (up > TOL) & (down > TOL)


def compare(name, got, want, exact: bool) -> float:
    """Check (vals, ids) pairs; returns the max abs value error."""
    import torch
    gv, gi = got
    wv, wi = want
    if exact:
        if not (torch.equal(gv, wv) and torch.equal(gi, wi)):
            bad = ((gv != wv) | (gi != wi)).any(1).nonzero().flatten()
            fail(f"{name}: not bitwise equal to the plain version "
                 f"(rows {bad[:8].tolist()})")
        return 0.0
    both_inf = torch.isinf(gv) & torch.isinf(wv) & (gv == wv)
    err = torch.where(both_inf, 0.0, (gv - wv).abs()).max().item()
    if not err <= TOL:
        fail(f"{name}: max abs error {err} above {TOL}")
    mask = separated(wv)
    if not torch.equal(gi[mask], wi[mask]):
        fail(f"{name}: ids differ where the score gap exceeds {TOL}")
    return err


# -- (b) kernels against their plain versions ---------------------------------


def phase_kernels(dev) -> dict:
    import torch

    from repro_torch.kernels import ops, ref, topk

    g = torch.Generator(device=dev).manual_seed(SEED)

    def ints(*shape, lo=-2, hi=3):
        return torch.randint(lo, hi, shape, generator=g,
                             device=dev).float()

    def unit(*shape):
        x = torch.randn(*shape, generator=g, device=dev)
        return x / x.norm(dim=-1, keepdim=True)

    def k1_case(name, q, tile, offs, nvs, k, exact, state=None,
                splits=None, rows=128):
        """Two in-place launches on one state (empty unless given, then
        full).  ``splits`` given calls the C entry point at that many row
        ranges, in tiles of ``rows``, instead of the wrapper (see
        k1_at_splits)."""
        n_q, (s, c, d) = q.shape[0], tile.shape
        v, i = ops.empty_state(n_q, k, dev) if state is None else state
        rows, n_splits, span = (
            topk.fused_split_plan(n_q, s * c, topk.sm_count(dev))
            if splits is None else (rows, *topk.ranges(s * c, splits)))
        err = 0.0
        for rep in range(2):
            want = ref.fused_score_topk_ref(v, i, q, tile, offs, nvs)
            if splits is None:
                topk.fused_score_topk_(v, i, q, tile, offs, nvs)
            else:
                k1_at_splits(dev, v, i, q, tile, offs, nvs, splits, rows)
            torch.cuda.synchronize()
            err = max(err, compare(f"K1 {name} #{rep}", (v, i), want,
                                   exact))
            tile = tile.flip(0).contiguous()
        print(f"[b] K1 {name}: Q={n_q} S={s} C={c} d={d} k={k} "
              f"tile rows={rows} splits={n_splits} span={span} "
              f"{'bitwise' if exact else f'max_abs_err={err:.3g}'} ok")
        return err

    def k2_case(name, scores, cids, k, state=None, splits=None):
        """Two in-place launches on one state (empty unless given, then
        full), each bitwise against the plain version: K2 only compares
        and copies, so float inputs must agree exactly too.  ``splits``
        given calls the C entry point at that many ranges instead of the
        wrapper (see k2_at_splits)."""
        q, c = scores.shape
        v, i = ops.empty_state(q, k, dev) if state is None else state
        n_splits, span = (topk.split_plan(q, c, topk.sm_count(dev))
                          if splits is None else topk.ranges(c, splits))
        for rep in range(2):
            want = ref.topk_update_ref(v, i, scores, cids)
            if splits is None:
                topk.topk_update_(v, i, scores, cids)
            else:
                k2_at_splits(dev, v, i, scores, cids, splits)
            torch.cuda.synchronize()
            compare(f"K2 {name} #{rep}", (v, i), want, True)
            if not torch.equal(v.view(torch.int32),
                               want[0].view(torch.int32)):
                fail(f"K2 {name} #{rep}: value bits differ (signed zeros)")
            cids = cids + c
            scores = scores.flip(1).contiguous()
        print(f"[b] K2 {name}: Q={q} C={c} k={k} splits={n_splits} "
              f"span={span} bitwise ok")
        return v, i

    def steps(s, c, n_valid=None):
        offs = torch.arange(s, dtype=torch.int32, device=dev) * c + 11
        nvs = torch.tensor([c] * s if n_valid is None else n_valid,
                           dtype=torch.int32, device=dev)
        return offs, nvs

    # main-path shapes
    k1_case("main int", ints(Q, D), ints(S, C, D), *steps(S, C), K, True)
    k1_err = k1_case("main float", unit(Q, D), unit(S, C, D), *steps(S, C),
                     K, False)
    def ar(c):
        return torch.arange(c, dtype=torch.int32, device=dev)

    k2_case("main int", ints(Q, C2, lo=-4, hi=5), ar(C2), K)
    k2_case("main float", unit(Q, C2), ar(C2), K)
    k2_case("path int", ints(Q, C, lo=-4, hi=5), ar(C), K)
    k2_case("path float", unit(Q, C), ar(C), K)
    # edges: Q not a multiple of 8 with n_valid < C and a padded step;
    # k > N; duplicated rows (ties); NaN and -inf scores; k = 1 and the
    # largest k
    k1_case("ragged", ints(13, D), ints(4, C, D),
            *steps(4, C, [C, 5, 0, C - 3]), K, True)
    k1_case("k>N", ints(9, 64), ints(1, 40, 64), *steps(1, 40), K, True)
    dup = ints(3, 16, 48)
    dup[:, 8:] = dup[:, :8]
    k1_case("duplicate rows", ints(17, 48), dup, *steps(3, 16), 256, True)
    q_pos = ints(5, 32, lo=1, hi=3)
    tile = ints(2, 8, 32)
    tile[0, 3] = float("nan")
    tile[1, 5] = float("-inf")
    # 14 finite rows: k = 16 leaves two empty (-inf, -1) slots
    k1_case("nan/-inf rows", q_pos, tile, *steps(2, 8), 16, True)
    k1_case("k=1", ints(5, 8), ints(2, 8, 8), *steps(2, 8), 1, True)
    # d not a multiple of the staged slice (and, at d = 7, rows that are
    # not 16-byte aligned); Q not a multiple of the 32-query tile
    k1_case("d=100", ints(40, 100), ints(8, C, 100), *steps(8, C), K, True)
    k1_case("d=7", ints(9, 7), ints(6, C, 7), *steps(6, C), 20, True)
    k1_case("Q=33", ints(33, D), ints(S, C, D), *steps(S, C), K, True)
    # the serving shapes: a request of 32 queries, S = 8 and the
    # autotune's ceiling S = 256; at S = 8, k = 256 with ranges of 32 rows
    for ns in (8, 256):
        k1_case(f"serve S={ns} int", ints(32, D), ints(ns, C, D),
                *steps(ns, C), K, True)
        k1_case(f"serve S={ns} float", unit(32, D), unit(ns, C, D),
                *steps(ns, C), K, False)
    k1_case("k=256 > span", ints(32, D), ints(8, C, D), *steps(8, C), 256,
            True)
    # ties straddling the boundaries of 5 forced ranges: the top value on
    # 20 rows around each
    q_pos = ints(Q, D, lo=1, hi=3)
    tile = ints(S, C, D)
    flat = tile.view(S * C, D)
    span = topk.ranges(S * C, 5)[1]
    for r in range(1, 5):
        flat[r * span - 10: r * span + 10] = 3.0
    k1_case("ties across range boundaries", q_pos, tile, *steps(S, C), K,
            True, splits=5)
    # a whole range of NaN rows, one of -inf rows, and a ragged padded step
    tile = ints(S, C, D)
    flat = tile.view(S * C, D)
    flat[512:1024] = float("nan")
    flat[1024:1100] = float("-inf")
    k1_case("NaN / -inf ranges", q_pos, tile,
            *steps(S, C, [C] * 40 + [7, 0] + [C] * 22), K, True, splits=4)
    # the same in narrow tiles (16 queries by 32 rows)
    k1_case("NaN / -inf ranges, narrow", q_pos, tile,
            *steps(S, C, [C] * 40 + [7, 0] + [C] * 22), K, True, splits=9,
            rows=32)
    # an unsorted incoming state with ties against the candidates and a
    # NaN slot, through the wrapper and at odd forced range counts
    for splits, rows in ((None, 128), (7, 128), (13, 32)):
        sv = ints(Q, K, lo=-20, hi=21)
        sv[:, 3] = float("nan")
        si = (torch.randperm(Q * K, generator=g, device=dev).reshape(Q, K)
              .to(torch.int32) + 10 ** 6)
        k1_case(f"unsorted state splits={splits}", ints(Q, D), ints(S, C, D),
                *steps(S, C), K, True, state=(sv, si), splits=splits,
                rows=rows)
    k1_self_consistent(dev, unit, steps)
    sc = ints(13, 300, lo=-3, hi=4)
    sc[torch.rand(13, 300, generator=g, device=dev) < 0.2] = float("nan")
    sc[torch.rand(13, 300, generator=g, device=dev) < 0.2] = float("-inf")
    k2_case("nan/-inf", sc, ar(300), K)
    k2_case("k=256 > C", ints(7, 50), ar(50), 256)
    # the recsys retrieval_cand shape: one user, 10^6 candidates, k = 100,
    # split into ranges over the SMs (two stages)
    k2_case("retrieval_cand int", ints(1, NC, lo=-50, hi=51), ar(NC), K)
    k2_case("retrieval_cand float", unit(1, NC), ar(NC), K)
    v, i = k2_case("all equal", torch.full((1, NC), 0.5, device=dev),
                   ar(NC), K)
    if not torch.equal(i[0], ar(K)):
        fail("K2 all equal: ids are not the first k columns")
    # ties straddling range boundaries: 120 columns of the top value
    # around each of three boundaries, so the top-k is all ties
    span = topk.split_plan(1, NC, topk.sm_count(dev))[1]
    sc = ints(1, NC, lo=-50, hi=51)
    for r in (1, 2, 7):
        sc[0, r * span - 60: r * span + 60] = 100.0
    k2_case("ties across range boundaries", sc, ar(NC), K)
    # whole ranges of NaN and of -inf, and a row with only 50 finite
    # scores (the rest of the state stays (-inf, -1))
    sc = unit(2, NC)
    sc[:, :10 * span] = float("nan")
    sc[:, 10 * span: 20 * span] = float("-inf")
    sc[1, 20 * span:] = float("nan")
    sc[1, 30 * span: 30 * span + 50] = 1.0
    k2_case("NaN / -inf ranges", sc, ar(NC), K)
    # an unsorted incoming state with ties against the candidates and a
    # NaN slot, on the split path and on the one-range path
    for q, c in ((1, NC), (Q, C)):
        sv = ints(q, K, lo=-50, hi=51)
        sv[:, 3] = float("nan")
        si = (torch.randperm(q * K, generator=g, device=dev).reshape(q, K)
              .to(torch.int32) + 5 * NC)
        k2_case(f"unsorted state Q={q}", ints(q, c, lo=-50, hi=51), ar(c),
                K, state=(sv, si))
    k2_case("Q=3 split grid", ints(3, NC, lo=-50, hi=51), ar(NC), K)
    # C not a multiple of the span, rows not 16-byte aligned, and a view
    # whose data starts 4 bytes into its storage
    k2_case(f"C={NC - 1}", unit(3, NC - 1), ar(NC - 1), K)
    k2_case("offset view", unit(1, NC + 1).flatten()[1:].view(1, NC),
            ar(NC), K)
    k2_case("k=256 split", unit(1, NC), ar(NC), 256)
    # signed zeros tie (IEEE ==): the earlier entry wins, whatever its sign
    sz = torch.where(torch.rand(1, NC, generator=g, device=dev) < 0.5,
                     -0.0, 0.0)
    sz[0, ::9973] = 1.0
    k2_case("signed zeros", sz, ar(NC), K)
    # ranges shorter than k, and k > C, at a split grid (split counts the
    # wrapper's plan does not pick: its ranges are at least MIN_SPAN long)
    k2_case("k > C > span", ints(2, 200), ar(200), 256, splits=5)
    k2_case("forced splits", ints(5, 1000, lo=-3, hi=4), ar(1000), K,
            splits=7)
    # an empty slice launches nothing and answers the empty state
    ev, ei = ops.fused_score_topk(unit(4, D), unit(0, D), K)
    if not (torch.isneginf(ev).all() and (ei == -1).all()):
        fail("empty docs slice did not give the empty state")
    try:
        topk.topk_update_(*ops.empty_state(2, 257, dev), unit(2, 8),
                          torch.arange(8, dtype=torch.int32, device=dev))
        fail("k=257 was accepted")
    except ValueError:
        pass
    print("[b] empty slice and k above the maximum ok")

    # K1 at its three shapes: the (fused, kernel) evaluation path's
    # superchunk (Q = 256, S = 64), and a serving request of 32 queries at
    # S = 8 and at the autotune's ceiling S = 256
    timings = [k1_timing(dev, unit, steps, q, ns)
               for q, ns in ((Q, S), (32, 8), (32, 256))]
    head = timings[0]
    out = {"fused_score_topk": {
        "name": "fused_score_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk.cu",
        "replaces": "src/repro/kernels/topk.py:130", "launches": 0,
        "max_abs_err": k1_err, **{key: head[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "timings": timings}}

    # K2 at its three shapes: the (torch, kernel) retrieval path's chunk
    # (Q = 256, C = encode_batch_size = 32), a chunk of 4096, and the
    # recsys retrieval_cand row (Q = 1, C = 10^6); library: one
    # torch.topk over the same candidates ([state | scores], or the
    # scores alone at Q = 1, where the state starts empty)
    timings = [k2_timing(dev, unit, q, c) for q, c in ((Q, C), (Q, C2),
                                                       (1, NC))]
    head = timings[0]
    out["topk_update"] = {
        "name": "topk_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_update.cu",
        "replaces": "src/repro/kernels/topk.py:67", "launches": 0,
        "max_abs_err": 0.0, **{key: head[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "timings": timings}
    return out


def k2_at_splits(dev, vals, ids, scores, cids, splits: int) -> None:
    """K2 through its C entry point at ``splits`` column ranges (fewer
    where ranges would be empty), in place; the wrapper picks its own
    count, so this is how phase (b) reaches other split grids.  Counts
    no launch."""
    import torch

    from repro_torch.kernels import _build, topk
    (q, k), c = vals.shape, scores.shape[1]
    n_splits, span = topk.ranges(c, splits)
    ws_v, ws_p = topk.workspace(q, n_splits, k, dev)
    code = _build.load_library().repro_topk_update(
        vals.data_ptr(), ids.data_ptr(), scores.data_ptr(), cids.data_ptr(),
        q, c, k, n_splits, span, None if ws_v is None else ws_v.data_ptr(),
        None if ws_p is None else ws_p.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        fail(f"repro_topk_update at {n_splits} ranges: CUDA error {code}")


def k1_at_splits(dev, vals, ids, q, tile, offs, nvs, splits: int,
                 rows: int = 128) -> None:
    """K1 through its C entry point at ``splits`` row ranges (fewer where
    ranges would be empty) in tiles of ``rows`` rows, in place; the
    wrapper picks its own, so this is how phase (b) reaches other split
    grids and tiles.  Counts no launch."""
    import torch

    from repro_torch.kernels import _build, topk
    (n_q, k), (s, c, d) = vals.shape, tile.shape
    n_splits, span = topk.ranges(s * c, splits)
    ws_v, ws_p = topk.fused_workspace(n_q, n_splits, span, k, rows, dev)
    code = _build.load_library().repro_fused_score_topk(
        q.data_ptr(), tile.data_ptr(), offs.data_ptr(), nvs.data_ptr(), n_q,
        d, s, c, k, rows, n_splits, span, vals.data_ptr(), ids.data_ptr(),
        ws_v.data_ptr(), ws_p.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        fail(f"repro_fused_score_topk at {n_splits} ranges: CUDA error "
             f"{code}")


def k1_self_consistent(dev, unit, steps) -> None:
    """K1 on unit vectors gives the same bits at every range count, in
    either tile and at every superchunk size: each score is one fmaf
    chain over d in order, and the selection is exact.  The wrapper's
    plan, one range, an odd count, the narrow tile; then one launch over
    S = 64 chunks against eight launches over S = 8 of them (which the
    wrapper runs in narrow tiles), into the same state."""
    import torch

    from repro_torch.kernels import ops, topk
    q, tile = unit(Q, D), unit(S, C, D)
    offs, nvs = steps(S, C, [C] * 50 + [C - 9] + [C] * 13)
    runs = []
    for splits, rows in ((None, 128), (1, 128), (11, 128), (40, 32)):
        v, i = ops.empty_state(Q, K, dev)
        if splits is None:
            topk.fused_score_topk_(v, i, q, tile, offs, nvs)
        else:
            k1_at_splits(dev, v, i, q, tile, offs, nvs, splits, rows)
        runs.append((v, i))
    sv, si = ops.empty_state(Q, K, dev)
    for j in range(0, S, 8):
        topk.fused_score_topk_(sv, si, q, tile[j: j + 8].contiguous(),
                               offs[j: j + 8], nvs[j: j + 8])
    runs.append((sv, si))
    torch.cuda.synchronize()
    for (v, i), what in zip(runs[1:], ("1 range", "11 ranges",
                                       "40 ranges of narrow tiles",
                                       "8 launches of S = 8")):
        if not (torch.equal(v.view(torch.int32), runs[0][0].view(
                torch.int32)) and torch.equal(i, runs[0][1])):
            fail(f"K1 at {what} is not bitwise equal to one launch at its "
                 f"plan")
    sms = topk.sm_count(dev)
    print(f"[b] K1 float Q={Q} S={S}: bitwise equal at its plan (rows, "
          f"splits, span) = {topk.fused_split_plan(Q, S * C, sms)}, at 1 and "
          f"11 ranges, at 40 ranges of narrow tiles, and over 8 launches of "
          f"S = 8 (plan {topk.fused_split_plan(Q, 8 * C, sms)})")


def k1_timing(dev, unit, steps, q: int, s: int) -> dict:
    """K1's time at (Q, S, C, d, K) on unit vectors with an empty state
    reset before each call, beside its plain version, one
    torch.topk(q @ d.T, K) and its bound (the larger of bytes, each input
    read once and the state read and written, over the memory rate, and
    float32 operations over the float32 rate); its two kernels' device
    times are added after the last phase (PROFILED)."""
    queries, tile = unit(q, D), unit(s, C, D)
    offs, nvs = steps(s, C)
    return k1_time(dev, queries, tile, offs, nvs,
                   f"Q={q} S={s} C={C} d={D} k={K}")


def k1_time(dev, queries, tile, offs, nvs, shape: str,
            phase: str = "b") -> dict:
    """:func:`k1_timing` on given inputs: K1 folding the (S, C, d)
    ``tile`` with its per-step offsets and valid counts into an empty
    (Q, K) state, its plain version, the library call over the valid
    rows and the bound of the rows this tile holds."""
    import torch

    from repro_torch.kernels import ops, ref, topk
    from repro_torch.launch.roofline import bound_ms
    (q, d), s = queries.shape, tile.shape[0]
    docs = tile.view(s * C, d)[:int(nvs.sum())]
    v, i = ops.empty_state(q, K, dev)

    def reset():
        v.fill_(float("-inf"))
        i.fill_(-1)

    def call():
        topk.fused_score_topk_(v, i, queries, tile, offs, nvs)

    bound, bound_by = bound_ms(topk.fused_cost(q, d, s, C, K,
                                               int(nvs.sum())))
    rows, splits, span = topk.fused_split_plan(q, s * C, topk.sm_count(dev))
    t = {"shape": shape, "tile_rows": rows,
         "splits": splits, "span": span, "ms": median_ms(call, reset),
         "plain_ms": median_ms(lambda: ref.fused_score_topk_ref(
             v, i, queries, tile, offs, nvs), reset),
         "library_ms": median_ms(lambda: torch.topk(queries @ docs.T, K),
                                 reset),
         "bound_ms": bound, "bound_by": bound_by}
    PROFILED.append((t, call, reset, K1_STAGES))
    print(f"[{phase}] fused_score_topk at {t['shape']} ({splits} range(s) of "
          f"{span} rows, tiles of {rows}): kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
          f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return t


def stage_ms(call, reset, names) -> dict:
    """Mean device ms per call of each of a two-stage kernel's kernels
    over 10 calls, from torch.profiler's CUDA activity ("not measured"
    where the profiler records no device time for a kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            reset()
            call()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, "not measured")
    for e in prof.key_averages():
        for name in out:
            if name in e.key and e.device_time_total > 0:
                out[name] = e.device_time_total / e.count / 1e3
    return out


def k2_timing(dev, unit, q: int, c: int) -> dict:
    """K2's time at (Q, C, K) on unit-vector scores with an empty state
    reset before each call, beside its plain version, one torch.topk and
    its bound (bytes: the scores and chunk ids read once, the state read
    and written).  Where the wrapper splits the columns, also the time at
    half, one and two blocks per SM (the C entry point at those counts);
    the two kernels' device times are added after the last phase
    (PROFILED)."""
    import torch

    from repro_torch.kernels import ops, ref, topk
    from repro_torch.launch.roofline import bound_ms
    scores = unit(q, c)
    cids = torch.arange(c, dtype=torch.int32, device=dev)
    v, i = ops.empty_state(q, K, dev)

    def reset():
        v.fill_(float("-inf"))
        i.fill_(-1)

    if q == 1:
        def library():
            return torch.topk(scores, K)
    else:
        def library():
            return torch.topk(torch.cat([v, scores], 1), K)
    bound, bound_by = bound_ms(topk.update_cost(q, c, K))
    sms = topk.sm_count(dev)
    splits, span = topk.split_plan(q, c, sms)

    def call():
        topk.topk_update_(v, i, scores, cids)

    t = {"shape": f"Q={q} C={c} k={K}", "splits": splits, "span": span,
         "ms": median_ms(call, reset),
         "plain_ms": median_ms(lambda: ref.topk_update_ref(
             v, i, scores, cids), reset),
         "library_ms": median_ms(library, reset),
         "bound_ms": bound, "bound_by": bound_by}
    print(f"[b] topk_update at {t['shape']} ({splits} range(s) of {span} "
          f"columns): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
          f"ms, library {t['library_ms']:.4f} ms, bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    if splits > 1:
        t["ms_by_splits"] = {n: median_ms(
            lambda n=n: k2_at_splits(dev, v, i, scores, cids, n), reset)
            for n in (-(-sms // (2 * q)), -(-sms // q), -(-2 * sms // q))}
        PROFILED.append((t, call, reset, K2_STAGES))
        print(f"[b] topk_update at {t['shape']}: ms by range count "
              f"{t['ms_by_splits']}")
    return t


def bag_compare(name, got, want, kernel: str = "K4") -> None:
    """Check a K4 (or K4T) output against its plain version: NaN in the
    same places, the value bits equal everywhere else."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{kernel} {name}: {got.dtype} {tuple(got.shape)} != "
             f"{want.dtype} {tuple(want.shape)}")
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        fail(f"{kernel} {name}: NaN in other places than the plain version's")
    if not torch.equal(bits(got)[~nan_g], bits(want)[~nan_w]):
        bad = ((bits(got) != bits(want)) & ~nan_w).any(1).nonzero()
        fail(f"{kernel} {name}: not bitwise equal to the plain version (rows "
             f"{bad.flatten()[:8].tolist()})")


def bits(t):
    """A float32 or bfloat16 tensor's bits, for bitwise comparison."""
    import torch
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def phase_bag(dev) -> dict:
    """(b) for K4: the kernel against its plain version at the recsys
    path's shapes (train_batch's included) and at the edges, bitwise on
    every input, and against itself under forced plans; then its times at
    the serving path's three shapes."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import ops, ref, topk

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    deepfm, wide = get_arch("deepfm"), get_arch("wide-deep")
    sms = topk.sm_count(dev)

    def ids(b, vocab, pad=0.0):
        """Field-offset ids as the recsys path makes them, a share
        ``pad`` of them set to -1."""
        sizes = torch.tensor(vocab, dtype=torch.float64, device=dev)
        offs = torch.cumsum(sizes, 0) - sizes
        r = torch.rand(b, len(vocab), dtype=torch.float64, generator=g,
                       device=dev)
        out = (offs + (r * sizes).floor()).to(torch.int32)
        if pad:
            out[torch.rand(b, len(vocab), generator=g, device=dev)
                < pad] = -1
        return out.contiguous()

    def ints(*shape, lo=-3, hi=4):
        return torch.randint(lo, hi, shape, generator=g, device=dev).float()

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def uni(b, n_slots, pad=0.0):
        out = torch.randint(0, 1000, (b, n_slots), generator=g, device=dev,
                            dtype=torch.int32)
        if pad:
            out[torch.rand(b, n_slots, generator=g, device=dev) < pad] = -1
        return out

    def case(name, table, idx, w):
        """The wrapper against the plain version, bitwise: the kernel adds
        the slots in the plain version's order."""
        want = ref.embedding_bag_ref(table, idx, w)
        got = ops.embedding_bag(table, idx, w)
        torch.cuda.synchronize()
        bag_compare(name, got, want)
        plan = bag.bag_plan(idx.shape[0], idx.shape[1], table.shape[1],
                            table.element_size(), sms)
        print(f"[b] K4 {name}: B={idx.shape[0]} L={idx.shape[1]} "
              f"D={table.shape[1]} {str(table.dtype)[6:]} "
              f"{'weighted' if w is not None else 'unweighted'}, plan "
              f"(bags, pass) {plan}: bitwise ok")

    v = deepfm.cfg.total_vocab
    # the path's shapes: serve_p99, serve_bulk and retrieval_cand batches
    # over DeepFM's 39 fields (FM sum D = 10, linear term D = 1), and
    # Wide&Deep's 40 fields (wide term D = 1)
    for d in (10, 1):
        t_int, t_norm = ints(v, d), normal(v, d)
        for b in BAG_BATCHES:
            idx = ids(b, deepfm.cfg.vocab_sizes, pad=0.05)
            case(f"path int D={d}", t_int, idx,
                 ints(*idx.shape, lo=-2, hi=3))
            case(f"path int D={d}", t_int, idx, None)
            case(f"path float D={d}", t_norm, idx, None)
            case(f"path float weighted D={d}", t_norm, idx,
                 normal(*idx.shape))
        # the training path's own ids (smoke_inputs' train_batch)
        idx = deepfm_ids(deepfm, TRAIN_SHAPE, dev)
        case(f"{TRAIN_SHAPE} int D={d}", t_int, idx, None)
        case(f"{TRAIN_SHAPE} float D={d}", t_norm, idx, None)
        del t_int, t_norm
    t_wide = ints(wide.cfg.total_vocab, 1)
    for b in (BAG_BATCHES[0], BAG_BATCHES[-1]):
        case("path int (Wide&Deep)", t_wide, ids(b, wide.cfg.vocab_sizes),
             None)
    widx = wide.smoke_inputs(TRAIN_SHAPE, np.random.default_rng(SEED),
                             dev)["sparse_idx"]
    case(f"{TRAIN_SHAPE} int (Wide&Deep)", t_wide, widx, None)
    del t_wide
    case(f"{TRAIN_SHAPE} float (Wide&Deep)", normal(wide.cfg.total_vocab, 1),
         widx, None)
    # edges, on 1000-row tables
    small = ints(1000, 10)
    case("B=1", small, uni(1, 39), None)
    case("B*D=370, not a multiple of the block", small, uni(37, 39, 0.3),
         ints(37, 39))
    case("all slots padded", small,
         torch.full((300, 39), -1, dtype=torch.int32, device=dev), None)
    case("L=1", small, uni(1000, 1), ints(1000, 1))
    case("L=0", small, uni(5, 0), None)
    case("bf16", small.bfloat16(), uni(4099, 39, 0.1), ints(4099, 39))
    case("bf16 float", normal(1000, 10).bfloat16(), uni(4099, 39, 0.1),
         None)
    past = uni(64, 39)
    past[3, 5], past[17, 0] = 1000, 123_456_789
    case("id >= V (NaN rows)", small, past, None)
    inf0 = small.clone()
    inf0[0] = float("inf")
    rows1 = uni(64, 39).clamp(min=1)              # row 0 only as padding
    rows1[:, ::7] = -1
    case("inf in row 0 under padding", inf0, rows1, None)
    pad_idx = uni(64, 39, 0.1)
    w_inf = ints(64, 39)
    w_inf[pad_idx < 0] = float("inf")
    case("inf weight under padding", small, pad_idx, w_inf)
    # several slot passes; other piece widths (D = 7: 4 bytes, D = 32: 16,
    # bf16 D = 10: 20-byte rows in 4-byte pieces, bf16 D = 7: 2 bytes); a
    # B that is not a multiple of the plan's tile; ids and weights that
    # start 4 bytes past a 16-byte boundary; a table that starts 8 bytes
    # past one (8-byte pieces at D = 32)
    case("L=200, several passes", small, uni(700, 200, 0.1), None)
    case("L=200 float", normal(1000, 10), uni(700, 200, 0.1),
         normal(700, 200))
    for d in (7, 32):
        case(f"D={d}", normal(1000, d), uni(3001, 39, 0.1), normal(3001, 39))
    case("bf16 float D=10, 20-byte rows", normal(1000, 10).bfloat16(),
         uni(3001, 39, 0.1), normal(3001, 39))
    case("bf16 float D=7, 2-byte pieces", normal(1000, 7).bfloat16(),
         uni(3001, 39, 0.1), None)
    bags = bag.bag_plan(1000, 39, 10, 4, sms)[0]
    if 1000 % bags == 0:
        fail(f"K4: B=1000 is a multiple of the plan's tile of {bags} bags")
    case(f"B=1000, tiles of {bags}", normal(1000, 10), uni(1000, 39, 0.1),
         None)
    case("ids and weights 4 bytes past a 16-byte boundary", normal(1000, 10),
         uni(1, 129 * 39 + 1).flatten()[1:].view(129, 39),
         normal(1, 129 * 39 + 1).flatten()[1:].view(129, 39))
    case("D=32 table 8 bytes past a 16-byte boundary",
         normal(1, 1000 * 32 + 2).flatten()[2:].view(1000, 32),
         uni(513, 39, 0.1), None)
    k4_self_consistent(dev, deepfm, normal, uni)

    # times at the path's three shapes
    timings = k4_timings(dev, deepfm, normal)
    head = timings[2]                       # serve_bulk, D = 10 (FM sum)
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag.py:47",
            "launches": 0, "max_abs_err": 0.0, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "timings": timings}


def k4_at_plan(dev, out, table, idx, weights, bags: int,
               n_pass: int) -> None:
    """K4 through its C entry point in tiles of ``bags`` bags and slot
    passes of ``n_pass``, into ``out``; the wrapper picks its own plan, so
    this is how phase (b) reaches other plans.  Counts no launch."""
    import torch

    from repro_torch.kernels import _build
    b, n_slots = idx.shape
    code = _build.load_library().repro_embedding_bag(
        table.data_ptr(), int(table.dtype == torch.bfloat16),
        idx.data_ptr(), None if weights is None else weights.data_ptr(), b,
        n_slots, table.shape[0], table.shape[1], bags, n_pass,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        fail(f"repro_embedding_bag at plan ({bags}, {n_pass}): CUDA error "
             f"{code}")


def deepfm_ids(deepfm, shape: str, dev):
    """DeepFM's (B, 39) ids at a path shape: smoke_inputs' batch, or at
    retrieval_cand the candidate column beside the broadcast user, as
    recsys.retrieval_scores builds them."""
    import numpy as np
    import torch
    batch = deepfm.smoke_inputs(shape, np.random.default_rng(SEED), dev)
    if "sparse_idx" in batch:
        return batch["sparse_idx"]
    cands, user = batch["cand_idx"], batch["user_idx"]
    return torch.cat([cands[:, None],
                      user.expand(cands.shape[0], user.shape[1])], 1)


def k4_self_consistent(dev, deepfm, normal, uni) -> None:
    """K4 gives the same bits under every plan: each column adds its
    slots in order whatever the tile or the pass.  At the serve_p99,
    serve_bulk and train_batch shapes (DeepFM's ids, float tables of D =
    10 and 1; one weighted) and at one bf16 shape: tiles of one bag, an odd count and
    the largest that shared memory holds, crossed with passes of 1, 7 and
    L slots, each against the wrapper's own plan."""
    import torch

    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import ops, topk
    sms = topk.sm_count(dev)
    v = deepfm.cfg.total_vocab
    shapes = [(shape, d, None)
              for shape in ("serve_p99", "serve_bulk", TRAIN_SHAPE)
              for d in (10, 1)] + [("serve_p99", 10, "weighted"),
                                   ("bf16", 10, "weighted")]
    for shape, d, weighted in shapes:
        if shape == "bf16":
            table, idx = normal(1000, d).bfloat16(), uni(4099, 39, 0.1)
        else:
            table, idx = normal(v, d), deepfm_ids(deepfm, shape, dev)
        b, n_slots = idx.shape
        w = normal(b, n_slots) if weighted else None
        want = ops.embedding_bag(table, idx, w)
        plan = bag.bag_plan(b, n_slots, d, table.element_size(), sms)
        largest = bag._MAX_SMEM // bag.tile_smem(1, n_slots, w is not None)
        out = torch.empty_like(want)
        for bags in (1, 7, largest):
            for n_pass in (1, 7, n_slots):
                out.fill_(float("nan"))
                k4_at_plan(dev, out, table, idx, w, bags, n_pass)
                torch.cuda.synchronize()
                if not torch.equal(bits(out), bits(want)):
                    fail(f"K4 {shape} D={d} at plan ({bags}, {n_pass}) is "
                         f"not bitwise equal to its plan {plan}")
        print(f"[b] K4 {shape} B={b} L={n_slots} D={d} "
              f"{str(table.dtype)[6:]} {weighted or 'unweighted'}: bitwise "
              f"equal at its plan (bags, pass) {plan} and at tiles of 1, 7 "
              f"and {largest} bags x passes of 1, 7 and {n_slots} slots")
        del table


def k4_timings(dev, deepfm, normal) -> list:
    """K4's time at the path's shapes (serve_p99, serve_bulk,
    retrieval_cand; DeepFM's tables at init_params' scale, D = 10 and 1)
    with the plan the wrapper chose, beside its plain version, one
    F.embedding_bag and its bound (bytes: the ids, the distinct rows they
    touch and the output, over the memory rate; operations: 2 B L D over
    the float32 rate).  L2 is flushed before every launch, as a request
    finds the table rows cold."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import ops, ref, topk
    from repro_torch.launch.roofline import bound_ms
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def cold():
        flush.zero_()

    v = deepfm.cfg.total_vocab
    tables = {10: normal(v, 10).mul_(0.01), 1: normal(v, 1).mul_(0.01)}
    timings = []
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        idx = deepfm_ids(deepfm, shape, dev)
        b, n_slots = idx.shape
        lib_idx = idx.long()                 # in range: no clamp needed
        psw = torch.ones(b, n_slots, device=dev)        # w * mask
        rows = int(torch.unique(idx[idx >= 0]).numel())
        for d, table in tables.items():
            bound, bound_by = bound_ms(bag.bag_cost(b, n_slots, d, 4,
                                                    False, rows))
            plan = bag.bag_plan(b, n_slots, d, 4, topk.sm_count(dev))
            t = {"shape": f"{shape} B={b} L={n_slots} D={d}",
                 "distinct_rows": rows, "plan": list(plan),
                 "ms": median_ms(lambda: ops.embedding_bag(table, idx),
                                 cold),
                 "plain_ms": median_ms(
                     lambda: ref.embedding_bag_ref(table, idx), cold),
                 "library_ms": median_ms(lambda: F.embedding_bag(
                     lib_idx, table, per_sample_weights=psw, mode="sum"),
                     cold),
                 "bound_ms": bound, "bound_by": bound_by}
            timings.append(t)
            print(f"[b] embedding_bag at {t['shape']} ({rows} distinct "
                  f"rows, plan (bags, pass) {plan}): kernel {t['ms']:.4f} "
                  f"ms, plain {t['plain_ms']:.4f} ms, library "
                  f"(F.embedding_bag) {t['library_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
        del lib_idx, psw
    del tables, flush
    torch.cuda.empty_cache()
    return timings


# -- (b) K4T, K4's backward ---------------------------------------------------

# K4T's forced plans through the C entry point: (tile bytes, threads a
# block, grid or None for the persistent count, an entry's work in bytes
# or None for the wrapper's).  Tiny tiles of 32-entry batches (runs of 33
# cross batches), rows shared out by bytes alone; 61 blocks that each
# walk many tiles of 1000 bytes, rows shared out by entries almost alone;
# the widest block on 32 KB tiles; the wrapper's tiles in 4,224 blocks
# (four or eight times its grid at train_batch).  The share of each
# field's ids that the skewed draw sends to one hot row.
K4T_PLANS = ((64, 32, None, 1), (1000, 96, 61, 100_000),
             (32 * 1024, 1024, None, 128), (16 * 1024, 256, 4224, None))
HOT_SHARE = 0.05


def hot_ids(arch, idx, g):
    """``idx`` with a share HOT_SHARE of each field's ids set to the
    field's first row, as one hashed value (a "missing" one) takes a large
    share of a CTR field: a run of ~B * HOT_SHARE equal ids a field, where
    smoke_inputs' uniform draw gives runs of ~16 at most."""
    import torch

    from repro_torch.models import recsys
    offs = torch.as_tensor(recsys.field_offsets(arch.cfg.vocab_sizes),
                           dtype=torch.int32, device=idx.device)
    hot = torch.rand(idx.shape, generator=g, device=idx.device) < HOT_SHARE
    return torch.where(hot, offs.expand_as(idx), idx).contiguous()


def k4t_plan(dev, out, plan) -> tuple:
    """A forced K4T plan's (tile rows, threads, grid, entry work) for
    ``out``: the grid at most one block a row."""
    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import topk
    tile_bytes, threads, grid, entry_work = plan
    v, d = out.shape
    rows, threads, full = bag.backward_plan(
        v, d, out.element_size(), topk.sm_count(dev), tile_bytes=tile_bytes,
        threads=threads)
    return (rows, threads, min(v, grid or full),
            entry_work or bag.backward_entry_work(d))


def k4t_at_plan(dev, out, grad, idx, weights, plan, keys=None) -> None:
    """K4T through its C entry point at a forced ``plan`` (K4T_PLANS), into
    ``out``, filled with NaN first: the kernel must write every row.  The
    wrapper always takes its own plan, so this is how phase (b) reaches
    others.  ``keys`` are the ids' sorted (keys, order), sorted here if
    None.  Counts no launch."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as bag
    out.fill_(float("nan"))
    keys, order = bag.backward_keys(idx) if keys is None else keys
    rows, threads, grid, entry_work = k4t_plan(dev, out, plan)
    b, n_slots = idx.shape
    nan_cols = torch.empty(out.shape[1], dtype=torch.int32, device=dev)
    code = _build.load_library().repro_embedding_bag_backward(
        grad.data_ptr(), int(grad.dtype == torch.bfloat16), idx.data_ptr(),
        None if weights is None else weights.data_ptr(), keys.data_ptr(),
        order.data_ptr(), b * n_slots, n_slots, out.shape[0], out.shape[1],
        rows, threads, grid, entry_work, nan_cols.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        fail(f"repro_embedding_bag_backward at plan {plan}: CUDA error "
             f"{code}")


def phase_bag_backward(dev) -> dict:
    """(b) for K4T: the kernel against its plain version at the training
    shape and at the edges, bitwise on every input (it adds each row's
    contributions in the plain version's order: the stated tolerance on
    random floats is 0), with ``out`` filled with NaN before every launch
    (the kernel writes every row; no fill precedes it), bitwise equal to
    itself across two launches and across forced plans; then its time at
    the training shape beside the sort the wrapper runs before it."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import ref, topk

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    deepfm, wide = get_arch("deepfm"), get_arch("wide-deep")
    sms = topk.sm_count(dev)

    def ints(*shape, lo=-3, hi=4):
        return torch.randint(lo, hi, shape, generator=g, device=dev).float()

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def uni(b, n_slots, pad=0.0, rows=1000):
        out = torch.randint(0, rows, (b, n_slots), generator=g, device=dev,
                            dtype=torch.int32)
        if pad:
            out[torch.rand(b, n_slots, generator=g, device=dev) < pad] = -1
        return out

    def case(name, grad, idx, w, n_rows=1000, view=False):
        """The wrapper against the plain version, bitwise, twice, and at
        every forced plan, ``out`` NaN before each launch.  ``view``: out
        is rows 1.. of a larger tensor (a storage offset of one row),
        whose row 0 must stay untouched."""
        want = ref.embedding_bag_backward_ref(grad, idx, n_rows, w)
        d = grad.shape[1]
        whole = torch.empty((n_rows + view, d), dtype=grad.dtype,
                            device=dev)
        out = whole[1:] if view else whole
        keys = bag.backward_keys(idx)
        for rep in range(2):
            whole.fill_(float("nan"))
            bag.embedding_bag_backward_(out, grad, idx, w)
            torch.cuda.synchronize()
            bag_compare(f"{name} (launch {rep + 1})", out, want, "K4T")
        first = out.clone()
        for plan in K4T_PLANS:
            whole.fill_(float("nan"))
            k4t_at_plan(dev, out, grad, idx, w, plan, keys)
            torch.cuda.synchronize()
            if not torch.equal(bits(out), bits(first)):
                fail(f"K4T {name} at plan {plan} is not bitwise equal to "
                     f"the wrapper's")
            if view and not torch.isnan(whole[0]).all():
                fail(f"K4T {name} at plan {plan} wrote before its out")
        rows, threads, grid = bag.backward_plan(n_rows, d,
                                                grad.element_size(), sms)
        print(f"[b] K4T {name}: B={idx.shape[0]} L={idx.shape[1]} "
              f"V={n_rows} D={d} {str(grad.dtype)[6:]} "
              f"{'weighted' if w is not None else 'unweighted'}"
              f"{', out at a storage offset of one row' if view else ''}: "
              f"bitwise equal to the plain version on two launches "
              f"(plan: {rows} rows a tile, {threads} threads, {grid} "
              f"blocks) and at the forced plans {list(K4T_PLANS)}, out "
              f"NaN before each")

    # the path's shapes: DeepFM's train_batch ids over its 34.3 M rows
    # (FM sum D = 10, linear term D = 1), and Wide&Deep's (wide term)
    v = deepfm.cfg.total_vocab
    idx = deepfm_ids(deepfm, TRAIN_SHAPE, dev)
    b = idx.shape[0]
    for d in (10, 1):
        case(f"path int D={d}", ints(b, d), idx, None, v)
        case(f"path int weighted D={d}", ints(b, d), idx,
             ints(*idx.shape, lo=-2, hi=3), v)
        case(f"path float D={d}", normal(b, d), idx, None, v)
    widx = wide.smoke_inputs(TRAIN_SHAPE, np.random.default_rng(SEED),
                             dev)["sparse_idx"]
    case("path float (Wide&Deep) D=1", normal(b, 1), widx, None,
         wide.cfg.total_vocab)
    case(f"train_batch, {HOT_SHARE:.0%} of each field on one hot row, D=10",
         normal(b, 10), hot_ids(deepfm, idx, g), None, v)
    # edges, on 1000-row tables unless named: padding, ids repeated in one
    # bag (8 rows for 39 slots), all padded, L = 0, B = 0, bf16, ids >= V,
    # non-finite gradients and weights under padding, other widths, long
    # bags; V off the tile (4099 rows: 10 tiles of 408 and 19 rows), V
    # below one tile (1 and 5 rows), ids only in the first and last rows,
    # one run of 40,000 equal ids, runs of 31 / 32 / 33 (across the forced
    # 32-entry batches), and an out 20 bytes into its storage (bf16 D =
    # 10: its tiles start off the 16-byte boundary)
    case("padding", ints(4099, 10), uni(4099, 39, 0.1), ints(4099, 39))
    case("ids repeated in one bag", ints(513, 10), uni(513, 39, 0.05, 8),
         None)
    case("all slots padded", normal(300, 10),
         torch.full((300, 39), -1, dtype=torch.int32, device=dev), None)
    case("L=0", normal(5, 10), uni(5, 0), None)
    case("B=0", normal(0, 10), uni(0, 39), None)
    case("bf16", ints(4099, 10).bfloat16(), uni(4099, 39, 0.1),
         ints(4099, 39))
    case("bf16 float", normal(4099, 10).bfloat16(), uni(4099, 39, 0.1),
         None)
    past = uni(64, 39)
    past[3, 5], past[17, 0] = 1000, 123_456_789
    case("id >= V", normal(64, 10), past, None)
    pad_idx = uni(64, 39, 0.1)
    g_inf = ints(64, 10)
    g_inf[pad_idx.lt(0).any(1)] = float("inf")
    case("inf gradient under padding", g_inf, pad_idx, None)
    w_inf = ints(64, 39)
    w_inf[pad_idx < 0] = float("inf")
    case("inf weight under padding", ints(64, 10), pad_idx, w_inf)
    case("D=7", normal(3001, 7), uni(3001, 39, 0.1), normal(3001, 39))
    case("D=32", normal(3001, 32), uni(3001, 39, 0.1), None)
    case("L=200", normal(700, 10), uni(700, 200, 0.1), normal(700, 200))
    case("V=4099, off the tile", normal(2000, 10),
         uni(2000, 39, 0.1, 4099), None, 4099)
    case("V=1", ints(300, 10), uni(300, 39, 0.2, 1), ints(300, 39), 1)
    case("V=5", normal(300, 10), uni(300, 39, 0.2, 5), None, 5)
    ends = torch.where(uni(1000, 39, 0.1, 2) == 1, 99_999, uni(1000, 39, 0.1,
                                                               1))
    case("ids only in the first and last rows", normal(1000, 10), ends,
         normal(1000, 39), 100_000)
    case("one run of 40,000 equal ids", normal(1000, 10),
         torch.full((1000, 40), 7, dtype=torch.int32, device=dev), None)
    runs = torch.repeat_interleave(
        torch.tensor([10, 11, 12], device=dev),
        torch.tensor([31, 32, 33], device=dev))
    runs = runs[torch.randperm(96, generator=g, device=dev)]
    case("runs of 31 / 32 / 33", normal(96, 10),
         runs.to(torch.int32).reshape(96, 1), None, 64)
    case("bf16 D=10, out 20 bytes into its storage",
         normal(4099, 10).bfloat16(), uni(4099, 39, 0.1), None, view=True)

    timings = k4t_timings(dev, deepfm, wide, normal, g)
    head = timings[0]                        # train_batch, D = 10 (FM sum)
    return {"name": "embedding_bag_backward", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/embedding_bag_backward.cu",
            "replaces": "src/repro/models/recsys.py:240", "launches": 0,
            "max_abs_err": 0.0, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "timings": timings}


def k4t_timings(dev, deepfm, wide, normal, g) -> list:
    """K4T's time at the training shape (DeepFM's train_batch ids, D = 10
    and 1; Wide&Deep's wide term, D = 1; and DeepFM's at D = 10 with a hot
    row a field, ``hot_ids``): the wrapper's whole call (ms: its stable
    sort of the ids, then the kernel, which writes the whole (V, D)
    gradient; no fill), and apart the sort and the kernel alone; beside
    the plain version, the backward of one F.embedding_bag(mode="sum") on
    the same ids (autograd.grad of its output, the graph kept), and the
    bound (bytes: the ids, the gradient and the dense (V, D) output
    written once, over the memory rate; operations: 2 B L D over the
    float32 rate).  Then DeepFM's pair, the D = 10 and D = 1 backwards of
    one step: each sorting its own ids, and sharing one ``BagKeys`` (its
    sorts counted: one), and the D = 1 call alone on ids already
    sorted."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import ops, ref, topk
    from repro_torch.launch.roofline import bound_ms

    def nothing():
        pass

    cases = [("DeepFM", deepfm, 10, False), ("DeepFM", deepfm, 1, False),
             ("Wide&Deep", wide, 1, False),
             (f"DeepFM, {HOT_SHARE:.0%} hot,", deepfm, 10, True)]
    timings = []
    for label, arch, d, skewed in cases:
        idx = arch.smoke_inputs(TRAIN_SHAPE, np.random.default_rng(SEED),
                                dev)["sparse_idx"]
        if skewed:
            idx = hot_ids(arch, idx, g)
        b, n_slots = idx.shape
        v = arch.cfg.total_vocab
        grad = normal(b, d).mul_(1e-3)
        out = torch.empty((v, d), device=dev)
        keys, order = bag.backward_keys(idx)
        lib_table = torch.zeros((v, d), device=dev, requires_grad=True)
        lib_out = F.embedding_bag(idx.long(), lib_table, mode="sum")
        cost = bag.bag_backward_cost(b, n_slots, v, d, 4, False)
        nbytes = cost[1]
        bound, bound_by = bound_ms(cost)
        lib = _build.load_library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rows, threads, grid = bag.backward_plan(v, d, 4, topk.sm_count(dev))
        nan_cols = torch.empty(d, dtype=torch.int32, device=dev)

        def kernel_only():
            lib.repro_embedding_bag_backward(
                grad.data_ptr(), 0, idx.data_ptr(), None, keys.data_ptr(),
                order.data_ptr(), b * n_slots, n_slots, v, d, rows, threads,
                grid, bag.backward_entry_work(d), nan_cols.data_ptr(),
                out.data_ptr(), stream)

        runs = torch.unique_consecutive(keys, return_counts=True)[1]
        t = {"shape": f"{label} {TRAIN_SHAPE} B={b} L={n_slots} V={v} "
                      f"D={d}",
             "plan": [rows, threads, grid, bag.backward_entry_work(d)],
             "distinct_rows": int(runs.numel()),
             "longest_run": int(runs.max()),
             "ms": median_ms(lambda: bag.embedding_bag_backward_(
                 out, grad, idx), nothing),
             "sort_ms": median_ms(lambda: bag.backward_keys(idx), nothing),
             "kernel_ms": median_ms(kernel_only, nothing),
             "plain_ms": median_ms(lambda: ref.embedding_bag_backward_ref(
                 grad, idx, v), nothing, n=5),
             "library_ms": median_ms(lambda: torch.autograd.grad(
                 lib_out, lib_table, grad, retain_graph=True), nothing),
             "bound_ms": bound, "bound_bytes": nbytes, "bound_by": bound_by}
        timings.append(t)
        print(f"[b] embedding_bag_backward at {t['shape']} "
              f"({t['distinct_rows']} distinct rows, longest run "
              f"{t['longest_run']}; plan {rows} rows a tile, {threads} "
              f"threads, {grid} blocks): whole call {t['ms']:.4f} ms = "
              f"sort {t['sort_ms']:.4f} + kernel {t['kernel_ms']:.4f} "
              f"(each timed apart; no fill), plain {t['plain_ms']:.4f} ms, "
              f"library (F.embedding_bag backward) {t['library_ms']:.4f} "
              f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {nbytes} "
              f"bytes)")
        del out, lib_table, lib_out, keys, order, grad
        torch.cuda.empty_cache()

    # DeepFM's pair of backwards in one step: the FM sum (D = 10) and the
    # linear term (D = 1) over the same ids
    idx = deepfm.smoke_inputs(TRAIN_SHAPE, np.random.default_rng(SEED),
                              dev)["sparse_idx"]
    b, v = idx.shape[0], deepfm.cfg.total_vocab
    grads = {d: normal(b, d).mul_(1e-3) for d in (10, 1)}
    outs = {d: torch.empty((v, d), device=dev) for d in (10, 1)}
    sorts = [0]
    plain_keys = bag.backward_keys

    def counted(ids):
        sorts[0] += 1
        return plain_keys(ids)

    def pair(shared):
        keys = ops.BagKeys(idx) if shared else None
        for d in (10, 1):
            bag.embedding_bag_backward_(outs[d], grads[d], idx, keys=keys)

    bag.backward_keys = counted
    try:
        pair(True)
        if sorts[0] != 1:
            fail(f"DeepFM's pair of K4T calls with one BagKeys sorted "
                 f"{sorts[0]} times")
        pair(False)
        if sorts[0] != 3:
            fail(f"DeepFM's pair of K4T calls without a BagKeys sorted "
                 f"{sorts[0] - 1} times")
    finally:
        bag.backward_keys = plain_keys
    sorted_keys = ops.BagKeys(idx)
    sorted_keys.sorted()
    # the library's pair: the backwards of two F.embedding_bag(mode="sum")
    # over the same ids (D = 10, then D = 1), graphs kept
    lib_tables = {d: torch.zeros((v, d), device=dev, requires_grad=True)
                  for d in (10, 1)}
    lib_outs = {d: F.embedding_bag(idx.long(), lib_tables[d], mode="sum")
                for d in (10, 1)}

    def library_pair():
        for d in (10, 1):
            torch.autograd.grad(lib_outs[d], lib_tables[d], grads[d],
                                retain_graph=True)

    t = {"shape": f"DeepFM pair {TRAIN_SHAPE} B={b} V={v} D=10 then D=1",
         "pair_ms": median_ms(lambda: pair(False), nothing),
         "pair_shared_ms": median_ms(lambda: pair(True), nothing),
         "linear_shared_ms": median_ms(lambda: bag.embedding_bag_backward_(
             outs[1], grads[1], idx, keys=sorted_keys), nothing),
         "library_ms": median_ms(library_pair, nothing),
         "sorts_shared": 1}
    timings.append(t)
    print(f"[b] embedding_bag_backward, DeepFM's pair at {t['shape']}: each "
          f"sorting its ids {t['pair_ms']:.4f} ms, sharing one BagKeys "
          f"{t['pair_shared_ms']:.4f} ms (one sort, counted), the D=1 call "
          f"on ids already sorted {t['linear_shared_ms']:.4f} ms; library "
          f"(the two F.embedding_bag backwards) {t['library_ms']:.4f} ms")
    del outs, grads, sorted_keys, lib_tables, lib_outs
    torch.cuda.empty_cache()
    return timings


# -- (c) + (d) the main path --------------------------------------------------


def on_path(paths: dict, path: str, kernel: str | None, fn, want):
    """Drive one main path with every kernel's launch count set to 0 just
    before it and read just after it.  ``kernel`` (if any) must have
    launched; ``want(out)`` gives each kernel's expected launches for that
    run (from ``ShardedSearchDriver.stats`` on the retrieval paths: one K1
    launch per superchunk call, one K2 launch per scored chunk; from the
    model on the recsys paths), 0 for every kernel off the path."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    got = ops.launch_counts()
    expected = want(out)
    if got != expected or (kernel is not None and got[kernel] < 1):
        fail(f"{path}: kernel launches {got}, expected {expected}")
    paths[path] = got
    print(f"[e] {path}: launches {json.dumps(got)} (as predicted)")
    return out


def predicted(ev, score: str, heap: str) -> dict:
    """Each kernel's launches on a retrieval path, predicted from the
    evaluator's last search."""
    return predict([ev.last_search_stats], score, heap)


def predict(stats: list, score: str, heap: str) -> dict:
    """Each kernel's launches predicted from driver stats, summed over
    searches and ranks: one K1 launch per superchunk call on (fused, ·),
    one K2 launch per scored chunk on (torch, kernel), a rank's own shard
    and the orphaned shards it rescored (``retry_dispatch_rounds`` /
    ``retry_chunks``, 0 without a resilient gather) alike.  An empty
    shard (an IVF round's shard past the cluster edges, or an empty
    selection) runs no executor and launches nothing."""
    for st in stats:
        if st["executor"] != "superchunk" and st["items"]:
            fail(f"({score}, {heap}) ran {st['executor']}")
    return {"fused_score_topk": (
                sum(st["dispatch_rounds"] + st["retry_dispatch_rounds"]
                    for st in stats) if score == "fused" else 0),
            "topk_update": (sum(st["chunks"] + st["retry_chunks"]
                                for st in stats)
                            if (score, heap) == ("torch", "kernel") else 0),
            "embedding_bag": 0, "embedding_bag_backward": 0}


def path_kernel(score: str, heap: str) -> str | None:
    """The kernel a retrieval path must launch (None on (torch, torch))."""
    return ("fused_score_topk" if score == "fused" else
            "topk_update" if heap == "kernel" else None)


def check_exact(name, ids, vals, want_ids, want_vals) -> float:
    """Values within TOL of the wanted top-k, ids equal where
    separated."""
    import numpy as np
    import torch
    err = float(np.abs(vals - want_vals).max())
    sep = separated(torch.from_numpy(want_vals)).numpy()
    if err > TOL or not np.array_equal(ids[sep], want_ids[sep]):
        fail(f"{name}: max abs error {err} (tol {TOL}) or ids differ "
             f"where separated")
    return err


def check_backends(name, runs: dict) -> float:
    """(torch, kernel) == (torch, torch) bitwise (they share their
    scores); fused, which sums in another order than cuBLAS, within TOL
    of torch, ids equal where separated.  Returns the fused error."""
    import numpy as np
    a, b = runs[("torch", "kernel")], runs[("torch", "torch")]
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        fail(f"{name}: (torch, kernel) != (torch, torch) bitwise")
    f = runs[("fused", "kernel")]
    return check_exact(f"{name} fused vs torch", f[0], f[1], b[0], b[1])


def build_trove(dev) -> dict:
    """trove-base at full width with seeded random weights, its collator,
    and the synthetic dataset of phases (c), (d) and (g)."""
    import torch

    from repro_torch.configs import trove_base
    from repro_torch.core.collator import RetrievalCollator
    from repro_torch.core.config import DataArguments
    from repro_torch.data.synthetic import make_retrieval_dataset
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models.encoder import DefaultEncoder
    from repro_torch.models.retriever import BiEncoderRetriever

    cfg = trove_base.get_config()
    retriever = BiEncoderRetriever(DefaultEncoder(cfg))
    params = retriever.init_params(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    n_params = sum(p.numel() for p in params["blocks"].values()) + sum(
        p.numel() for n, p in params.items() if n != "blocks")
    collator = RetrievalCollator(DataArguments(vocab_size=cfg.vocab_size),
                                 HashTokenizer(cfg.vocab_size))
    with tempfile.TemporaryDirectory() as tmp:
        queries, corpus, qrels = make_retrieval_dataset(
            tmp, n_queries=Q, n_docs=8192, n_topics=64, seed=SEED)
    print(f"[c] {cfg.name}: {cfg.n_layers} x {cfg.d_model}, "
          f"{n_params / 1e6:.1f} M params, {cfg.dtype}; {len(queries)} "
          f"queries, {len(corpus)} docs")
    return {"retriever": retriever, "params": params, "collator": collator,
            "queries": queries, "corpus": corpus, "qrels": qrels}


def trove_evaluator(dev, trove: dict, score: str = "fused",
                    heap: str = "kernel", superchunk_size: int | None = None,
                    recovery: dict | None = None, index: dict | None = None,
                    **workers):
    """A RetrievalEvaluator of the main path's settings (k = 100, chunks
    of 32 rows, 256 queries a batch, S = 64 unless given; 0 autotunes);
    ``recovery`` sets its round_deadline_s / shard_retries /
    shard_retry_backoff_s, ``index`` its index_impl / ivf_*;
    ``workers`` are its process_index / process_count / gather / sharder
    / fault_injector."""
    from repro_torch.core.config import EvaluationArguments
    from repro_torch.core.evaluator import RetrievalEvaluator

    args = EvaluationArguments(
        topk=K, encode_batch_size=C, query_batch_size=Q,
        superchunk_size=S if superchunk_size is None else superchunk_size,
        score_impl=score, heap_impl=heap,
        metrics=("ndcg@10", "mrr@10", "recall@100"), **(recovery or {}),
        **(index or {}))
    return RetrievalEvaluator(args, trove["retriever"], trove["collator"],
                              trove["params"], device=dev, **workers)


def query_embeddings(dev, trove: dict, texts):
    """The queries as a search of all of ``texts`` encodes them (one
    batch of Q; a smaller batch may pad to another length and round
    otherwise in bf16)."""
    ev = trove_evaluator(dev, trove)
    return ev.encode_pipeline.encode(
        trove["params"], list(texts),
        trove["collator"].max_len_for(True),
        fmt=trove["retriever"].format_query, device=True, batch_size=Q)


def phase_main_path(dev, card: str, trove: dict) -> tuple[dict, dict]:
    """(c); returns each path's launch counts and the search results by
    backend pair."""
    import numpy as np

    queries, corpus, qrels = (trove["queries"], trove["corpus"],
                              trove["qrels"])
    paths: dict = {}
    runs = {}
    for score, heap in (("fused", "kernel"), ("torch", "kernel"),
                        ("torch", "torch")):
        ev = trove_evaluator(dev, trove, score, heap)
        kernel = path_kernel(score, heap)

        def want(_, score=score, heap=heap, ev=ev):
            return predicted(ev, score, heap)

        t0 = time.perf_counter()
        metrics = on_path(paths, f"evaluate ({score}, {heap})", kernel,
                          lambda: ev.evaluate(queries, corpus, qrels), want)
        t_eval = time.perf_counter() - t0
        qh, ids, vals = on_path(paths, f"search ({score}, {heap})", kernel,
                                lambda: ev.search(queries, corpus), want)
        st = ev.last_search_stats
        if st["query_device"] != str(dev) or st["chunk_devices"] != [
                str(dev)]:
            fail(f"embeddings not on {dev}: {st}")
        if ids.shape != (Q, K) or not np.isfinite(vals).all():
            fail(f"({score}, {heap}): bad result {ids.shape}")
        if not (np.diff(vals, axis=1) <= 0).all() or (ids < 0).any():
            fail(f"({score}, {heap}): results not descending / empty")
        if not all(0.0 <= m <= 1.0 for m in metrics.values()):
            fail(f"({score}, {heap}): metrics out of range {metrics}")
        runs[(score, heap)] = (ids, vals)
        print(f"[c] evaluate ({score}, {heap}): {t_eval:.3f} s, "
              f"{st['executor']} x{st['dispatch_rounds']} calls of S="
              f"{st['superchunk_size']}, metrics "
              f"{json.dumps({n: round(m, 4) for n, m in metrics.items()})}")
        if (score, heap) == ("fused", "kernel"):
            negs = on_path(
                paths, "mine_hard_negatives (fused, kernel)", kernel,
                lambda: ev.mine_hard_negatives(queries, corpus, qrels,
                                               depth=20), want)
            if not negs or any(not np.isfinite(s) for _, _, s in negs):
                fail("mine_hard_negatives returned nothing / non-finite")
            print(f"[c] mine_hard_negatives (fused, kernel): {len(negs)} "
                  f"triplets")

    err = check_backends("(c)", runs)
    print(f"[c] (torch, kernel) == (torch, torch) bitwise; fused vs torch "
          f"max abs score error {err:.3g} (tol {TOL}), ids equal where "
          f"separated by more than tol")

    return paths, runs


# -- (d) serving on the card -------------------------------------------------

# (d1) / (d2): requests of 32 queries, one at a time, then single-query
# requests from client threads; (d3): serve.main's request loop.
D_SERIAL, D_SINGLE, D_THREADS, D_RESULT_S = 8, 64, 8, 300
D3_MODES = (("--workers", "1"), ("--workers", "2"), ("--mutate",))


class RoundLog:
    """Every driver round of a serving path, recorded by wrapping
    ``ShardedSearchDriver.search`` / ``search_async`` here, in the script
    (the package records nothing): each returns once its round's scoring
    phase has set ``stats``.  A path's launches are predicted as the sum
    over its rounds (and ranks) of each round's ``dispatch_rounds``."""

    def __init__(self):
        self.stats: list = []
        self._lock = threading.Lock()

    def __enter__(self):
        from repro_torch.core.sharded_search import ShardedSearchDriver
        self._orig = (ShardedSearchDriver.search,
                      ShardedSearchDriver.search_async)
        search, search_async = self._orig

        def logged(method):
            def call(driver, *args, **kw):
                out = method(driver, *args, **kw)
                with self._lock:
                    self.stats.append(driver.stats)
                return out
            return call

        ShardedSearchDriver.search = logged(search)
        ShardedSearchDriver.search_async = logged(search_async)
        return self

    def __exit__(self, *exc):
        from repro_torch.core.sharded_search import ShardedSearchDriver
        ShardedSearchDriver.search, ShardedSearchDriver.search_async = (
            self._orig)


class ServedLog:
    """What ``serve.main`` served, recorded here by wrapping, in the
    script: ``ServeFrontend.submit`` (each request's texts and Future, in
    submission order), ``ServeFrontend.close`` (deferred until
    :meth:`close`, so the results can be held against the backend's own
    prepared corpus outside the counted path) and
    ``EmbeddingCache.cache_records`` (every id the run wrote)."""

    def __init__(self):
        self.requests: list = []
        self.frontends: list = []
        self.written: set = set()
        self._lock = threading.Lock()

    def __enter__(self):
        from repro_torch.core.embedding_cache import EmbeddingCache
        from repro_torch.core.serving import ServeFrontend
        from repro_torch.data.table import stable_id_hash_array

        self._orig = (ServeFrontend.submit, ServeFrontend.close,
                      EmbeddingCache.cache_records)
        submit, _, cache_records = self._orig

        def recorded_submit(fe, request, deadline_ms=None):
            fut = submit(fe, request, deadline_ms)
            texts = [request] if isinstance(request, str) else list(request)
            with self._lock:
                self.requests.append((texts, fut))
            return fut

        def deferred_close(fe):
            with self._lock:
                self.frontends.append(fe)

        def recorded_records(cache, ids, vectors):
            with self._lock:
                self.written.update(stable_id_hash_array(ids).tolist())
            return cache_records(cache, ids, vectors)

        ServeFrontend.submit = recorded_submit
        ServeFrontend.close = deferred_close
        EmbeddingCache.cache_records = recorded_records
        return self

    def __exit__(self, *exc):
        from repro_torch.core.embedding_cache import EmbeddingCache
        from repro_torch.core.serving import ServeFrontend
        (ServeFrontend.submit, ServeFrontend.close,
         EmbeddingCache.cache_records) = self._orig

    def close(self) -> None:
        for fe in self.frontends:
            self._orig[1](fe)


def check_served(tag: str, served: ServedLog, corpus_ids,
                 n_requests: int = D_SINGLE) -> str:
    """(d3)'s and (l3)'s results: at ``--workers 1`` and ``2`` each
    request within
    TOL of a solo W = 1 ``search_texts`` over the backend's own prepared
    corpus (rank 0's at W = 2), ids equal where separated; on the live
    set (``--mutate``) shapes (1, K), finite descending scores and every
    id one of the corpus's or written during the run."""
    import numpy as np

    from repro_torch.core.evaluator import RetrievalEvaluator
    from repro_torch.data.table import stable_id_hash_array

    if len(served.frontends) != 1 or len(served.requests) != n_requests:
        fail(f"{tag}: {len(served.frontends)} frontends, "
             f"{len(served.requests)} requests recorded")
    backend = served.frontends[0].backend
    outs = [fut.result(timeout=D_RESULT_S) for _, fut in served.requests]
    if backend.live_cache is not None:
        allowed = np.asarray(sorted(
            set(stable_id_hash_array(corpus_ids).tolist()) | served.written),
            np.int64)
        for i, (ids, vals) in enumerate(outs):
            if (ids.shape != (1, K) or vals.shape != (1, K)
                    or not np.isfinite(vals).all()
                    or (np.diff(vals, axis=1) > 0).any()
                    or not np.isin(ids, allowed).all()):
                fail(f"{tag} request {i}: ids {ids.shape} / scores "
                     f"{vals.shape}, finite {np.isfinite(vals).all()}, "
                     f"ids outside the corpus and the run's writes "
                     f"{np.setdiff1d(ids, allowed).tolist()}")
        return (f"shapes (1, {K}), scores finite and descending, every id "
                f"among the {len(allowed)} of the corpus and the run's "
                f"writes")
    if hasattr(backend, "evs"):
        rank0 = backend.evs[0]
        ev = RetrievalEvaluator(rank0.args, rank0.retriever, rank0.collator,
                                rank0.params, device=rank0.device,
                                process_index=0, process_count=1)
        prepared = backend.prepared[0]
    else:
        ev, prepared = backend.ev, backend.prepared
    err = max(check_exact(f"{tag} request {i} vs solo search_texts",
                          ids, vals, *ev.search_texts(texts, prepared))
              for i, ((texts, _), (ids, vals))
              in enumerate(zip(served.requests, outs)))
    return (f"vs solo W = 1 search_texts over the same prepared corpus "
            f"max abs error {err:.3g} (tol {TOL}), ids equal where "
            f"separated")


def serving_path(paths: dict, path: str, fn):
    """One serving path on (fused, kernel): launches counted around
    ``fn`` and predicted from the rounds it ran."""
    log = RoundLog()

    def run():
        with log:
            return fn()

    return on_path(paths, path, "fused_score_topk", run,
                   lambda _: predict(log.stats, "fused", "kernel"))


def latency_summary(ms: list, seconds: float, n_queries: int) -> str:
    import numpy as np
    return (f"p50 {np.percentile(ms, 50):.3f} ms, p99 "
            f"{np.percentile(ms, 99):.3f} ms, {n_queries / seconds:.1f} "
            f"queries/s")


def drive_frontend(paths: dict, tag: str, fe, texts, solo: dict,
                   card: str, phase: str = "d") -> list:
    """A frontend's rung warm pass, then D_SERIAL 32-query requests one
    at a time and D_SINGLE single-query requests from D_THREADS threads,
    each timed and held against its solo ``search_texts`` (scores within
    TOL, ids equal where separated); lines printed under ``phase``.
    Returns the serial results."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    rung = 1
    while True:
        fe.search(texts[:rung], timeout=D_RESULT_S)
        if rung >= fe.max_batch:
            break
        rung = min(2 * rung, fe.max_batch)
    print(f"[{phase}] {tag} rung warm pass (1 .. {fe.max_batch}): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    serial_ms = []

    def serial():
        outs = []
        for r in range(D_SERIAL):
            t0 = time.perf_counter()
            outs.append(fe.search(texts[32 * r: 32 * (r + 1)],
                                  timeout=D_RESULT_S))
            serial_ms.append((time.perf_counter() - t0) * 1e3)
        return outs

    serial_outs = serving_path(
        paths, f"{tag} {D_SERIAL} x 32-query requests (fused, kernel)",
        serial)
    err = max(check_exact(f"{tag} request {r} vs solo search_texts",
                          out[0], out[1], *solo["serial"][r])
              for r, out in enumerate(serial_outs))
    print(f"[{phase}] {tag} {D_SERIAL} requests of 32 queries one at a "
          f"time on {card}: ms {json.dumps([round(x, 3) for x in serial_ms])}, "
          f"median {statistics.median(serial_ms):.3f}; vs solo "
          f"search_texts max abs error {err:.3g} (tol {TOL}), ids equal "
          f"where separated")
    single_ms = [0.0] * D_SINGLE

    def single():
        def client(i):
            t0 = time.perf_counter()
            out = fe.submit(texts[i]).result(timeout=D_RESULT_S)
            single_ms[i] = (time.perf_counter() - t0) * 1e3
            return out

        t0 = time.perf_counter()
        with ThreadPoolExecutor(D_THREADS,
                                thread_name_prefix="serve-client") as pool:
            outs = list(pool.map(client, range(D_SINGLE)))
        return outs, time.perf_counter() - t0

    single_outs, wall = serving_path(
        paths, f"{tag} {D_SINGLE} single-query requests from {D_THREADS} "
        f"threads (fused, kernel)", single)
    err = max(check_exact(f"{tag} single request {i} vs solo search_texts",
                          out[0], out[1], *solo["single"][i])
              for i, out in enumerate(single_outs))
    print(f"[{phase}] {tag} {D_SINGLE} single-query requests from {D_THREADS} "
          f"threads on {card}: {latency_summary(single_ms, wall, D_SINGLE)}"
          f" ({wall * 1e3:.3f} ms wall); vs solo search_texts max abs "
          f"error {err:.3g} (tol {TOL}), ids equal where separated")
    print(f"[{phase}] {tag} frontend stats: {json.dumps(fe.stats)}")
    return serial_outs


def phase_serving(dev, card: str, trove: dict) -> dict:
    """(d) serving at full width on (c)'s corpus, device-resident, S = 64:
    (d1) ``ServeFrontend.from_evaluator``, (d2) ``from_cluster`` at
    W = 2, (d3) ``repro_torch.launch.serve.main`` at ``--workers 1``,
    ``--workers 2`` and ``--mutate``.  Returns each path's launches."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core import sharded_search
    from repro_torch.core.serving import ServeFrontend
    from repro_torch.data.synthetic import make_retrieval_dataset
    from repro_torch.launch import serve
    from repro_torch.launch.distributed import SimulatedCluster

    queries, corpus = trove["queries"], trove["corpus"]
    texts = list(queries.values())
    paths: dict = {}

    # (d1) one evaluator, S = 64: a round is 4 K1 calls over 8192 rows
    ev = trove_evaluator(dev, trove)
    t0 = time.perf_counter()
    fe = ServeFrontend.from_evaluator(ev, corpus)
    torch.cuda.synchronize()
    prepared = fe.backend.prepared
    print(f"[d] (d1) ServeFrontend.from_evaluator (device-resident "
          f"prepare of {len(prepared)} docs): "
          f"{time.perf_counter() - t0:.3f} s")
    try:
        corpus_embs = prepared.load_chunk(0, len(prepared))
        if corpus_embs.device != dev:
            fail(f"prepared corpus on {corpus_embs.device}, not {dev}")
        # solo search_texts of each request, outside every counted path;
        # the 32-query ones timed as the bare baseline
        solo = {"serial": [], "single": []}
        bare_ms = []
        for r in range(D_SERIAL):
            t0 = time.perf_counter()
            solo["serial"].append(ev.search_texts(
                texts[32 * r: 32 * (r + 1)], prepared))
            bare_ms.append((time.perf_counter() - t0) * 1e3)
        solo["single"] = [ev.search_texts([t], prepared)
                          for t in texts[:D_SINGLE]]
        print(f"[d] bare search_texts of the same 32-query requests on "
              f"{card}: ms {json.dumps([round(x, 3) for x in bare_ms])}, "
              f"median {statistics.median(bare_ms):.3f}")
        outs = drive_frontend(paths, "(d1)", fe, texts, solo, card)
        # the bare requests again, after the frontend's: order vs design
        bare_ms = []
        for r in range(D_SERIAL):
            t0 = time.perf_counter()
            ev.search_texts(texts[32 * r: 32 * (r + 1)], prepared)
            bare_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[d] bare search_texts again, after the frontend's requests, "
              f"on {card}: ms {json.dumps([round(x, 3) for x in bare_ms])}"
              f", median {statistics.median(bare_ms):.3f}")
    finally:
        fe.close()
    # request 0 against an exact float64 top-k over the same embeddings
    ids, vals = outs[0]
    q_emb = query_embeddings(dev, trove, texts[:32])
    exact = q_emb.double() @ corpus_embs.double().T
    wv, wpos = torch.sort(exact, dim=1, descending=True, stable=True)
    want_ids = prepared.positions_to_ids(wpos[:, :K].cpu().numpy())
    err = check_exact("(d1) request 0 vs exact float64 top-k", ids, vals,
                      want_ids, wv[:, :K].float().cpu().numpy())
    print(f"[d] (d1) request 0 vs exact float64 top-k: max abs error "
          f"{err:.3g}, ids equal where separated by more than {TOL}")

    # (d2) two simulated workers on the card, against the W = 1 solos
    cluster = SimulatedCluster(2)
    evs = cluster_evaluators(dev, trove, 2, "fused", "kernel", cluster)
    t0 = time.perf_counter()
    fe = ServeFrontend.from_cluster(evs, cluster, corpus)
    torch.cuda.synchronize()
    print(f"[d] (d2) ServeFrontend.from_cluster W=2 (each rank prepares "
          f"the corpus): {time.perf_counter() - t0:.3f} s")
    try:
        drive_frontend(paths, "(d2) W=2", fe, texts, solo, card)
    finally:
        fe.close()
    del corpus_embs, prepared, fe
    torch.cuda.empty_cache()

    # (d3) the launcher at full width over (c)'s dataset.  It autotunes
    # S per rung in its warm pass: tune those keys here first, so the
    # counted run launches only its rounds' K1 calls
    rungs = (1, 2, 4, 8, 16, 32)
    for q in rungs:
        sharded_search.autotune_superchunk_size(q, D, C, K, "fused",
                                                "kernel", dev.type)
    n_tuned = len(sharded_search._AUTOTUNE_CACHE)
    with tempfile.TemporaryDirectory() as tmp:
        _, d3_corpus, _ = make_retrieval_dataset(
            tmp, n_queries=Q, n_docs=8192, n_topics=64, seed=SEED)
        argv = ["--data-dir", tmp, "--device", dev.type, "--topk", str(K),
                "--n-requests", str(D_SINGLE), "--batch", "1",
                "--concurrency", str(D_THREADS), "--max-batch",
                str(rungs[-1])]
        for mode in D3_MODES:
            out = io.StringIO()
            served = ServedLog()

            def run(mode=mode, out=out, served=served):
                with contextlib.redirect_stdout(out), served:
                    return serve.main(argv + list(mode))

            try:
                stats = serving_path(
                    paths, f"(d3) serve.main {' '.join(mode)} (fused, "
                    f"kernel)", run)
                held = check_served(f"(d3) serve.main {' '.join(mode)}",
                                    served, list(d3_corpus))
            finally:
                served.close()
            if len(sharded_search._AUTOTUNE_CACHE) != n_tuned:
                fail(f"(d3) {mode}: the warm pass autotuned a new key")
            fs = stats["frontend"]
            lat = stats["latencies_ms"]
            if (fs["completed"] != D_SINGLE + len(rungs) or fs["failed"]
                    or fs["queries"] != D_SINGLE + sum(rungs)
                    or not all(0 < x < D_RESULT_S * 1e3 for x in lat)
                    or not np.isfinite([stats["p50_ms"], stats["p99_ms"],
                                        stats["qps"]]).all()):
                fail(f"(d3) {mode}: {json.dumps(fs)}, latencies {lat}")
            lines = out.getvalue().splitlines()
            for line in lines:
                if line.startswith(("prepared corpus", "mutation:")):
                    print(f"[d] (d3) {' '.join(mode)}: {line}")
            print(f"[d] (d3) serve.main {' '.join(mode)} ({stats['label']}"
                  f", {D_SINGLE} single-query requests from {D_THREADS} "
                  f"threads) on {card}: p50 {stats['p50_ms']:.3f} ms, p99 "
                  f"{stats['p99_ms']:.3f} ms, {stats['qps']:.1f} queries/s;"
                  f" {fs['batches']} micro-batches, largest "
                  f"{fs['max_batch_seen']}; {held}")
    return paths


# -- (g) the embedding cache on the card -------------------------------------

# The live-corpus edit (docs deleted, re-embedded, added) and the second
# cache: random unit rows written without the encoder, searched by every
# query at S = 64 (128 superchunks of S x C = 2048 rows).
LIVE_DELETE, LIVE_REEMBED, LIVE_ADD, LIVE_Q = 512, 256, 256, 32
N_BIG, BIG_BLOCK, N_EXACT = 262_144, 32_768, 8


def count_corpus_encodes(ev) -> list:
    """Record the size of every corpus (non-query) encode of ``ev``."""
    seen = []
    encode = ev._encode_texts

    def counting(texts, is_query, *args, **kw):
        if not is_query:
            seen.append(len(texts))
        return encode(texts, is_query, *args, **kw)

    ev._encode_texts = counting
    return seen


def unit_rows(rng, n: int):
    import numpy as np
    x = rng.standard_normal((n, D), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def exact_topk(q, rows_f16, hashes):
    """Exact float64 top-K of ``q @ rows.T`` on the host, over float16
    rows as the cache stores them -> (ids, values as float32)."""
    import numpy as np
    q64 = np.asarray(q, np.float64)
    scores = np.concatenate([
        q64 @ rows_f16[lo: lo + BIG_BLOCK].astype(np.float64).T
        for lo in range(0, len(rows_f16), BIG_BLOCK)], axis=1)
    pos = np.argsort(-scores, axis=1, kind="stable")[:, :K]
    return hashes[pos], np.take_along_axis(scores, pos, 1).astype(
        np.float32)


def phase_cache(dev, card: str, trove: dict, k1_ms: float) -> dict:
    """(g) the cached paths: a cold then warm evaluate / search / mine
    over an EmbeddingCache, a live corpus (deletes, re-embeds, adds,
    compaction) searched through prepare_cache_corpus against a frozen
    copy of each pinned snapshot, and the host read + upload at 262,144
    rows.  Returns each path's launch counts."""
    import numpy as np
    import torch

    from repro_torch.core.embedding_cache import EmbeddingCache
    from repro_torch.core.evaluator import PreparedCorpus
    from repro_torch.core.result_heap import to_tensor
    from repro_torch.data.table import stable_id_hash_array

    queries, corpus, qrels = (trove["queries"], trove["corpus"],
                              trove["qrels"])
    texts = list(queries.values())
    pairs = (("fused", "kernel"), ("torch", "kernel"), ("torch", "torch"))
    paths: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache = EmbeddingCache(os.path.join(tmp, "trove"), D)

        # (g1) cold: encode on the host, write the cache, score float32
        ev = trove_evaluator(dev, trove)
        seen = count_corpus_encodes(ev)
        t0 = time.perf_counter()
        on_path(paths, "cached evaluate cold (fused, kernel)",
                "fused_score_topk",
                lambda: ev.evaluate(queries, corpus, qrels, cache=cache),
                lambda _: predicted(ev, "fused", "kernel"))
        t_cold = time.perf_counter() - t0
        if sum(seen) != len(corpus) or cache.n_live != len(corpus):
            fail(f"cold pass encoded {sum(seen)} docs, cached "
                 f"{cache.n_live} of {len(corpus)}")
        print(f"[g] cold evaluate (fused, kernel) on {card}: {t_cold:.3f} "
              f"s, {sum(seen)} docs encoded on the host and cached "
              f"({cache.n_live} x {D} float16, "
              f"{cache.n_live * D * 2 / 1e6:.1f} MB), key "
              f"{cache.generation_key}")

        # (g1) warm: every backend pair reads the float16 rows
        runs, encoded = {}, 0
        for score, heap in pairs:
            ev = trove_evaluator(dev, trove, score, heap)
            seen = count_corpus_encodes(ev)
            kernel = path_kernel(score, heap)

            def want(_, score=score, heap=heap, ev=ev):
                return predicted(ev, score, heap)

            t0 = time.perf_counter()
            metrics = on_path(
                paths, f"cached evaluate warm ({score}, {heap})", kernel,
                lambda: ev.evaluate(queries, corpus, qrels, cache=cache),
                want)
            t_warm = time.perf_counter() - t0
            _, ids, vals = on_path(
                paths, f"cached search warm ({score}, {heap})", kernel,
                lambda: ev.search(queries, corpus, cache=cache), want)
            st = ev.last_search_stats
            if st["generation"] != cache.generation_key:
                fail(f"warm search pinned {st['generation']}, not "
                     f"{cache.generation_key}")
            if (score, heap) == ("fused", "kernel"):
                negs = on_path(
                    paths, "cached mine_hard_negatives warm (fused, kernel)",
                    kernel, lambda: ev.mine_hard_negatives(
                        queries, corpus, qrels, depth=20, cache=cache),
                    want)
                if not negs or not all(np.isfinite(x) for *_, x in negs):
                    fail("warm mine_hard_negatives: nothing / non-finite")
            encoded += sum(seen)
            runs[(score, heap)] = (ids, vals)
            print(f"[g] warm evaluate ({score}, {heap}) on {card}: "
                  f"{t_warm:.3f} s, {st['dispatch_rounds']} calls of S="
                  f"{st['superchunk_size']}, metrics "
                  f"{json.dumps({n: round(m, 4) for n, m in metrics.items()})}")
        if encoded:
            fail(f"warm passes encoded {encoded} corpus docs")
        print("[g] warm passes (3 evaluates, 3 searches, 1 mine) encoded 0 "
              "corpus chunks: every corpus row came from the cache")
        err = check_backends("warm", runs)
        with cache.snapshot() as snap:
            rows, hashes = snap.get_range(0, snap.n_live), snap.ids.copy()
        q_emb = query_embeddings(dev, trove, texts).cpu().numpy()
        want_ids, want_vals = exact_topk(q_emb, rows, hashes)
        ex = check_exact("warm (torch, torch) vs exact float64 top-k",
                         *runs[("torch", "torch")],
                         want_ids, want_vals)
        print(f"[g] warm (torch, kernel) == (torch, torch) bitwise; fused "
              f"vs torch max abs error {err:.3g}; (torch, torch) vs exact "
              f"float64 top-k over the snapshot's float16 rows {ex:.3g} "
              f"(tol {TOL})")

        # (g2) a live corpus: deletes, re-embeds and adds, searched
        # through prepare_cache_corpus before and after a compaction
        rng = np.random.default_rng(SEED + 1)
        doc_ids = list(corpus)
        gen, epoch = cache.generation_key
        dead = [doc_ids[i] for i in rng.choice(len(doc_ids), LIVE_DELETE,
                                               replace=False)]
        cache.delete_records(dead)
        dead_set = set(dead)
        alive = [d for d in doc_ids if d not in dead_set]
        cache.cache_records([alive[i] for i in rng.choice(
            len(alive), LIVE_REEMBED, replace=False)],
            unit_rows(rng, LIVE_REEMBED))
        cache.cache_records([f"live-{i}" for i in range(LIVE_ADD)],
                            unit_rows(rng, LIVE_ADD))
        if cache.generation_key != (gen + 3, epoch):
            fail(f"key {cache.generation_key} after three mutations of "
                 f"{(gen, epoch)}")
        dead_hashes = stable_id_hash_array(dead)
        ev = trove_evaluator(dev, trove)

        def want(_):
            return predicted(ev, "fused", "kernel")

        q_live = query_embeddings(dev, trove, texts[:LIVE_Q]).cpu().numpy()

        def live_search(tag: str, key):
            prepared = ev.prepare_cache_corpus(cache)
            try:
                if prepared.generation != key or len(prepared) != (
                        len(corpus) - LIVE_DELETE + LIVE_ADD):
                    fail(f"live corpus {tag}: key {prepared.generation}, "
                         f"{len(prepared)} docs")
                t0 = time.perf_counter()
                ids, vals = on_path(
                    paths, f"live search_texts {tag} (fused, kernel)",
                    "fused_score_topk",
                    lambda: ev.search_texts(texts[:LIVE_Q], prepared), want)
                ms = (time.perf_counter() - t0) * 1e3
                snap = prepared.snapshot
                frozen_rows = torch.from_numpy(snap.get_range(
                    0, snap.n_live).astype(np.float32)).to(dev)
                frozen = PreparedCorpus(snap.ids, snap.n_live,
                                        lambda lo, hi: frozen_rows[lo:hi])
                oids, ovals = ev.search_texts(texts[:LIVE_Q], frozen)
                want_ids, want_vals = exact_topk(
                    q_live, snap.get_range(0, snap.n_live), snap.ids)
            finally:
                prepared.close()
            if not (np.array_equal(ids, oids) and np.array_equal(vals,
                                                                 ovals)):
                fail(f"live search {tag} != its frozen snapshot's search")
            ex = check_exact(f"live search {tag} vs exact float64 top-k",
                             ids, vals, want_ids, want_vals)
            if np.isin(ids, dead_hashes).any() or (ids < 0).any():
                fail(f"live search {tag}: a deleted id / empty slot "
                     f"surfaced")
            print(f"[g] live search_texts {tag} on {card}: key {key}, "
                  f"{len(frozen)} live docs, {LIVE_Q} queries, {ms:.3f} "
                  f"ms; bitwise equal to a search over a frozen copy of "
                  f"the snapshot; vs exact float64 top-k over the "
                  f"snapshot's rows {ex:.3g} (tol {TOL}); none of the "
                  f"{LIVE_DELETE} deleted ids surfaced")

        live_search("before compaction", (gen + 3, epoch))
        stats = cache.compact()
        if cache.generation_key != (gen + 3, epoch + 1):
            fail(f"key {cache.generation_key} after compaction")
        print(f"[g] compact(): {json.dumps(stats)}")
        live_search("after compaction", (gen + 3, epoch + 1))

        # (g3) the host read + upload at scale
        big = EmbeddingCache(os.path.join(tmp, "big"), D)
        rng = np.random.default_rng(SEED + 2)
        t0 = time.perf_counter()
        for lo in range(0, N_BIG, BIG_BLOCK):
            big.cache_records(np.arange(lo, lo + BIG_BLOCK),
                              unit_rows(rng, BIG_BLOCK))
        print(f"[g] second cache: {N_BIG} random unit rows x {D} float16 "
              f"({N_BIG * D * 2 / 2**20:.0f} MiB) written in "
              f"{time.perf_counter() - t0:.3f} s")
        runs, search_ms, stats = {}, {}, {}
        for score, heap in pairs:
            ev = trove_evaluator(dev, trove, score, heap)
            prepared = ev.prepare_cache_corpus(big)
            try:
                t0 = time.perf_counter()
                runs[(score, heap)] = on_path(
                    paths, f"cache search_texts {N_BIG} rows ({score}, "
                    f"{heap})", path_kernel(score, heap),
                    lambda: ev.search_texts(texts, prepared),
                    lambda _, ev=ev, score=score, heap=heap: predicted(
                        ev, score, heap))
                search_ms[(score, heap)] = (time.perf_counter() - t0) * 1e3
            finally:
                prepared.close()
            st = stats[(score, heap)] = ev.last_search_stats
            print(f"[g] search_texts over {N_BIG} cached rows ({score}, "
                  f"{heap}) on {card}: {search_ms[(score, heap)]:.3f} ms "
                  f"for {len(texts)} queries, {st['dispatch_rounds']} "
                  f"superchunks of {st['superchunk_size'] * C} rows")
        err = check_backends("cache at scale", runs)
        with big.snapshot() as snap:
            q_emb = query_embeddings(dev, trove, texts)[:N_EXACT]
            want_ids, want_vals = exact_topk(
                q_emb.cpu().numpy(), snap.get_range(0, snap.n_live),
                snap.ids)
            ids, vals = runs[("torch", "torch")]
            ex = check_exact("at scale vs exact float64 top-k",
                             ids[:N_EXACT],
                             vals[:N_EXACT], want_ids, want_vals)
            print(f"[g] at scale: (torch, kernel) == (torch, torch) "
                  f"bitwise; fused vs torch {err:.3g}; {N_EXACT} queries "
                  f"vs exact float64 top-k {ex:.3g} (tol {TOL})")

            # one superchunk: the host read and cast, then the upload
            st = stats[("fused", "kernel")]
            rows = st["superchunk_size"] * C
            starts = [(i * 7919 % (N_BIG // rows)) * rows for i in range(30)]
            # the loader's read and cast, and apart: the float16 copy
            # alone, and the same cast by torch on the host
            host_ms = {"read": [], "copy": [], "torch": []}
            for lo in starts:
                t0 = time.perf_counter()
                block = snap.get_range(lo, lo + rows).astype(np.float32)
                t1 = time.perf_counter()
                half = np.array(snap.get_range(lo, lo + rows))
                t2 = time.perf_counter()
                torch.from_numpy(half).float()
                t3 = time.perf_counter()
                for key, dt in (("read", t1 - t0), ("copy", t2 - t1),
                                ("torch", t3 - t2)):
                    host_ms[key].append(dt * 1e3)
            read_ms, copy_ms, torch_ms = (statistics.median(host_ms[key])
                                          for key in host_ms)
            up_ms, pinned_ms = [], []
            pinned = torch.from_numpy(block).pin_memory()
            for out, fn in ((up_ms, lambda: to_tensor(block, dev,
                                                      torch.float32)),
                            (pinned_ms, lambda: pinned.to(
                                dev, non_blocking=True))):
                for rep in range(33):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    end.record()
                    torch.cuda.synchronize()
                    if rep >= 3:
                        out.append(start.elapsed_time(end))
            up_ms = statistics.median(up_ms)
            pinned_ms = statistics.median(pinned_ms)
        mb = block.nbytes / 1e6
        fused_ms = search_ms[("fused", "kernel")]
        n_super = st["dispatch_rounds"]
        share = n_super * (read_ms + up_ms) / fused_ms
        print(f"[g] host read + cast of one superchunk ({rows} x {D} "
              f"float16 -> float32, median of 30) on {card}: "
              f"{read_ms:.4f} ms; of which a float16 copy alone "
              f"{copy_ms:.4f} ms; the same cast by torch on the host "
              f"{torch_ms:.4f} ms (not on the path)")
        print(f"[g] upload of one superchunk ({rows} x {D} float32, "
              f"{mb:.2f} MB, pageable, the driver's to_tensor; device "
              f"time, median of 30 CUDA-event timings) on {card}: "
              f"{up_ms:.4f} ms, {mb / up_ms:.2f} GB/s")
        print(f"[g] the same block from pinned memory (not on the path) on "
              f"{card}: {pinned_ms:.4f} ms, {mb / pinned_ms:.2f} GB/s")
        print(f"[g] K1 at the same superchunk (Q={Q}, S={S}, phase (b)) on "
              f"{card}: {k1_ms:.4f} ms")
        print(f"[g] upload + host read share of the (fused, kernel) search "
              f"over {N_BIG} rows on {card}: {n_super} x ({read_ms:.4f} + "
              f"{up_ms:.4f}) ms of {fused_ms:.3f} ms = {share:.3f}")
    return paths


# -- (h) W > 1 workers on the card -------------------------------------------

# Worlds of (h2), rows added between two ranks' prepares in (h3), and how
# long (h4)'s parent waits for each rank process.
H_WORLDS, H_ADDED, H_JOIN_S = (1, 2, 4), 64, 120
# the backend pairs each (h4) rank process searches, in this order
H4_PAIRS = (("fused", "kernel"), ("torch", "kernel"))


def same_bits(name: str, got, want) -> None:
    """Every array of ``got`` bitwise equal to ``want``'s."""
    import numpy as np
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            fail(f"{name}: not bitwise equal")


def on_ranks(dev, ev: list, score: str, heap: str,
             chunks: str | None = None) -> None:
    """Every rank's queries on the card, and its corpus chunks where they
    should be: on the card (``chunks`` None), or on the host for a cache
    (``"cpu"``: the mmap rows go up once per superchunk)."""
    for r, e in enumerate(ev):
        check_devices(f"rank {r} ({score}, {heap})", dev,
                      e.last_search_stats, chunks)


def check_devices(name: str, dev, st: dict, chunks: str | None) -> None:
    if st["query_device"] != str(dev) or st["chunk_devices"] != [
            chunks or str(dev)]:
        fail(f"{name}: queries on {st['query_device']}, chunks on "
             f"{st['chunk_devices']}")


def cluster_evaluators(dev, trove, world: int, score: str, heap: str,
                       cluster=None) -> list:
    """W evaluators of one SimulatedCluster (one evaluator at W = 1)."""
    if world == 1:
        return [trove_evaluator(dev, trove, score, heap)]
    return [trove_evaluator(dev, trove, score, heap, process_index=r,
                            process_count=world, gather=cluster.gather,
                            sharder=cluster.sharder)
            for r in range(world)]


def run_ranks(world: int, cluster, fn) -> list:
    return [fn(0)] if world == 1 else cluster.run(fn)


def phase_workers(dev, card: str, trove: dict, w1_run) -> dict:
    """(h) W > 1 workers on the one card: (h1) an online evaluate / search
    at W = 2, (h2) a device-resident prepared corpus at W = 1, 2, 4 for
    the three backend pairs, (h3) a cache at W = 2 with a generation
    mismatch, (h4) two processes over torch.distributed.  Returns each
    path's launch counts."""
    import numpy as np
    import torch

    from repro_torch.core.embedding_cache import EmbeddingCache
    from repro_torch.core.fair_sharding import GenerationMismatch
    from repro_torch.launch.distributed import SimulatedCluster

    queries, corpus, qrels = (trove["queries"], trove["corpus"],
                              trove["qrels"])
    texts = list(queries.values())
    pairs = (("fused", "kernel"), ("torch", "kernel"), ("torch", "torch"))
    paths: dict = {}

    # (h1) the online regime at W = 2: each rank encodes its own shard
    cluster = SimulatedCluster(2)
    evs = cluster_evaluators(dev, trove, 2, "fused", "kernel", cluster)

    def want(_):
        return predict([e.last_search_stats for e in evs], "fused",
                       "kernel")

    t0 = time.perf_counter()
    metrics = on_path(paths, "(h1) evaluate W=2 (fused, kernel)",
                      "fused_score_topk", lambda: cluster.run(
                          lambda r: evs[r].evaluate(queries, corpus, qrels)),
                      want)
    t_eval = time.perf_counter() - t0
    outs = on_path(paths, "(h1) search W=2 (fused, kernel)",
                   "fused_score_topk", lambda: cluster.run(
                       lambda r: evs[r].search(queries, corpus)), want)
    on_ranks(dev, evs, "fused", "kernel")
    if metrics[0] != metrics[1]:
        fail(f"(h1) ranks' metrics differ: {metrics}")
    same_bits("(h1) rank 1 vs rank 0", outs[1], outs[0])
    items = [e.last_search_stats["items"] for e in evs]
    if sum(items) != len(corpus):
        fail(f"(h1) shards {items} do not cover {len(corpus)} docs")
    err = check_exact("(h1) W=2 vs (c) W=1 (fused, kernel)", outs[0][1],
                      outs[0][2], *w1_run)
    print(f"[h] (h1) online evaluate W=2 (fused, kernel) on {card}: "
          f"{t_eval:.3f} s, shards {items}, metrics "
          f"{json.dumps({n: round(m, 4) for n, m in metrics[0].items()})}"
          f"; ranks identical; vs (c) W=1 max abs error {err:.3g} (tol "
          f"{TOL}), ids equal where separated")

    # (h2) one device-resident prepared corpus shared by every rank
    t0 = time.perf_counter()
    prepared = trove_evaluator(dev, trove).prepare_corpus(
        corpus, device_resident=True)
    torch.cuda.synchronize()
    print(f"[h] (h2) prepare_corpus(device_resident=True): "
          f"{time.perf_counter() - t0:.3f} s")
    w1, by_world = {}, {}
    for world in H_WORLDS:
        runs, rounds = {}, {}
        for score, heap in pairs:
            cluster = SimulatedCluster(world) if world > 1 else None
            evs = cluster_evaluators(dev, trove, world, score, heap,
                                     cluster)
            stats = [[] for _ in evs]
            walls = [[] for _ in evs]

            def serve(r, evs=evs, stats=stats, walls=walls):
                ev = evs[r]
                outs = [ev.search_prepared(queries, prepared)]
                stats[r].append(ev.last_search_stats)
                for i in range(4):
                    t0 = time.perf_counter()
                    outs.append(ev.search_texts(
                        texts[32 * i: 32 * (i + 1)], prepared))
                    walls[r].append((time.perf_counter() - t0) * 1e3)
                    stats[r].append(ev.last_search_stats)
                return outs

            got = on_path(
                paths, f"(h2) W={world} search_prepared + 4 x search_texts "
                f"({score}, {heap})", path_kernel(score, heap),
                lambda: run_ranks(world, cluster, serve),
                lambda _, stats=stats, score=score, heap=heap: predict(
                    [st for rank in stats for st in rank], score, heap))
            on_ranks(dev, evs, score, heap)
            if world == 1:
                w1[(score, heap)] = got[0]
            for r, outs in enumerate(got):
                for i, (g, w) in enumerate(zip(outs, w1[(score, heap)])):
                    same_bits(f"(h2) W={world} rank {r} search {i} "
                              f"({score}, {heap}) vs W=1", g, w)
            runs[(score, heap)] = (got[0][0][1], got[0][0][2])
            rounds[(score, heap)] = (
                [[round(st["seconds"] * 1e3, 3) for st in rank]
                 for rank in stats],
                [[round(st.get("gather_seconds", 0.0) * 1e3, 3)
                  for st in rank] for rank in stats],
                [round(max(w), 3) for w in zip(*walls)])
        err = check_backends(f"(h2) W={world}", runs)
        by_world[world] = rounds
        print(f"[h] (h2) W={world}: every rank bitwise equal to W=1 for "
              f"each pair; (torch, kernel) == (torch, torch) bitwise; "
              f"fused vs torch {err:.3g} (tol {TOL})")
    for world, rounds in by_world.items():
        for (score, heap), (round_ms, gather_ms, wall) in rounds.items():
            print(f"[h] (h2) W={world} ({score}, {heap}) on {card}: round "
                  f"ms per rank [256-query search, 4 x 32-query requests] "
                  f"{json.dumps(round_ms)}; gather + merge ms per rank "
                  f"{json.dumps(gather_ms)}; request wall ms "
                  f"{json.dumps(wall)}; medians: round "
                  f"{statistics.median(sum(round_ms, [])):.3f}, gather + "
                  f"merge {statistics.median(sum(gather_ms, [])):.3f}, "
                  f"request {statistics.median(wall):.3f}")
    print("[h] (h2) W ranks share one card's SMs: these times show no "
          "scaling and none is claimed")

    # (h3) the prepared rows in a cache at W = 2, then a mismatch
    rows = prepared.load_chunk(0, len(prepared)).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        cache = EmbeddingCache(os.path.join(tmp, "h3"), D)
        cache.cache_records(list(corpus), rows)
        key = cache.generation_key
        ev1 = trove_evaluator(dev, trove)
        snap_corpus = ev1.prepare_cache_corpus(cache)
        try:
            want_w1 = ev1.search_prepared(queries, snap_corpus)
        finally:
            snap_corpus.close()

        def cached_search(evs, r, mutate=False):
            ev = evs[r]
            if mutate:
                rng = np.random.default_rng(SEED + 3)
                cache.cache_records([f"h3-add-{i}" for i in range(H_ADDED)],
                                    unit_rows(rng, H_ADDED))
            pc = ev.prepare_cache_corpus(cache)
            try:
                return ev.search_prepared(queries, pc), None
            except GenerationMismatch as e:
                pc.close()
                pc = ev.prepare_cache_corpus(cache, e.agreed)
                return ev.search_prepared(queries, pc), e
            finally:
                pc.close()

        for tag in ("same snapshot", "mismatch"):
            cluster = SimulatedCluster(2)
            evs = cluster_evaluators(dev, trove, 2, "fused", "kernel",
                                     cluster)
            acquired = threading.Event()
            acquire = cluster.sharder.acquire

            def acquire_then_signal(worker, *args, **kw):
                try:
                    return acquire(worker, *args, **kw)
                finally:
                    if worker == 0:
                        acquired.set()

            cluster.sharder.acquire = acquire_then_signal

            def worker(r, evs=evs, acquired=acquired, tag=tag):
                if r == 1 and not acquired.wait(H_JOIN_S):
                    fail("(h3) rank 0 never acquired its round")
                return cached_search(evs, r, mutate=(
                    r == 1 and tag == "mismatch"))

            got = on_path(
                paths, f"(h3) cache W=2 {tag} (fused, kernel)",
                "fused_score_topk", lambda: cluster.run(worker),
                lambda _, evs=evs: predict(
                    [e.last_search_stats for e in evs], "fused", "kernel"))
            on_ranks(dev, evs, "fused", "kernel", chunks="cpu")
            for r, (out, _) in enumerate(got):
                same_bits(f"(h3) {tag} rank {r} vs W=1", out, want_w1)
                if evs[r].last_search_stats["generation"] != key:
                    fail(f"(h3) {tag} rank {r} scored "
                         f"{evs[r].last_search_stats['generation']}, not "
                         f"{key}")
            mismatch = [e for _, e in got if e is not None]
            if tag == "mismatch" and not (
                    len(mismatch) == 1 and got[1][1] is not None
                    and mismatch[0].agreed == key
                    and mismatch[0].mine == cache.generation_key
                    and mismatch[0].round_no == 0):
                fail(f"(h3) expected one GenerationMismatch on rank 1 at "
                     f"round 0 agreeing on {key}: {mismatch}")
            if tag == "same snapshot" and mismatch:
                fail(f"(h3) unexpected mismatch {mismatch}")
            print(f"[h] (h3) cache W=2 {tag}: both ranks bitwise equal to "
                  f"W=1 over snapshot {key}"
                  + (f"; rank 1 pinned {mismatch[0].mine} after "
                     f"{H_ADDED} added rows, got GenerationMismatch at "
                     f"round 0 (not consumed), re-prepared at the agreed "
                     f"key" if mismatch else ""))

        # (h4) two processes on the card, over torch.distributed
        paths.update(phase_processes(dev, card, trove, cache, tmp))
    return paths


def wait_all(procs, timeout: float) -> None:
    """Return once every process has exited, one has failed, or
    ``timeout`` seconds have passed."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [proc.poll() for proc in procs]
        if None not in codes or any(c not in (None, 0) for c in codes):
            return
        time.sleep(0.05)


def phase_processes(dev, card: str, trove: dict, cache, tmp: str) -> dict:
    """(h4): two rank processes, each a ShardedSearchDriver with a
    ProcessAllGather over a gloo group, search one pinned cache
    snapshot for (fused, kernel) then (torch, kernel); each must equal
    the W = 1 search here bitwise."""
    import numpy as np

    from repro_torch.core.sharded_search import ShardedSearchDriver

    texts = list(trove["queries"].values())
    q_emb = query_embeddings(dev, trove, texts)
    np.save(os.path.join(tmp, "q.npy"), q_emb.cpu().numpy())
    key = cache.generation_key
    with open(os.path.join(tmp, "h4.json"), "w") as f:
        json.dump({"cache": cache.path, "key": list(key), "device": str(dev),
                   "dim": D, "k": K, "chunk": C, "superchunk": S}, f)
    want = {}
    with cache.snapshot(key) as snap:
        for score, heap in H4_PAIRS:
            want[(score, heap)] = ShardedSearchDriver(
                score_impl=score, heap_impl=heap, chunk_size=C,
                superchunk_size=S, device=dev).search(
                    q_emb, snap.n_live,
                    lambda lo, hi: snap.get_range(lo, hi).astype(np.float32),
                    K, generation=snap.key)
        n_live = snap.n_live
    logs = [os.path.join(tmp, f"h4-{r}.log") for r in range(2)]
    t0 = time.perf_counter()
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--h4-rank",
                     str(r), tmp], stdout=log, stderr=subprocess.STDOUT))
        wait_all(procs, H_JOIN_S)
        waited = time.perf_counter() - t0
        bad = []
        for r, proc in enumerate(procs):
            if proc.returncode != 0:
                with open(logs[r]) as f:
                    tail = f.read()[-3000:]
                bad.append(f"(h4) rank {r} " + (
                    f"still running after {waited:.1f} s (limit "
                    f"{H_JOIN_S} s), killed" if proc.returncode is None
                    else f"exited {proc.returncode}") + f":\n{tail}")
        if bad:
            fail("\n".join(bad))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=H_JOIN_S)
    wall = time.perf_counter() - t0
    paths: dict = {}
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"h4-{r}.json")) as f:
            info = json.load(f)
        out = np.load(os.path.join(tmp, f"h4-{r}.npz"))
        for i, (score, heap) in enumerate(H4_PAIRS):
            st, got = info["stats"][i], info["launches"][i]
            check_devices(f"(h4) rank {r} ({score}, {heap})", dev, st,
                          "cpu")
            if st["round"] != i:
                fail(f"(h4) rank {r} ({score}, {heap}): round {st['round']}")
            expected = predict([st], score, heap)
            if got != expected:
                fail(f"(h4) rank {r} ({score}, {heap}): launches {got}, "
                     f"expected {expected}")
            path = f"(h4) process rank {r} ({score}, {heap})"
            paths[path] = got
            print(f"[e] {path}: launches {json.dumps(got)} (as predicted)")
            same_bits(f"(h4) rank {r} ({score}, {heap}) vs W=1",
                      (out[f"{score}-{heap}-vals"],
                       out[f"{score}-{heap}-pos"]), want[(score, heap)])
        ranks.append(info["stats"])
    for i in range(len(H4_PAIRS)):
        cuts = [(st[i]["lo"], st[i]["hi"]) for st in ranks]
        if cuts[0][0] != 0 or cuts[0][1] != cuts[1][0] or (
                cuts[1][1] != n_live):
            fail(f"(h4) search {i}: the ranks cut {n_live} rows as {cuts}")
    print(f"[h] (h4) 2 processes over torch.distributed (gloo) on {card}, "
          f"snapshot {key}: both ranks bitwise equal to W=1 for "
          f"{[list(p) for p in H4_PAIRS]}; second search cut "
          f"{[(st[1]['lo'], st[1]['hi']) for st in ranks]} on both "
          f"replicas (the round committed through exchange_observations); "
          f"{wall:.3f} s wall with the processes' start")
    for r, st in enumerate(ranks):
        print(f"[h] (h4) rank {r} on {card}: round ms "
              f"{[round(s['seconds'] * 1e3, 3) for s in st]}, gather + "
              f"merge ms {[round(s['gather_seconds'] * 1e3, 3) for s in st]}")
    return paths



def h4_rank(rank: int, tmp: str) -> int:
    """One (h4) rank process: join the group, search the pinned snapshot
    once per pair with the counts zeroed just before and read just
    after, and write the results, stats and counts to ``tmp``."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    import torch

    from repro_torch.core.embedding_cache import EmbeddingCache
    from repro_torch.core.fair_sharding import FairSharder
    from repro_torch.core.sharded_search import (ProcessAllGather,
                                                 ShardedSearchDriver)
    from repro_torch.kernels import ops
    from repro_torch.launch.distributed import init_distributed

    with open(os.path.join(tmp, "h4.json")) as f:
        spec = json.load(f)
    if init_distributed(init_method=f"file://{tmp}/rdzv", world_size=2,
                        rank=rank) != (rank, 2):
        fail("(h4) init_distributed")
    try:
        dev = spec["device"]
        q = torch.from_numpy(np.load(os.path.join(tmp, "q.npy"))).to(dev)
        cache = EmbeddingCache(spec["cache"], spec["dim"])
        sharder, gather = FairSharder(2), ProcessAllGather()
        arrays, stats, launches = {}, [], []
        with cache.snapshot(tuple(spec["key"])) as snap:
            for score, heap in H4_PAIRS:
                driver = ShardedSearchDriver(
                    n_workers=2, worker_index=rank, sharder=sharder,
                    gather=gather, score_impl=score, heap_impl=heap,
                    chunk_size=spec["chunk"],
                    superchunk_size=spec["superchunk"], device=dev)
                ops.reset_launch_counts()
                vals, pos = driver.search(
                    q, snap.n_live,
                    lambda lo, hi: snap.get_range(lo, hi).astype(np.float32),
                    spec["k"], generation=snap.key)
                launches.append(ops.launch_counts())
                stats.append(driver.stats)
                arrays[f"{score}-{heap}-vals"] = vals
                arrays[f"{score}-{heap}-pos"] = pos
        np.savez(os.path.join(tmp, f"h4-{rank}.npz"), **arrays)
        with open(os.path.join(tmp, f"h4-{rank}.json"), "w") as f:
            json.dump({"stats": stats, "launches": launches}, f,
                      default=str)
    finally:
        torch.distributed.destroy_process_group()
    return 0


# -- (i) faults on the card ---------------------------------------------------

# Short recovery settings, so phase (i) stays brief: a round waits
# I_ROUND_DEADLINE_S for a silent worker before its shard goes to a
# survivor, a stalled worker sleeps I_STALL_S (past that deadline), a
# request deadline is I_DEADLINE_S and must resolve within I_SLACK_S of
# it.  Requests are I_Q queries of (c)'s set; (i3) runs I_ROUNDS rounds,
# and each clean cluster of (i1) I_CLEAN rounds (their median is the
# clean round a recovered one is held beside).
I_ROUND_DEADLINE_S, I_STALL_S, I_DEADLINE_S, I_SLACK_S = 0.5, 1.0, 0.5, 0.25
I_RECOVERY = {"round_deadline_s": I_ROUND_DEADLINE_S,
              "shard_retry_backoff_s": 0.01}
I_Q, I_ROUNDS, I_CLEAN = 32, 20, 3
I_PAIRS = (("fused", "kernel"), ("torch", "kernel"))
I_KINDS = ("crash", "stall", "drop")


def chaos_fault(kind: str, round_no: int = 0):
    """The fault of ``kind`` at worker 1 in ``round_no``.  A crash fires
    at chunk 0, before the first piece of the shard is scored, so the
    crashed rank has launched no kernel when it dies and each path's
    launches are the surviving ranks' (their own shards and rescores)."""
    from repro_torch.core.faults import Fault
    if kind == "drop":
        return Fault(kind="drop", worker=1, round=round_no, phase="gather")
    return Fault(kind=kind, worker=1, round=round_no, chunk=0,
                 stall_s=I_STALL_S)


class ChaosCluster:
    """A resilient ``SimulatedCluster`` of W evaluators of the main
    path's settings with the recovery settings of (i) and one shared
    injector.  ``round(fn)`` runs ``fn(rank, ev)`` on every live rank
    and returns the outputs with each rank's wall ms and the cluster's
    (``stagger(rank)`` seconds of sleep first, where given)."""

    def __init__(self, dev, trove, world: int, score: str, heap: str,
                 faults=(), index: dict | None = None, **recovery):
        from repro_torch.core.faults import FaultInjector
        from repro_torch.launch.distributed import SimulatedCluster

        self.injector = FaultInjector(list(faults))
        self.cluster = SimulatedCluster(world, resilient=True)
        self.evs = [trove_evaluator(
            dev, trove, score, heap, recovery={**I_RECOVERY, **recovery},
            index=index, process_index=r, process_count=world,
            gather=self.cluster.gather, sharder=self.cluster.sharder,
            fault_injector=self.injector) for r in range(world)]

    def round(self, fn, stagger=None):
        wall = {}

        def rank_fn(r):
            if stagger is not None:
                time.sleep(stagger(r))
            t0 = time.perf_counter()
            out = fn(r, self.evs[r])
            wall[r] = (time.perf_counter() - t0) * 1e3
            return out

        t0 = time.perf_counter()
        outs = self.cluster.run(rank_fn)
        return outs, wall, (time.perf_counter() - t0) * 1e3


def logged_path(paths: dict, path: str, score: str, heap: str, fn):
    """One (i) path: launches counted around ``fn`` and predicted from
    the driver rounds it ran (``RoundLog``: each rank's own calls and
    rescores; a rank that raised recorded nothing and launched nothing).
    Returns ``(fn's result, the rounds' stats)``."""
    log = RoundLog()

    def run():
        with log:
            return fn()

    out = on_path(paths, path, path_kernel(score, heap), run,
                  lambda _: predict(log.stats, score, heap))
    return out, log.stats


def check_recovered(tag: str, outs, want) -> None:
    """Every rank bitwise equal to the no-fault W = 1 search, with full
    coverage, no duplicate id in a row."""
    for r, out in enumerate(outs):
        same_bits(f"{tag} rank {r} vs W=1", out, want)
        if out.degraded or not (out.coverage == 1.0).all():
            fail(f"{tag} rank {r}: coverage {out.coverage}")
        no_duplicates(f"{tag} rank {r}", out[0])


def no_duplicates(tag: str, ids) -> None:
    for row in ids:
        real = row[row >= 0]
        if len(set(real.tolist())) != len(real):
            fail(f"{tag}: a row holds a duplicate id")


def phase_faults(dev, card: str, trove: dict) -> dict:
    """(i) faults on the card: (i1) the chaos matrix, (i2) partial
    results, (i3) the reference's race, (i4) serving through faults.
    Returns each path's launch counts."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.core import sharded_search
    from repro_torch.core.embedding_cache import EmbeddingCache
    from repro_torch.core.evaluator import PreparedCorpus
    from repro_torch.core.faults import Fault
    from repro_torch.core.serving import ServeFrontend
    from repro_torch.data.synthetic import make_retrieval_dataset
    from repro_torch.launch import serve

    corpus = trove["corpus"]
    texts = list(trove["queries"].values())
    batches = [texts[I_Q * i: I_Q * (i + 1)] for i in range(Q // I_Q)]
    paths: dict = {}
    t_phase = time.perf_counter()
    prepared = trove_evaluator(dev, trove).prepare_corpus(
        corpus, device_resident=True)
    n_docs = len(prepared)
    # the no-fault W = 1 search of every batch, per pair (not counted)
    w1 = {pair: [trove_evaluator(dev, trove, *pair).search_texts(
        b, prepared) for b in batches] for pair in I_PAIRS}

    def search(batch):
        return lambda r, ev: ev.search_texts(batch, prepared)

    # (i1) the chaos matrix
    for world in (2, 4):
        for score, heap in I_PAIRS:
            pair = f"({score}, {heap})"
            clean = ChaosCluster(dev, trove, world, score, heap)
            runs, stats = logged_path(
                paths, f"(i1) W={world} no fault, {I_CLEAN} rounds {pair}",
                score, heap, lambda: [clean.round(search(batches[0]))
                                      for _ in range(I_CLEAN)])
            for outs, _, _ in runs:
                check_recovered(f"(i1) W={world} no fault {pair}", outs,
                                w1[(score, heap)][0])
            # a rank that raised would be marked dead and its shard
            # rescored, the round still bitwise equal: rule both out
            if (clean.cluster.health.dead or len(stats) != world * I_CLEAN
                    or any(st["rescored"] for st in stats)):
                fail(f"(i1) W={world} no fault {pair}: dead "
                     f"{clean.cluster.health.dead}, {len(stats)} rank "
                     f"rounds, rescored {[st['rescored'] for st in stats]}")
            clean_ms = [max(wall.values()) for _, wall, _ in runs]
            clean_rank = statistics.median(clean_ms)
            print(f"[i] (i1) W={world} no fault {pair} on {card}: round ms "
                  f"{json.dumps([round(x, 3) for x in clean_ms])}, median "
                  f"{clean_rank:.3f}")
            for kind in I_KINDS:
                tag = f"(i1) W={world} {kind} {pair}"
                cc = ChaosCluster(dev, trove, world, score, heap,
                                  [chaos_fault(kind)])
                (outs, wall, cluster_ms), stats = logged_path(
                    paths, f"{tag} round 0", score, heap,
                    lambda: cc.round(search(batches[0])))
                check_recovered(tag, outs, w1[(score, heap)][0])
                if len(cc.injector.fired) != 1:
                    fail(f"{tag}: fired {cc.injector.fired}")
                if cc.cluster.health.dead != ({1} if kind == "crash"
                                              else set()):
                    fail(f"{tag}: dead {cc.cluster.health.dead}")
                rescuers = [st for st in stats if st["rescored"]]
                want_shard = [(n_docs // world, 2 * n_docs // world)]
                if ([r for st in rescuers for r in st["rescored"]]
                        != want_shard):
                    fail(f"{tag}: rescored "
                         f"{[st['rescored'] for st in rescuers]}, not "
                         f"worker 1's shard {want_shard}")
                rescue = rescuers[0]
                # the survivors' round: the ranks the fault did not hit
                resolved = max(ms for r, ms in wall.items() if r != 1)
                retry_ms = rescue["retry_seconds"] * 1e3
                launched = (rescue["retry_dispatch_rounds"]
                            if score == "fused" else rescue["retry_chunks"])
                print(f"[i] {tag} on {card}: recovered round {resolved:.3f}"
                      f" ms on the survivors (cluster {cluster_ms:.3f} ms) "
                      f"against {clean_rank:.3f} ms clean; the rescore of "
                      f"{want_shard[0]} {retry_ms:.3f} ms, "
                      f"{retry_ms / resolved:.1%} of it ({launched} "
                      f"{path_kernel(score, heap)} launches); every rank "
                      f"bitwise equal to W=1, coverage 1")
                if kind != "crash":
                    continue
                (outs, _, after_ms), stats = logged_path(
                    paths, f"{tag} round 1", score, heap,
                    lambda: cc.round(search(batches[1])))
                check_recovered(f"{tag} round 1", outs,
                                w1[(score, heap)][1])
                shards = sorted((st["lo"], st["hi"]) for st in stats)
                lo, hi = cc.cluster.sharder.bounds(n_docs)[1]
                if (len(stats) != world - 1 or any(st["rescored"]
                                                   for st in stats)
                        or shards[0][0] != 0 or shards[-1][1] != n_docs
                        or any(a[1] != b[0] for a, b in zip(shards,
                                                            shards[1:]))
                        or lo != hi):
                    fail(f"{tag} round 1: shards {shards}, dead rank "
                         f"{(lo, hi)}")
                print(f"[i] {tag} round 1: rank 1 dead with an empty "
                      f"shard, the survivors' shards {shards} cover the "
                      f"corpus; {after_ms:.3f} ms; bitwise equal to W=1")

    # (i2) partial results: the retry budget, then a request deadline
    tag = "(i2) W=2 retry budget spent (fused, kernel)"
    cc = ChaosCluster(dev, trove, 2, "fused", "kernel", [
        chaos_fault("crash"),
        Fault(kind="crash", round=0, phase="retry", chunk=0, repeat=True)],
        shard_retries=1)
    (outs, _, _), stats = logged_path(paths, tag, "fused", "kernel",
                                      lambda: cc.round(search(batches[0])))
    (st0,) = stats
    half = PreparedCorpus(prepared.hashes[:st0["hi"]], st0["hi"],
                          prepared.load_chunk)
    want = trove_evaluator(dev, trove).search_texts(batches[0], half)
    for r, out in enumerate(outs):
        if not out.degraded or not np.allclose(out.coverage, 0.5):
            fail(f"{tag} rank {r}: coverage {out.coverage}")
        same_bits(f"{tag} rank {r} vs W=1 over rank 0's rows", out, want)
    if cc.injector.fired.count(("crash", 0, 0, "retry")) != 2:
        fail(f"{tag}: fired {cc.injector.fired}")
    print(f"[i] {tag}: every rank degraded, coverage 0.5, bitwise equal to "
          f"a W=1 search over rank 0's rows [0, {st0['hi']}) alone")

    tag = "(i2) W=4 request deadline, stalled rescuer (fused, kernel)"
    cc = ChaosCluster(dev, trove, 4, "fused", "kernel", [
        chaos_fault("crash"),
        Fault(kind="stall", round=0, phase="retry", chunk=0,
              stall_s=I_STALL_S, repeat=True)])
    (outs, wall, cluster_ms), stats = logged_path(
        paths, tag, "fused", "kernel", lambda: cc.round(
            lambda r, ev: ev.search_texts(batches[0], prepared,
                                          deadline_s=I_DEADLINE_S)))
    for r, out in enumerate(outs):
        if not out.degraded or not np.allclose(out.coverage, 0.75):
            fail(f"{tag} rank {r}: coverage {out.coverage}")
        same_bits(f"{tag} rank {r} vs rank 0", out, outs[0])
    waiters = [st["gather_seconds"] for st in stats if not st["rescored"]]
    if len(waiters) != 2 or max(waiters) > I_DEADLINE_S + I_SLACK_S:
        fail(f"{tag}: the waiters resolved after {waiters} s")
    print(f"[i] {tag} on {card}: resolved partial (coverage 0.75) "
          f"{max(waiters) * 1e3:.3f} ms into the reduce against a "
          f"{I_DEADLINE_S * 1e3:.0f} ms deadline (slack "
          f"{I_SLACK_S * 1e3:.0f} ms); the survivors' rounds "
          f"{json.dumps({r: round(ms, 3) for r, ms in wall.items()})} ms, "
          f"the stalled rescuer's included")

    # (i3) the reference's race: a crash at round 0, ranks staggered
    tag = (f"(i3) {I_ROUNDS} rounds W=4 crash at round 0, staggered "
           f"(fused, kernel)")
    cc = ChaosCluster(dev, trove, 4, "fused", "kernel",
                      [chaos_fault("crash")])
    rounds_ms = []

    def rounds():
        got = []
        for i in range(I_ROUNDS):
            # rank 1 acquires at once and dies at its first chunk; the
            # others acquire 0-20 ms later, so some do after mark_dead
            outs, _, ms = cc.round(
                search(batches[i % len(batches)]),
                stagger=lambda r, i=i: 0.0 if r == 1 else (
                    (7 * r + 3 * i) % 5) * 0.005)
            rounds_ms.append(ms)
            got.append(outs)
        return got

    got, stats = logged_path(paths, tag, "fused", "kernel", rounds)
    for i, outs in enumerate(got):
        check_recovered(f"{tag} round {i}", outs,
                        w1[("fused", "kernel")][i % len(batches)])
    # only rank 1 died, and only its round-0 shard was rescored: a rank
    # failing in a later round would show here, not in the results
    rescored = [(st["round"], r) for st in stats for r in st["rescored"]]
    if (cc.cluster.health.dead != {1} or len(stats) != 3 * I_ROUNDS
            or rescored != [(0, (n_docs // 4, 2 * n_docs // 4))]):
        fail(f"{tag}: dead {cc.cluster.health.dead}, {len(stats)} rank "
             f"rounds, rescored {rescored}")
    print(f"[i] {tag} on {card}: no duplicate id, every round bitwise "
          f"equal to W=1; round ms median "
          f"{statistics.median(rounds_ms):.3f} (round 0 "
          f"{rounds_ms[0]:.3f})")

    # (i4) serving: the corpus rows in a warm cache, so each rank's
    # prepare and the launcher's read them instead of encoding
    rows = prepared.load_chunk(0, n_docs).cpu().numpy()
    rungs = (1, 2, 4, 8, 16, 32)
    for q in rungs:
        sharded_search.autotune_superchunk_size(q, D, C, K, "fused",
                                                "kernel", dev.type)
    n_tuned = len(sharded_search._AUTOTUNE_CACHE)
    with tempfile.TemporaryDirectory() as tmp:
        _, i4_corpus, _ = make_retrieval_dataset(
            tmp, n_queries=Q, n_docs=n_docs, n_topics=64, seed=SEED)
        cache = EmbeddingCache(serve.cache_dir(tmp, "trove-base", False), D)
        cache.cache_records(list(corpus), rows)
        tag = "(i4) from_cluster W=2, rank 1 crashing in round 6"
        cc = ChaosCluster(dev, trove, 2, "fused", "kernel",
                          [chaos_fault("crash", len(rungs))])
        fe = ServeFrontend.from_cluster(cc.evs, cc.cluster, corpus,
                                        [cache] * 2)
        single_texts = texts[:D_SINGLE // 2]

        def serve_requests():
            from concurrent.futures import ThreadPoolExecutor
            for q in rungs:
                fe.search(texts[:q], timeout=D_RESULT_S)
            serial = [fe.search(b, timeout=D_RESULT_S)
                      for b in batches]
            with ThreadPoolExecutor(D_THREADS) as pool:
                single = list(pool.map(
                    lambda t: fe.submit(t).result(timeout=D_RESULT_S),
                    single_texts))
            return serial, single

        try:
            (serial, single), _ = logged_path(paths, tag, "fused",
                                              "kernel", serve_requests)
        finally:
            fe.close()
        solo_ev = trove_evaluator(dev, trove)
        solo_prep = fe.backend.prepared[0]
        held = 0
        for name, outs, reqs in (("serial", serial, batches),
                                 ("single", single,
                                  [[t] for t in single_texts])):
            for i, (out, req) in enumerate(zip(outs, reqs)):
                if out.degraded:
                    continue
                check_exact(f"{tag} {name} request {i} vs solo", out[0],
                            out[1], *solo_ev.search_texts(req, solo_prep))
                held += 1
        fs = fe.stats
        if (cc.injector.fired != [("crash", 1, len(rungs), "load")]
                or fs["failed"] or fs["completed"] != len(rungs)
                + len(batches) + len(single_texts)):
            fail(f"{tag}: fired {cc.injector.fired}, {json.dumps(fs)}")
        print(f"[i] {tag}: {fs['completed']} requests resolved, "
              f"{fs['degraded']} degraded, {held} held against their solo "
              f"W=1 search_texts (scores within {TOL}, ids equal where "
              f"separated); rank 1 dead: {cc.cluster.health.dead}")

        argv = ["--data-dir", tmp, "--device", dev.type, "--topk", str(K),
                "--n-requests", str(D_SINGLE), "--batch", "1",
                "--concurrency", str(D_THREADS), "--max-batch",
                str(rungs[-1]), "--workers", "2", "--resilient",
                "--round-deadline-s", str(I_ROUND_DEADLINE_S)]
        for kind in I_KINDS:
            out = io.StringIO()
            served = ServedLog()

            def run(kind=kind, out=out, served=served):
                with contextlib.redirect_stdout(out), served:
                    return serve.main(argv + ["--chaos", kind])

            tag = f"(i4) serve.main --workers 2 --resilient --chaos {kind}"
            try:
                stats, _ = logged_path(paths, f"{tag} (fused, kernel)",
                                       "fused", "kernel", run)
                held = check_served(tag, served, list(i4_corpus))
            finally:
                served.close()
            if len(sharded_search._AUTOTUNE_CACHE) != n_tuned:
                fail(f"{tag}: the warm pass autotuned a new key")
            fs = stats["frontend"]
            chaos = [ln for ln in out.getvalue().splitlines()
                     if ln.startswith("chaos:")]
            if (fs["completed"] != D_SINGLE + len(rungs) or fs["failed"]
                    or fs["degraded"] or len(chaos) != 1
                    or "1 fired" not in chaos[0]):
                fail(f"{tag}: {json.dumps(fs)}, {chaos}")
            print(f"[i] {tag} on {card}: {chaos[0]}; p50 "
                  f"{stats['p50_ms']:.3f} ms, p99 {stats['p99_ms']:.3f} "
                  f"ms, {stats['qps']:.1f} queries/s; {held}")
    del prepared, rows
    torch.cuda.empty_cache()
    print(f"[i] phase (i): {time.perf_counter() - t_phase:.1f} s")
    return paths


# -- (j) data management on the card -----------------------------------------

# (j1)-(j3): two datasets of J_QUERIES queries and J_DOCS docs each, written
# by the launcher's make_synthetic_suite (seeds 100 and 101, ids "d0-" and
# "d1-"); their union is 256 x 2048, a quarter of (c)'s corpus (4096 docs
# each until the decode phase (q) needed the room; PERF.md §4).  (j4): the
# launcher at
# J4_QUERIES x J4_DOCS per dataset.  (j5): benchmarks/bench_memory.py's
# sizes: J5_DOCS docs of J5_DOC_LEN words (J5_QUERIES queries), and two
# parts of J5_PART_DOCS docs and J5_PART_QUERIES queries.
J_QUERIES, J_DOCS, J_TOPICS = 128, 1024, 64
J_PAIRS = (("fused", "kernel"), ("torch", "kernel"))
J4_QUERIES, J4_DOCS = 64, 1024
J5_DOCS, J5_QUERIES, J5_DOC_LEN = 150_000, 8_000, 80
J5_PART_DOCS, J5_PART_QUERIES, J5_TOPICS = 75_000, 4_000, 512
# the reference's container figures (results/bench_memory.json)
J5_REF = {"table1": (111.35, 11.41), "concat_view": (103.81, 3.33)}


def record_searches(ev, seen: list | None = None) -> list:
    """Wrap ``ev.search``; returns the list of ``(result, corpus rows
    encoded during it)`` it records, one per search (``seen`` is a
    ``count_corpus_encodes`` list, else the count is 0)."""
    log = []
    search = ev.search

    def recording(*args, **kw):
        before = sum(seen) if seen is not None else 0
        out = search(*args, **kw)
        log.append((out, (sum(seen) if seen is not None else 0) - before))
        return out

    ev.search = recording
    return log


def eager_union(dirs: list) -> dict:
    """The datasets' files loaded eagerly into merged ``{id: text}``
    dicts and a ``{qid: {did: grade}}`` qrels dict (raw ids)."""
    union = {"queries": {}, "corpus": {}, "qrels": {}}
    for d in dirs:
        for name in ("queries", "corpus"):
            with open(os.path.join(d, f"{name}.jsonl")) as f:
                for line in f:
                    rec = json.loads(line)
                    union[name][rec["_id"]] = rec["text"]
        with open(os.path.join(d, "qrels", "train.tsv")) as f:
            for line in f:
                q, doc, s = line.rstrip("\n").split("\t")
                union["qrels"].setdefault(q, {})[doc] = float(s)
    return union


def union_metrics(ev, out, qrels: dict) -> dict:
    """``ev``'s metrics of one search result against raw-id qrels, as
    ``evaluate`` computes them."""
    from repro_torch.core.metrics import compute_metrics
    from repro_torch.data.table import stable_id_hash
    q_hashes, run_ids, _ = out
    qrels_h = {stable_id_hash(q): {stable_id_hash(d): g
                                   for d, g in docs.items()}
               for q, docs in qrels.items()}
    return compute_metrics(ev.args.metrics, run_ids, q_hashes, qrels_h)


def rounded(metrics: dict) -> str:
    return json.dumps({n: round(m, 4) for n, m in metrics.items()})


def suite_paths(dev, card: str, trove: dict, tmp: str) -> dict:
    """(j1)-(j4) in the directory ``tmp``; returns each path's launch
    counts."""
    import contextlib
    import io

    import torch

    from repro_torch.core import sharded_search
    from repro_torch.core.embedding_cache import EmbeddingCache
    from repro_torch.data.views import TableView
    from repro_torch.launch import evalsuite, serve
    from repro_torch.launch.distributed import SimulatedCluster

    paths: dict = {}
    t0 = time.perf_counter()
    dirs = evalsuite.make_synthetic_suite(
        os.path.join(tmp, "suite"), 2, n_queries=J_QUERIES,
        n_docs=J_DOCS, n_topics=J_TOPICS)
    scenarios = evalsuite.build_scenarios(dirs,
                                          os.path.join(tmp, "tables"))
    t_load = time.perf_counter() - t0
    for name, sc in scenarios.items():
        if not (isinstance(sc["queries"], TableView)
                and isinstance(sc["corpus"], TableView)):
            fail(f"(j) {name}: build_scenarios gave no TableViews")
    union = eager_union(dirs)
    n_q, n_d = len(union["queries"]), len(union["corpus"])
    if (n_q, n_d) != (2 * J_QUERIES, 2 * J_DOCS):
        fail(f"(j) the union is {n_q} x {n_d}")
    print(f"[j] suite: {len(scenarios)} datasets of {J_QUERIES} "
          f"queries x {J_DOCS} docs written and loaded through "
          f"MaterializedQRel (TableViews, hash-keyed qrels) in "
          f"{t_load:.3f} s; union {n_q} x {n_d}")

    # (j1) the suite online, on two backend pairs
    combined = {}
    for score, heap in J_PAIRS:
        ev = trove_evaluator(dev, trove, score, heap)
        kernel = path_kernel(score, heap)
        log = record_searches(ev)
        t0 = time.perf_counter()
        results, _ = logged_path(
            paths, f"(j1) evaluate_suite ({score}, {heap})", score,
            heap, lambda: ev.evaluate_suite(scenarios))
        t_suite = time.perf_counter() - t0
        if set(results) != {"d0", "d1", "combined"} or len(log) != 3:
            fail(f"(j1) ({score}, {heap}): tables {sorted(results)}, "
                 f"{len(log)} searches")
        st = ev.last_search_stats
        if st["query_device"] != str(dev) or st["chunk_devices"] != [
                str(dev)]:
            fail(f"(j1) ({score}, {heap}): not on {dev}: {st}")
        for name, sc in scenarios.items():
            solo = on_path(
                paths, f"(j1) solo evaluate {name} ({score}, {heap})",
                kernel, lambda sc=sc: ev.evaluate(
                    sc["queries"], sc["corpus"], sc["qrels"]),
                lambda _, ev=ev: predicted(ev, score, heap))
            if solo != results[name]:
                fail(f"(j1) ({score}, {heap}) {name}: suite row "
                     f"{results[name]} != solo {solo}")
        suite_out = log[2][0]
        want = on_path(
            paths, f"(j1) search dict union ({score}, {heap})", kernel,
            lambda: ev.search(union["queries"], union["corpus"]),
            lambda _, ev=ev: predicted(ev, score, heap))
        same_bits(f"(j1) ({score}, {heap}) combined vs dict union",
                  suite_out, want)
        if union_metrics(ev, want, union["qrels"]) != \
                results["combined"]:
            fail(f"(j1) ({score}, {heap}): combined row != the dict "
                 f"union's metrics")
        combined[(score, heap)] = suite_out
        print(f"[j] (j1) evaluate_suite ({score}, {heap}) online on "
              f"{card}: {t_suite:.3f} s for 3 passes ({2 * J_DOCS + n_d}"
              f" docs encoded); combined {rounded(results['combined'])}"
              f"; rows equal solo evaluates; combined rankings bitwise "
              f"equal to the dict union's")
    (_, fi, fv), (_, ti, tv) = (combined[("fused", "kernel")],
                                combined[("torch", "kernel")])
    err = check_exact("(j1) combined fused vs torch", fi, fv, ti, tv)
    print(f"[j] (j1) combined (fused, kernel) vs (torch, kernel): max "
          f"abs score error {err:.3g} (tol {TOL}), ids equal where "
          f"separated")

    # (j2) one cache shared by every pass: the per-dataset passes are
    # cold and fill it, the combined pass reads it and encodes nothing
    cache = EmbeddingCache(os.path.join(tmp, "j2"), D)
    ev = trove_evaluator(dev, trove, "fused", "kernel")
    seen = count_corpus_encodes(ev)
    log = record_searches(ev, seen)
    t0 = time.perf_counter()
    results, _ = logged_path(
        paths, "(j2) evaluate_suite cache (fused, kernel)", "fused",
        "kernel", lambda: ev.evaluate_suite(scenarios, cache=cache))
    t_suite = time.perf_counter() - t0
    encoded = [n for _, n in log]
    if encoded != [J_DOCS, J_DOCS, 0] or cache.n_live != n_d:
        fail(f"(j2) corpus rows encoded per pass {encoded}, cache "
             f"{cache.n_live} rows")
    want = on_path(
        paths, "(j2) search dict union cache (fused, kernel)",
        "fused_score_topk", lambda: ev.search(
            union["queries"], union["corpus"], cache=cache),
        lambda _: predicted(ev, "fused", "kernel"))
    same_bits("(j2) warm combined vs dict union", log[2][0], want)
    if sum(seen) != 2 * J_DOCS:
        fail(f"(j2) the warm dict-union search encoded "
             f"{sum(seen) - 2 * J_DOCS} rows")
    print(f"[j] (j2) evaluate_suite with one cache (fused, kernel) on "
          f"{card}: {t_suite:.3f} s; corpus rows encoded per pass "
          f"{encoded} (d0, d1 cold; combined warm); combined "
          f"{rounded(results['combined'])}, rankings bitwise equal to "
          f"the warm dict union's")

    # (j3) W = 2 over the warm cache: every rank's tables and combined
    # rankings equal W = 1's over the same rows; rank 0 alone writes
    w1 = trove_evaluator(dev, trove, "fused", "kernel")
    w1_log = record_searches(w1)
    w1_tables, _ = logged_path(
        paths, "(j3) evaluate_suite W=1 cache (fused, kernel)", "fused",
        "kernel", lambda: w1.evaluate_suite(scenarios, cache=cache))
    cluster = SimulatedCluster(2)
    evs = cluster_evaluators(dev, trove, 2, "fused", "kernel", cluster)
    logs = [record_searches(e) for e in evs]
    out_dirs = [os.path.join(tmp, f"j3-rank{r}") for r in range(2)]
    t0 = time.perf_counter()
    outs, _ = logged_path(
        paths, "(j3) evaluate_suite W=2 cache (fused, kernel)", "fused",
        "kernel", lambda: cluster.run(lambda r: evs[r].evaluate_suite(
            scenarios, cache=cache, out_dir=out_dirs[r],
            suite_name="j3")))
    t_w2 = time.perf_counter() - t0
    for r in range(2):
        if outs[r] != w1_tables:
            fail(f"(j3) rank {r}'s tables {outs[r]} != W=1's "
                 f"{w1_tables}")
        same_bits(f"(j3) rank {r} combined vs W=1", logs[r][2][0],
                  w1_log[2][0])
    on_ranks(dev, evs, "fused", "kernel", "cpu")
    if os.path.exists(out_dirs[1]):
        fail("(j3) rank 1 wrote the suite tables")
    with open(os.path.join(out_dirs[0], "j3.json")) as f:
        written = json.load(f)
    if written["results"] != w1_tables:
        fail(f"(j3) rank 0 wrote {written['results']}")
    print(f"[j] (j3) evaluate_suite W=2 over the cache (fused, kernel) "
          f"on {card}: {t_w2:.3f} s; both ranks' tables equal W=1's, "
          f"combined rankings bitwise equal; rank 0 alone wrote "
          f"j3.json / j3.md")
    del cache

    # (j4) the launcher at full width, --workers 1 then 2 over one
    # data root (the second run finds the first's cache warm).  The
    # suite autotunes S per query count: tune those keys here first,
    # so the counted runs launch only their rounds' K1 calls
    # (the launcher's device is "cuda", the check's "cuda:0": two keys)
    for q in (J4_QUERIES, 2 * J4_QUERIES):
        for device in (dev.type, dev):
            sharded_search.autotune_superchunk_size(
                q, D, C, K, "fused", "kernel", device)
    n_tuned = len(sharded_search._AUTOTUNE_CACHE)
    root = os.path.join(tmp, "j4")
    argv = ["--data-root", root, "--device", dev.type, "--topk", str(K),
            "--n-queries", str(J4_QUERIES), "--n-docs", str(J4_DOCS),
            "--suite-name", "j4"]
    check = trove_evaluator(dev, trove, "fused", "kernel",
                            superchunk_size=0)
    for workers in (1, 2):
        out = io.StringIO()
        out_dir = os.path.join(root, f"out-w{workers}")

        def run(workers=workers, out=out, out_dir=out_dir):
            with contextlib.redirect_stdout(out):
                return evalsuite.main(argv + [
                    "--workers", str(workers), "--out-dir", out_dir])

        t0 = time.perf_counter()
        got = serving_path(
            paths, f"(j4) evalsuite.main --workers {workers} (fused, "
            f"kernel)", run)
        wall = time.perf_counter() - t0
        if len(sharded_search._AUTOTUNE_CACHE) != n_tuned:
            fail(f"(j4) --workers {workers}: autotuned a new key")
        j4_dirs = [os.path.join(root, f"d{i}") for i in range(2)]
        j4_scen = evalsuite.build_scenarios(
            j4_dirs, os.path.join(tmp, f"j4-tables-w{workers}"))
        # W = 1 began with an empty cache: check it with a fresh one;
        # W = 2 read the cache W = 1 left: check it over that cache
        check_cache = EmbeddingCache(
            os.path.join(tmp, "j4-check") if workers == 1
            else serve.cache_dir(root, "trove-base", False), D)
        want, _ = logged_path(
            paths, f"(j4) in-process evaluate_suite for --workers "
            f"{workers} (fused, kernel)", "fused", "kernel",
            lambda: check.evaluate_suite(j4_scen, cache=check_cache))
        if got != want:
            fail(f"(j4) --workers {workers}: launcher tables {got} != "
                 f"in-process {want}")
        with open(os.path.join(out_dir, "j4.json")) as f:
            if json.load(f)["results"] != got:
                fail(f"(j4) --workers {workers}: j4.json differs")
        line = [x for x in out.getvalue().splitlines()
                if x.startswith("evalsuite:")]
        print(f"[j] (j4) evalsuite.main --workers {workers} at full "
              f"width on {card}: wall {wall:.3f} s; tables equal the "
              f"in-process evaluate_suite's; combined "
              f"{rounded(got['combined'])}; {line[0] if line else ''}")
    torch.cuda.empty_cache()
    return paths


def phase_data(dev, card: str, trove: dict) -> dict:
    """(j) data management on the card: (j1) the eval suite online over
    MaterializedQRel tables, (j2) with one shared cache, (j3) at W = 2,
    (j4) the launcher, (j5) the memory claim as host RSS.  Returns each
    path's launch counts."""
    paths: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        mem_dir = os.path.join(tmp, "mem")
        setup = start_memory_data(mem_dir)
        try:
            paths.update(suite_paths(dev, card, trove, tmp))
            memory = data_memory(mem_dir, setup)
        finally:
            if setup.poll() is None:
                setup.kill()
                setup.wait()
    labels = {"table1": "MaterializedQRel", "concat_view": "ConcatView stream"}
    for case, (naive, streamed) in memory.items():
        ref_naive, ref_streamed = J5_REF[case]
        print(f"[j] (j5) {case}, host RSS (peak less the import floor; "
              f"not device memory): naive {naive:.2f} MB, {labels[case]} "
              f"{streamed:.2f} MB, {naive / streamed:.1f}x; the "
              f"reference's container figures {ref_naive} / "
              f"{ref_streamed} MB, {ref_naive / ref_streamed:.1f}x")
    naive, streamed = memory["concat_view"]
    if streamed > naive:
        fail(f"(j5) the streamed union's net RSS {streamed:.2f} MB exceeds "
             f"the naive union's {naive:.2f} MB")
    return paths


# (j5)'s subprocess programs, after benchmarks/bench_memory.py: the data
# (written once), the naive loaders (json into dicts) and the port's
# (MaterializedQRel, ConcatView streaming), each measured as its peak RSS
# less the import floor of its own imports.  The port's programs import
# only repro_torch.data.* and core.materialized_qrel: no torch module, so
# no CUDA context, enters their floor.
J5_GEN = """
import os
from repro_torch.data.synthetic import make_retrieval_dataset
d = {dir!r}
make_retrieval_dataset(d, n_queries=%d, n_docs=%d, n_topics=%d,
                       doc_len=%d)
for i in range(2):
    make_retrieval_dataset(os.path.join(d, f"part{{i}}"), n_queries=%d,
                           n_docs=%d, n_topics=%d, doc_len=%d,
                           seed=10 + i, id_prefix=f"p{{i}}-")
""" % (J5_QUERIES, J5_DOCS, J5_TOPICS, J5_DOC_LEN, J5_PART_QUERIES,
       J5_PART_DOCS, J5_TOPICS, J5_DOC_LEN)
J5_NAIVE_IMPORTS = "import json\nd = {dir!r}\n"
J5_NAIVE = """
queries, corpus, qrels = {}, {}, {}
with open(d + "/queries.jsonl") as f:
    for line in f:
        r = json.loads(line); queries[r["_id"]] = r["text"]
with open(d + "/corpus.jsonl") as f:
    for line in f:
        r = json.loads(line); corpus[r["_id"]] = r["text"]
with open(d + "/qrels/train.tsv") as f:
    for line in f:
        q, doc, s = line.split("\\t")
        qrels.setdefault(q, {})[doc] = float(s)
inst = [(queries[q], [corpus[doc] for doc in docs])
        for q, docs in qrels.items()]
print("instances", len(inst))
"""
J5_NAIVE_UNION = """
corpus = {}
for i in range(2):
    with open(d + f"/part{i}/corpus.jsonl") as f:
        for line in f:
            r = json.loads(line); corpus[r["_id"]] = r["text"]
texts = list(corpus.values())
print("union docs", len(corpus), sum(len(t) for t in texts[:8]))
"""
J5_PORT_IMPORTS = """
import sys
from repro_torch.core.config import MaterializedQRelConfig
from repro_torch.core.materialized_qrel import MaterializedQRel
from repro_torch.data.views import ConcatView, row_text
assert not [n for n in sys.modules if n == "torch" or n.startswith("torch.")]
d = {dir!r}
def source(p, **kw):
    return MaterializedQRel(MaterializedQRelConfig(
        qrel_path=p + "/qrels/train.tsv", query_path=p + "/queries.jsonl",
        corpus_path=p + "/corpus.jsonl", **kw), cache_root=d + "/cache")
def stream(view):
    n = 0
    for off, rows in view.open_slice(0, len(view), 1024):
        n += sum(len(row_text(r)) for r in rows)
    return n
"""
# every query's text and its positive docs' texts, materialized once
J5_PORT = """
m = source(d, min_score=1)
n = 0
for q in m.query_id_hashes:
    n += len(m.query_text(int(q)))
    for did in m.group(int(q))[0]:
        n += len(m.doc_text(int(did)))
print("instances", len(m), n)
"""
J5_PORT_UNION = """
v = ConcatView(source(d + "/part0").corpus_view(),
               source(d + "/part1").corpus_view())
print("union bytes", stream(v))
"""
# The peak: VmHWM where the kernel keeps it; where /proc/self/status has
# VmRSS only, the largest VmRSS that a sampling thread started before the
# program's imports saw, and a last reading at the end.  ru_maxrss will
# not do: a child inherits its parent's peak through exec, and the
# parent here holds a CUDA context.
J5_SAMPLER = """
import threading as _threading, time as _time
def _vm_kb(key):
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key):
                return int(line.split()[1])
    return None
_sampled = [0]
def _sample():
    while True:
        _sampled[0] = max(_sampled[0], _vm_kb("VmRSS:"))
        _time.sleep(0.001)
_threading.Thread(target=_sample, daemon=True).start()
"""
J5_PEAK = """
_hwm = _vm_kb("VmHWM:")
print("PEAK_RSS_KB", _hwm if _hwm is not None
      else max(_sampled[0], _vm_kb("VmRSS:")),
      "VmHWM" if _hwm is not None else "sampled-VmRSS")
"""


def peak_rss_mb(program: str) -> tuple[float, str]:
    """Run ``program`` in a fresh interpreter with the checkout's ``src``
    on its path; its peak RSS in MB, and where the peak was read."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    out = subprocess.run(
        [sys.executable, "-c", J5_SAMPLER + program + J5_PEAK], env=env,
        capture_output=True, text=True, timeout=900, check=True).stdout
    for line in out.splitlines():
        if line.startswith("PEAK_RSS_KB"):
            _, kb, source = line.split()
            return int(kb) / 1024.0, source
    raise RuntimeError(f"no peak in the output: {out[-500:]!r}")


def start_memory_data(d: str) -> subprocess.Popen:
    """(j5)'s set-up, started in the background while (j1)-(j4) run: a
    process that writes the data and builds its tables and groups once,
    so no build is measured."""
    os.makedirs(d, exist_ok=True)
    program = (J5_GEN + J5_PORT_IMPORTS + J5_PORT + J5_PORT_UNION).format(
        dir=d)
    return subprocess.Popen(
        [sys.executable, "-c", program], stdout=subprocess.DEVNULL,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))


def data_memory(d: str, setup: subprocess.Popen) -> dict:
    """(j5): ``{"table1": (naive MB, MaterializedQRel MB), "concat_view":
    (naive union MB, ConcatView stream MB)}``, each a subprocess's peak
    RSS less its import floor."""
    t0 = time.perf_counter()
    if setup.wait(timeout=900) != 0:
        fail(f"(j5) writing the data failed: exit {setup.returncode}")
    t_wait = time.perf_counter() - t0
    naive_floor, source = peak_rss_mb(J5_NAIVE_IMPORTS.format(dir=d))
    port_floor, _ = peak_rss_mb(J5_PORT_IMPORTS.format(dir=d))
    out = {}
    for case, naive, port in (("table1", J5_NAIVE, J5_PORT),
                              ("concat_view", J5_NAIVE_UNION,
                               J5_PORT_UNION)):
        n, _ = peak_rss_mb(J5_NAIVE_IMPORTS.format(dir=d) + naive)
        p, _ = peak_rss_mb(J5_PORT_IMPORTS.format(dir=d) + port)
        out[case] = (max(n - naive_floor, 1e-3), max(p - port_floor, 1e-3))
    corpus_mb = [os.path.getsize(os.path.join(d, *part, "corpus.jsonl"))
                 / 2 ** 20 for part in ((), ("part0",), ("part1",))]
    print(f"[j] (j5) data and tables ready {t_wait:.3f} s after (j4); "
          f"corpus files {corpus_mb[0]:.2f} MB, parts {corpus_mb[1]:.2f} + "
          f"{corpus_mb[2]:.2f} MB; peaks from {source}; import floors: "
          f"naive {naive_floor:.2f} MB, port {port_floor:.2f} MB (host RSS)")
    return out


# -- (k) the IVF index on the card --------------------------------------------

# (k1)-(k4): (c)'s dataset behind K_CLUSTERS clusters, pruned rounds
# probing K_NPROBE of them; K_SINGLE single-query searches show a lone
# query's pruning.  (k5): K5_N seeded unit rows around K5_TOPICS topic
# centres (the reference's ``_clustered`` recipe, tests/test_ivf.py),
# indexed with K5_CLUSTERS clusters, searched by K5_REQUESTS requests of
# K5_Q queries at each of K5_NPROBES and flat, and by K5_Q single
# queries.
K_CLUSTERS, K_NPROBE, K_SINGLE, K_LIVE_Q = 64, 8, 32, 32
K_PAIRS = (("fused", "kernel"), ("torch", "kernel"))
K5_N, K5_TOPICS, K5_CLUSTERS, K5_Q, K5_REQUESTS = 262_144, 512, 512, 32, 8
K5_NPROBES = (8, 32, 512)
# (train_steps, train_batch) of (k5)'s two builds: the reference's
# defaults (each of 512 centroids sees ~80 rows in all), then batches of
# 16,384 rows (~32 per centroid a step)
K5_BUILDS = ((40, 1024), (40, 16384))


def ivf(nprobe: int, nclusters: int = K_CLUSTERS) -> dict:
    return {"index_impl": "ivf", "ivf_nclusters": nclusters,
            "ivf_nprobe": nprobe}


def same_ranking(name: str, ids, vals, want_ids, want_vals) -> int:
    """Scores bitwise equal; ids equal except inside runs of exactly
    equal scores, where the id sets match (a run cut by the end of a row
    may hold other members of its tie group: only its scores are held).
    A full probe scans the rows in cluster order, so among equal scores
    another row may come first.  Returns the number of tied slots."""
    import numpy as np
    if vals.dtype != want_vals.dtype or not np.array_equal(vals, want_vals):
        fail(f"{name}: scores not bitwise equal")
    ties = 0
    for r, wv in enumerate(want_vals):
        start = 0
        while start < len(wv):
            end = start + 1
            while end < len(wv) and wv[end] == wv[start]:
                end += 1
            if end - start == 1:
                if ids[r, start] != want_ids[r, start]:
                    fail(f"{name}: row {r} slot {start} id differs")
            else:
                ties += end - start
                if end < len(wv) and (set(ids[r, start:end].tolist())
                                      != set(want_ids[r, start:end].tolist())):
                    fail(f"{name}: row {r} tie run {start}..{end} ids "
                         f"differ")
            start = end
    return ties


def exact_over(q, rows, row_ids):
    """Exact float64 top-K of ``q @ rows.T`` on the card -> (ids, values
    as float32), over at most K of the rows."""
    import torch
    scores = q.double() @ rows.double().T
    v, p = torch.sort(scores, dim=1, descending=True, stable=True)
    k = min(K, rows.shape[0])
    return (row_ids[p[:, :k].cpu().numpy()],
            v[:, :k].float().cpu().numpy())


def check_exact_over(name, ids, vals, q, rows, row_ids) -> float:
    """``check_exact`` against an exact float64 top-k over ``rows``."""
    want_ids, want_vals = exact_over(q, rows, row_ids)
    k = want_ids.shape[1]
    return check_exact(name, ids[:, :k], vals[:, :k], want_ids, want_vals)


def recall(ids, flat_ids) -> float:
    """Mean recall@K of ``ids`` against the flat search's ids."""
    import numpy as np
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                          for a, b in zip(ids, flat_ids)]))


def selected_rows(prepared, q_emb):
    """The store rows an IVF round of ``q_emb`` scans."""
    index = prepared.index
    return index.gather_rows(index.select(q_emb, prepared.nprobe))


def fetch(dev, prepared, sel):
    """``sel``'s rows of a prepared IVF corpus, as float32 on the card."""
    import torch
    rows = (torch.from_numpy(sel).to(dev) if prepared.rows_device is not None
            else sel)
    return torch.as_tensor(prepared.fetch_rows(rows)).to(dev)


class BuildLog:
    """Counts ``IVFIndex.build`` calls, and times the k-means training
    and the row assignment inside them, by wrapping them here."""

    def __init__(self):
        self.builds = 0
        self.kmeans_s: list = []
        self.assign_s: list = []

    def __enter__(self):
        from repro_torch.index import ivf as ivf_mod
        self._orig = (ivf_mod.IVFIndex.build, ivf_mod.train_kmeans,
                      ivf_mod.assign_rows)
        build, train, assign = self._orig

        def timed(fn, into):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                into.append(time.perf_counter() - t0)
                return out
            return call

        def counted(cls, *a, **kw):
            self.builds += 1
            return build.__func__(cls, *a, **kw)

        ivf_mod.IVFIndex.build = classmethod(counted)
        ivf_mod.train_kmeans = timed(train, self.kmeans_s)
        ivf_mod.assign_rows = timed(assign, self.assign_s)
        return self

    def __exit__(self, *exc):
        from repro_torch.index import ivf as ivf_mod
        (ivf_mod.IVFIndex.build, ivf_mod.train_kmeans,
         ivf_mod.assign_rows) = self._orig


def expect_builds(name: str, log: BuildLog, n: int) -> None:
    if log.builds != n:
        fail(f"{name}: {log.builds} IVFIndex.build calls, expected {n}")


class SelectionLog:
    """Per frontend micro-batch, its texts, query embeddings and the
    store rows its IVF round selected, recorded by wrapping
    ``EvaluatorServeBackend.begin`` and ``IVFPreparedCorpus.round_for``
    (both run on the dispatcher thread) here, in the script."""

    def __init__(self):
        self.batches: list = []
        self._texts = None

    def __enter__(self):
        from repro_torch.core.evaluator import IVFPreparedCorpus
        from repro_torch.core.serving import EvaluatorServeBackend
        self._orig = (EvaluatorServeBackend.begin,
                      IVFPreparedCorpus.round_for)
        begin, round_for = self._orig

        def logged_begin(backend, texts, *a, **kw):
            self._texts = list(texts)
            return begin(backend, texts, *a, **kw)

        def logged_round_for(prepared, q_emb):
            out = round_for(prepared, q_emb)
            if self._texts is not None:
                self.batches.append((self._texts, q_emb.clone(),
                                     selected_rows(prepared, q_emb)))
                self._texts = None
            return out

        EvaluatorServeBackend.begin = logged_begin
        IVFPreparedCorpus.round_for = logged_round_for
        return self

    def __exit__(self, *exc):
        from repro_torch.core.evaluator import IVFPreparedCorpus
        from repro_torch.core.serving import EvaluatorServeBackend
        EvaluatorServeBackend.begin, IVFPreparedCorpus.round_for = (
            self._orig)

    def batch_of(self, text: str, first: int = 0):
        """(the query row for ``text``, the selection) of the first
        recorded micro-batch from ``first`` on that holds ``text``."""
        for texts, q_emb, sel in self.batches[first:]:
            if text in texts:
                i = texts.index(text)
                return q_emb[i: i + 1], sel
        fail(f"no recorded micro-batch holds {text!r}")


def phase_ivf(dev, card: str, trove: dict) -> tuple[dict, list]:
    """(k) the IVF index on the card: (k2) a cold and warm cached
    evaluate, (k1) device-resident prepared corpora against flat, (k3)
    W > 1 with every rank's own build and a crash, (k4) serving, (k2)
    a live corpus, (k5) a 262,144-row corpus.  Returns each path's
    launches and K1's timing at (k5)'s pruned serving round."""
    from repro_torch.core.embedding_cache import EmbeddingCache

    paths: dict = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cache = EmbeddingCache(os.path.join(tmp, "cache"), D)
        ivf_cached_passes(dev, card, trove, cache, paths)
        prepared = ivf_prepared(dev, card, trove, cache, paths)
        ivf_workers(dev, card, trove, cache, prepared, tmp, paths)
        ivf_serving(dev, card, trove, cache, prepared, tmp, paths)
        del prepared
        ivf_live(dev, card, trove, cache, paths)
    timing = ivf_at_scale(dev, card, trove, paths)
    print(f"[k] phase (k): {time.perf_counter() - t_phase:.1f} s")
    return paths, [timing]


def ivf_cached_passes(dev, card, trove, cache, paths) -> None:
    """(k2) a cold ``evaluate(cache=)`` builds and saves the index; the
    first warm pass keys it by the pinned snapshot's generation (a
    rebuild, as in the reference), the next loads it; flat and pruned
    metrics; a warm ``mine_hard_negatives``."""
    import numpy as np

    queries, corpus, qrels = (trove["queries"], trove["corpus"],
                              trove["qrels"])
    ev = trove_evaluator(dev, trove, index=ivf(K_NPROBE))
    index_dir = os.path.join(cache.path, f"ivf_k{K_CLUSTERS}")

    def want(_):
        return predicted(ev, "fused", "kernel")

    with BuildLog() as log:
        t0 = time.perf_counter()
        cold = on_path(paths, "(k2) cold evaluate(cache=) nprobe 8 (fused, "
                       "kernel)", "fused_score_topk",
                       lambda: ev.evaluate(queries, corpus, qrels,
                                           cache=cache), want)
        cold_s = time.perf_counter() - t0
    expect_builds("(k2) cold evaluate", log, 1)
    if not os.path.exists(os.path.join(index_dir, "meta.json")):
        fail(f"(k2) no index saved under {index_dir}")
    print(f"[k] (k2) cold evaluate(cache=) nprobe {K_NPROBE} (fused, kernel) "
          f"on {card}: {cold_s:.3f} s, one build (k-means "
          f"{log.kmeans_s[0]:.3f} s, assignment {log.assign_s[0]:.3f} s), "
          f"saved to ivf_k{K_CLUSTERS}; metrics {rounded(cold)}")
    warm = []
    for i in range(2):
        with BuildLog() as log:
            t0 = time.perf_counter()
            warm.append(on_path(
                paths, f"(k2) warm search {i + 1} nprobe 8 (fused, kernel)",
                "fused_score_topk",
                lambda: ev.search(queries, corpus, cache=cache), want))
            warm_s = time.perf_counter() - t0
        expect_builds(f"(k2) warm search {i + 1}", log, 1 - i)
        print(f"[k] (k2) warm search {i + 1} on {card}: {warm_s:.3f} s, "
              f"{log.builds} build(s)"
              + (" (the snapshot's generation keys the index)" if i == 0
                 else ", the persisted index loaded"))
    same_bits("(k2) warm search 2 vs 1", warm[1], warm[0])
    with BuildLog() as log:
        pruned = on_path(paths, "(k2) warm evaluate nprobe 8 (fused, "
                         "kernel)", "fused_score_topk",
                         lambda: ev.evaluate(queries, corpus, qrels,
                                             cache=cache), want)
        expect_builds("(k2) warm evaluate", log, 0)
        flat_ev = trove_evaluator(dev, trove)
        flat = on_path(paths, "(k2) warm evaluate flat (fused, kernel)",
                       "fused_score_topk",
                       lambda: flat_ev.evaluate(queries, corpus, qrels,
                                                cache=cache),
                       lambda _: predicted(flat_ev, "fused", "kernel"))
        negs = on_path(paths, "(k2) warm mine_hard_negatives nprobe 8 "
                       "(fused, kernel)", "fused_score_topk",
                       lambda: ev.mine_hard_negatives(
                           queries, corpus, qrels, depth=20, cache=cache),
                       want)
        expect_builds("(k2) warm evaluate and mine", log, 0)
    if not negs or not np.isfinite([s for _, _, s in negs]).all():
        fail("(k2) mine_hard_negatives returned nothing / non-finite")
    st = ev.last_search_stats
    print(f"[k] (k2) warm search 2 bitwise equal to warm search 1; warm "
          f"evaluate metrics flat {rounded(flat)}, nprobe {K_NPROBE} "
          f"{rounded(pruned)} ({st['items']} of {len(corpus)} rows scanned "
          f"for the {len(queries)}-query batch); mine_hard_negatives "
          f"{len(negs)} triplets")


def ivf_prepared(dev, card, trove, cache, paths):
    """(k1) device-resident prepared corpora over the warm cache's rows:
    a full probe against flat (scores bitwise, ids outside exact ties)
    on both pairs, and nprobe 8 against an exact float64 top-k over the
    selected rows, for the 256-query batch and for single queries.
    Returns the nprobe-8 prepared corpus."""
    import numpy as np
    import torch

    queries, corpus = trove["queries"], trove["corpus"]
    texts = list(queries.values())
    flat = trove_evaluator(dev, trove).prepare_corpus(
        corpus, cache, device_resident=True)
    with BuildLog() as log:
        full = trove_evaluator(dev, trove, index=ivf(K_CLUSTERS)
                               ).prepare_corpus(corpus, cache,
                                                device_resident=True)
        expect_builds("(k1) full-probe prepare", log, 1)
        pruned = trove_evaluator(dev, trove, index=ivf(K_NPROBE)
                                 ).prepare_corpus(corpus, cache,
                                                  device_resident=True)
        expect_builds("(k1) nprobe 8 prepare (the index loaded)", log, 1)
    n = len(corpus)
    if full.rows_device != dev or not torch.equal(
            fetch(dev, full, np.arange(n)), flat.load_chunk(0, n)):
        fail("(k1) the IVF store is not the flat rows on the card")
    for name in ("centroids", "perm", "offsets"):
        if not np.array_equal(getattr(full.index, name),
                              getattr(pruned.index, name)):
            fail(f"(k1) the loaded index's {name} differs from the built")
    sizes = full.index.cluster_sizes()
    print(f"[k] (k1) {K_CLUSTERS} clusters over {n} rows: sizes "
          f"{int(sizes.min())}..{int(sizes.max())}, "
          f"{int((sizes == 0).sum())} empty; k-means "
          f"{log.kmeans_s[0]:.3f} s, assignment {log.assign_s[0]:.3f} s "
          f"on {card}")
    q_emb = query_embeddings(dev, trove, texts)
    sel = selected_rows(pruned, q_emb)
    singles = texts[:K_SINGLE]
    flat_single = None
    for score, heap in K_PAIRS:
        pair = f"({score}, {heap})"
        evs = {name: trove_evaluator(dev, trove, score, heap, index=index)
               for name, index in (("flat", None),
                                   ("full", ivf(K_CLUSTERS)),
                                   ("pruned", ivf(K_NPROBE)))}
        kernel = path_kernel(score, heap)
        out = {}
        for name, prep in (("flat", flat), ("full", full),
                           ("pruned", pruned)):
            ev = evs[name]
            out[name] = on_path(
                paths, f"(k1) search_prepared {name} {pair}", kernel,
                lambda ev=ev, prep=prep: ev.search_prepared(queries, prep),
                lambda _, ev=ev: predicted(ev, score, heap))
        ties = same_ranking(f"(k1) full probe vs flat {pair}",
                            out["full"][1], out["full"][2], out["flat"][1],
                            out["flat"][2])
        _, ids, vals = out["pruned"]
        err = check_exact_over(f"(k1) nprobe 8 {pair}", ids, vals, q_emb,
                               fetch(dev, pruned, sel), pruned.hashes[sel])
        print(f"[k] (k1) {pair}: full probe vs flat scores bitwise, ids "
              f"equal outside {ties} tied slots; nprobe {K_NPROBE} over "
              f"{len(sel)} of {n} rows for {len(texts)} queries: vs exact "
              f"float64 top-k {err:.3g} (tol {TOL}), recall@{K} vs flat "
              f"{recall(ids, out['flat'][1]):.4f}")
        # a lone query probes its own clusters only
        ev = evs["pruned"]
        if flat_single is None:
            flat_ms, flat_single = [], []
            for t in singles:
                t0 = time.perf_counter()
                flat_single.append(evs["flat"].search_texts([t], flat))
                flat_ms.append((time.perf_counter() - t0) * 1e3)
        single_ms = []

        def run_singles(ev=ev):
            outs = []
            for t in singles:
                t0 = time.perf_counter()
                outs.append(ev.search_texts([t], pruned))
                single_ms.append((time.perf_counter() - t0) * 1e3)
            return outs

        log = RoundLog()

        def logged():
            with log:
                return run_singles()
        outs = on_path(paths, f"(k1) {K_SINGLE} single-query search_texts "
                       f"nprobe 8 {pair}", kernel, logged,
                       lambda _: predict(log.stats, score, heap))
        scanned, err = [], 0.0
        for t, (ids, vals) in zip(singles, outs):
            q1 = ev._encode_texts([t], True, device=True)
            rows = selected_rows(pruned, q1)
            scanned.append(len(rows))
            err = max(err, check_exact_over(
                f"(k1) single {pair}", ids, vals, q1,
                fetch(dev, pruned, rows), pruned.hashes[rows]))
        rec = recall(np.concatenate([o[0] for o in outs]),
                     np.concatenate([o[0] for o in flat_single]))
        print(f"[k] (k1) {K_SINGLE} single-query search_texts nprobe "
              f"{K_NPROBE} {pair} on {card}: median "
              f"{statistics.median(single_ms):.3f} ms (flat, fused: "
              f"{statistics.median(flat_ms):.3f}), rows scanned mean "
              f"{statistics.mean(scanned):.1f} of {n}; vs exact float64 "
              f"top-k {err:.3g}; recall@{K} vs flat {rec:.4f}")
    return pruned


def ivf_workers(dev, card, trove, cache, pruned, tmp, paths) -> None:
    """(k3) a device-resident IVF corpus at W = 1, 2, 4, every rank
    preparing from its own copy of the cache, so each builds its own
    index: the indexes bitwise equal across ranks and builds, every rank
    bitwise equal to W = 1, every cut on a cluster edge; then a crash at
    W = 2 over the pruned space, and the round after it."""
    import shutil

    import numpy as np

    from repro_torch.core.embedding_cache import EmbeddingCache
    from repro_torch.core.fair_sharding import FairSharder
    from repro_torch.launch.distributed import SimulatedCluster

    corpus = trove["corpus"]
    texts = list(trove["queries"].values())
    batch = texts[:I_Q]
    own, first = {}, None
    for label, world in (("W=1", 1), ("W=1 again", 1), ("W=2", 2),
                         ("W=4", 4)):
        caches = []
        for r in range(world):
            path = os.path.join(tmp, f"rank-cache-{len(own)}-{r}")
            shutil.copytree(cache.path, path,
                            ignore=shutil.ignore_patterns("ivf_k*"))
            caches.append(EmbeddingCache(path, D))
        evs = [trove_evaluator(dev, trove, index=ivf(K_NPROBE))
               for _ in range(world)]
        with BuildLog() as log:
            t0 = time.perf_counter()
            preps = SimulatedCluster(world).run(
                lambda r: evs[r].prepare_corpus(corpus, caches[r],
                                                device_resident=True))
            prep_s = time.perf_counter() - t0
        expect_builds(f"(k3) {label} prepares", log, world)
        if first is None:
            first = preps[0]
        for r, p in enumerate(preps):
            for name in ("centroids", "perm", "offsets"):
                if not np.array_equal(getattr(p.index, name),
                                      getattr(first.index, name)):
                    fail(f"(k3) {label} rank {r}'s {name} differs from "
                         f"the first build's")
        own[label] = preps
        print(f"[k] (k3) {label}: each rank built its own index from its "
              f"own cache copy, concurrently ({prep_s:.3f} s for the "
              f"prepares, k-means {max(log.kmeans_s):.3f} s at most): "
              f"centroids, perm and offsets bitwise equal to the first "
              f"build's")
    q32 = query_embeddings(dev, trove, batch)
    q_all = query_embeddings(dev, trove, texts)
    for score, heap in K_PAIRS:
        pair = f"({score}, {heap})"
        kernel = path_kernel(score, heap)
        w1_ev = trove_evaluator(dev, trove, score, heap, index=ivf(K_NPROBE))
        w1 = (w1_ev.search_prepared(trove["queries"], own["W=1"][0])[1:],
              tuple(w1_ev.search_texts(batch, own["W=1"][0])))
        for world in (2, 4):
            cluster = SimulatedCluster(world)
            evs = [trove_evaluator(dev, trove, score, heap,
                                   index=ivf(K_NPROBE), process_index=r,
                                   process_count=world,
                                   gather=cluster.gather,
                                   sharder=cluster.sharder)
                   for r in range(world)]
            preps = own[f"W={world}"]
            for tag, q, fn, want in (
                    ("256-query search_prepared", q_all,
                     lambda r: evs[r].search_prepared(trove["queries"],
                                                      preps[r])[1:], w1[0]),
                    ("32-query search_texts", q32,
                     lambda r: tuple(evs[r].search_texts(batch, preps[r])),
                     w1[1])):
                t0 = time.perf_counter()
                outs = on_path(
                    paths, f"(k3) W={world} {tag} nprobe 8 {pair}", kernel,
                    lambda fn=fn: cluster.run(fn),
                    lambda _: predict([e.last_search_stats for e in evs],
                                      score, heap))
                wall = (time.perf_counter() - t0) * 1e3
                for r, o in enumerate(outs):
                    same_bits(f"(k3) W={world} {tag} {pair} rank {r}", o,
                              want)
                edges = set(preps[0].index.slice_boundaries(
                    preps[0].index.select(q, K_NPROBE)).tolist())
                cuts = [(e.last_search_stats["lo"], e.last_search_stats["hi"])
                        for e in evs]
                if not all(lo in edges and hi in edges for lo, hi in cuts):
                    fail(f"(k3) W={world} {tag} {pair}: cuts {cuts} not on "
                         f"the space's cluster edges")
                print(f"[k] (k3) W={world} {tag} nprobe {K_NPROBE} {pair} "
                      f"on {card}: {wall:.3f} ms; shards {cuts} on cluster "
                      f"edges; every rank bitwise equal to W=1")

    # the chaos matrix's ivf half: a crash at worker 1 in round 0, W = 2
    batches = [texts[I_Q * i: I_Q * (i + 1)] for i in range(2)]
    for score, heap in K_PAIRS:
        pair = f"({score}, {heap})"
        w1_ev = trove_evaluator(dev, trove, score, heap, index=ivf(K_NPROBE))
        want = [w1_ev.search_texts(b, pruned) for b in batches]
        cc = ChaosCluster(dev, trove, 2, score, heap, [chaos_fault("crash")],
                          index=ivf(K_NPROBE))
        tag = f"(k3) W=2 crash, nprobe 8 {pair}"
        space = pruned.round_for(query_embeddings(dev, trove, batches[0]))[0]
        snapped = FairSharder(2).bounds(len(space),
                                        space.partition_boundaries)
        (outs, wall, _), stats = logged_path(
            paths, f"{tag} round 0", score, heap,
            lambda: cc.round(lambda r, ev: ev.search_texts(batches[0],
                                                           pruned)))
        check_recovered(tag, outs, want[0])
        rescued = [r for st in stats for r in st["rescored"]]
        if rescued != [snapped[1]] or cc.cluster.health.dead != {1}:
            fail(f"{tag}: rescored {rescued}, not worker 1's snapped shard "
                 f"{snapped[1]}; dead {cc.cluster.health.dead}")
        q1 = query_embeddings(dev, trove, batches[1])
        space = pruned.round_for(q1)[0]
        edges = space.partition_boundaries
        (outs, _, after_ms), stats = logged_path(
            paths, f"{tag} round 1", score, heap,
            lambda: cc.round(lambda r, ev: ev.search_texts(batches[1],
                                                           pruned)))
        check_recovered(f"{tag} round 1", outs, want[1])
        bounds = cc.cluster.sharder.bounds(len(space), edges)
        shards = sorted((st["lo"], st["hi"]) for st in stats)
        if (len(stats) != 1 or bounds[1][0] != bounds[1][1]
                or not {b for lo_hi in bounds for b in lo_hi}
                <= set(edges.tolist())
                or shards != [(0, len(space))]):
            fail(f"{tag} round 1: bounds {bounds}, survivors' shards "
                 f"{shards}")
        print(f"[k] {tag}: worker 1's snapped shard {snapped[1]} rescored, "
              f"every rank bitwise equal to W=1 with coverage 1 (the "
              f"survivor's round {wall[0]:.3f} ms); round 1: rank 1 dead "
              f"with an empty shard, cuts {bounds} on cluster edges, "
              f"{after_ms:.3f} ms")


def ivf_serving(dev, card, trove, cache, pruned, tmp, paths) -> None:
    """(k4) ``ServeFrontend.from_evaluator`` over an IVF device-resident
    corpus: at nprobe = nclusters each request held against its flat solo
    ``search_texts``; at nprobe 8 against an exact top-k over its
    micro-batch's selection, and above its solo pruned search; then
    ``serve.main --index-impl ivf`` at ``--workers 1`` and ``2``."""
    import contextlib
    import io
    import shutil

    import numpy as np

    from repro_torch.core import sharded_search
    from repro_torch.core.serving import ServeFrontend
    from repro_torch.data.synthetic import make_retrieval_dataset
    from repro_torch.launch import serve

    queries, corpus = trove["queries"], trove["corpus"]
    texts = list(queries.values())
    flat_ev = trove_evaluator(dev, trove)
    flat = flat_ev.prepare_corpus(corpus, cache, device_resident=True)
    solo = {"serial": [flat_ev.search_texts(texts[32 * r: 32 * (r + 1)],
                                            flat)
                       for r in range(D_SERIAL)],
            "single": [flat_ev.search_texts([t], flat)
                       for t in texts[:D_SINGLE]]}
    with BuildLog() as log:
        fe = ServeFrontend.from_evaluator(
            trove_evaluator(dev, trove, index=ivf(K_CLUSTERS)), corpus, cache)
    expect_builds("(k4) full-probe frontend (the index loaded)", log, 0)
    try:
        drive_frontend(paths, "(k4) nprobe 64", fe, texts, solo, card,
                       phase="k")
    finally:
        fe.close()
    del flat

    ev = trove_evaluator(dev, trove, index=ivf(K_NPROBE))
    fe = ServeFrontend.from_evaluator(ev, corpus, cache)
    prepared = fe.backend.prepared
    sel_log = SelectionLog()
    requests = [texts[32 * r: 32 * (r + 1)] for r in range(D_SERIAL)] + [
        [t] for t in texts[:D_SINGLE]]
    try:
        t0 = time.perf_counter()
        rung = 1
        while rung <= fe.max_batch:
            fe.search(texts[:rung], timeout=D_RESULT_S)
            rung *= 2
        warm_ms = (time.perf_counter() - t0) * 1e3

        def serve_all():
            from concurrent.futures import ThreadPoolExecutor
            with sel_log:
                outs = [fe.search(r, timeout=D_RESULT_S)
                        for r in requests[:D_SERIAL]]
                with ThreadPoolExecutor(
                        D_THREADS, thread_name_prefix="serve-client") as pool:
                    outs += list(pool.map(
                        lambda r: fe.submit(r).result(timeout=D_RESULT_S),
                        requests[D_SERIAL:]))
            return outs

        t0 = time.perf_counter()
        outs = serving_path(paths, f"(k4) nprobe 8 {D_SERIAL} x 32 + "
                            f"{D_SINGLE} single requests (fused, kernel)",
                            serve_all)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        fe.close()
    if [b[0] for b in sel_log.batches[:D_SERIAL]] != requests[:D_SERIAL]:
        fail("(k4) a 32-query request was not a micro-batch of its own")
    err, above, grew = 0.0, 0, 0
    for r, (request, (ids, vals)) in enumerate(zip(requests, outs)):
        for j, t in enumerate(request):
            q1, sel = sel_log.batch_of(t, r if r < D_SERIAL else D_SERIAL)
            err = max(err, check_exact_over(
                f"(k4) nprobe 8 request {t[:20]!r}", ids[j:j + 1],
                vals[j:j + 1], q1, fetch(dev, prepared, sel),
                prepared.hashes[sel]))
            own = selected_rows(prepared, q1)
            grew += len(sel) > len(own)
        solo_ids, solo_vals = ev.search_texts(request, prepared)
        if not (vals >= solo_vals - TOL).all():
            fail(f"(k4) nprobe 8: a request scored below its solo pruned "
                 f"search")
        above += int((vals > solo_vals + TOL).any())
    sizes = [len(sel) for _, _, sel in sel_log.batches]
    print(f"[k] (k4) nprobe {K_NPROBE} frontend on {card}: rung warm pass "
          f"{warm_ms:.3f} ms; {len(requests)} requests in {wall:.3f} ms over "
          f"{len(sel_log.batches)} micro-batches scanning "
          f"{min(sizes)}..{max(sizes)} rows; each request vs an exact "
          f"float64 top-k over its micro-batch's clusters {err:.3g} (tol "
          f"{TOL}); {grew} queries scanned more than their own clusters, "
          f"{above} requests scored above their solo pruned search, none "
          f"below; frontend stats {json.dumps(fe.stats)}")

    # the launcher, over (c)'s dataset with the warm cache copied in (its
    # corpus is (c)'s, same seed), so it encodes no corpus row
    rungs = (1, 2, 4, 8, 16, 32)
    for q in rungs:
        sharded_search.autotune_superchunk_size(q, D, C, K, "fused",
                                                "kernel", dev.type)
    n_tuned = len(sharded_search._AUTOTUNE_CACHE)
    data = os.path.join(tmp, "serve-data")
    _, k4_corpus, _ = make_retrieval_dataset(
        data, n_queries=len(queries), n_docs=len(corpus), n_topics=64,
        seed=SEED)
    if list(k4_corpus) != list(corpus):
        fail("(k4) the launcher's dataset is not (c)'s")
    shutil.copytree(cache.path, serve.cache_dir(data, "trove-base", False))
    argv = ["--data-dir", data, "--device", dev.type, "--topk", str(K),
            "--n-requests", str(D_SINGLE), "--batch", "1", "--concurrency",
            str(D_THREADS), "--max-batch", str(rungs[-1]), "--index-impl",
            "ivf", "--nclusters", str(K_CLUSTERS), "--nprobe", str(K_NPROBE)]
    for workers in ("1", "2"):
        out = io.StringIO()
        served = ServedLog()

        def run(workers=workers, out=out, served=served):
            with contextlib.redirect_stdout(out), served:
                return serve.main(argv + ["--workers", workers])

        tag = f"(k4) serve.main --index-impl ivf --workers {workers}"
        try:
            with BuildLog() as log:
                stats = serving_path(paths, f"{tag} (fused, kernel)", run)
            held = check_served_pruned(tag, served)
        finally:
            served.close()
        if len(sharded_search._AUTOTUNE_CACHE) != n_tuned:
            fail(f"{tag}: the warm pass autotuned a new key")
        fs = stats["frontend"]
        if (fs["completed"] != D_SINGLE + len(rungs) or fs["failed"]
                or not np.isfinite([stats["p50_ms"], stats["p99_ms"],
                                    stats["qps"]]).all()):
            fail(f"{tag}: {json.dumps(fs)}")
        print(f"[k] {tag} ({stats['label']}, {D_SINGLE} single-query "
              f"requests from {D_THREADS} threads) on {card}: p50 "
              f"{stats['p50_ms']:.3f} ms, p99 {stats['p99_ms']:.3f} ms, "
              f"{stats['qps']:.1f} queries/s; {fs['batches']} micro-batches,"
              f" {log.builds} index build(s); {held}")


def check_served_pruned(tag: str, served: ServedLog) -> str:
    """(k4)'s launcher results: shapes (1, K), finite descending scores,
    and each request's scores at least its solo pruned ``search_texts``
    over the backend's own prepared corpus (rank 0's at W = 2), within
    TOL: a coalesced micro-batch scans a superset of its clusters."""
    import numpy as np

    from repro_torch.core.evaluator import RetrievalEvaluator

    if len(served.frontends) != 1 or len(served.requests) != D_SINGLE:
        fail(f"{tag}: {len(served.frontends)} frontends, "
             f"{len(served.requests)} requests recorded")
    backend = served.frontends[0].backend
    if hasattr(backend, "evs"):
        rank0 = backend.evs[0]
        ev = RetrievalEvaluator(rank0.args, rank0.retriever, rank0.collator,
                                rank0.params, device=rank0.device,
                                process_index=0, process_count=1)
        prepared = backend.prepared[0]
    else:
        ev, prepared = backend.ev, backend.prepared
    above = 0
    for i, (texts, fut) in enumerate(served.requests):
        ids, vals = fut.result(timeout=D_RESULT_S)
        _, solo = ev.search_texts(texts, prepared)
        if (ids.shape != (1, K) or not np.isfinite(vals).all()
                or (np.diff(vals, axis=1) > 0).any()
                or not (vals >= solo - TOL).all()):
            fail(f"{tag} request {i}: ids {ids.shape}, scores below its "
                 f"solo pruned search or not finite and descending")
        above += int((vals > solo + TOL).any())
    return (f"every request finite, descending and at least its solo "
            f"pruned search ({above} above it)")


def ivf_live(dev, card, trove, cache, paths) -> None:
    """(k2) a live corpus through ``prepare_cache_corpus``: deletes and
    adds, then a compaction into ``cluster_order``; each new generation
    rebuilds the index (its digest holds the generation), a second
    prepare at one generation loads it, and each search equals an exact
    float64 top-k over its snapshot's selected rows."""
    import numpy as np
    import torch

    from repro_torch.index.ivf import cluster_order

    batch = list(trove["queries"].values())[:K_LIVE_Q]
    ev = trove_evaluator(dev, trove, index=ivf(K_NPROBE))
    q = ev._encode_texts(batch, True, device=True)

    def live_search(tag: str) -> None:
        with BuildLog() as log:
            prepared = ev.prepare_cache_corpus(cache)
            again = ev.prepare_cache_corpus(cache)
            again.close()
        try:
            expect_builds(f"(k2) live {tag}", log, 1)
            ids, vals = on_path(
                paths, f"(k2) live search_texts {tag} (fused, kernel)",
                "fused_score_topk",
                lambda: ev.search_texts(batch, prepared),
                lambda _: predicted(ev, "fused", "kernel"))
            sel = selected_rows(prepared, q)
            rows = torch.from_numpy(prepared.snapshot.get_rows(sel).astype(
                np.float32)).to(dev)
            err = check_exact_over(f"(k2) live {tag}", ids, vals, q, rows,
                                   prepared.hashes[sel])
            print(f"[k] (k2) live {tag}: generation {prepared.generation}, "
                  f"{prepared.n_docs} live rows, one build (a second "
                  f"prepare loaded it); {len(sel)} rows scanned, vs exact "
                  f"float64 top-k over the snapshot's rows {err:.3g} (tol "
                  f"{TOL})")
        finally:
            prepared.close()

    live_search("seed")
    rng = np.random.default_rng(SEED + 7)
    live = cache.snapshot()
    victims = live.ids[rng.choice(live.n_live, LIVE_DELETE, replace=False)]
    live.close()
    cache.delete_records(victims)
    cache.cache_records([f"k-live-{i}" for i in range(LIVE_ADD)],
                        unit_rows(rng, LIVE_ADD))
    live_search(f"after {LIVE_DELETE} deletes and {LIVE_ADD} adds")
    snap = cache.snapshot()
    try:
        order = cluster_order(
            lambda lo, hi: snap.get_range(lo, hi).astype(np.float32),
            snap.n_live, K_CLUSTERS, device=dev)
    finally:
        snap.close()
    print(f"[k] (k2) compact(order=cluster_order): "
          f"{json.dumps(cache.compact(order=order))}")
    live_search("after compaction into cluster_order")


def ivf_at_scale(dev, card, trove, paths) -> dict:
    """(k5) K5_N seeded unit rows on the card around K5_TOPICS topic
    centres, indexed twice (K5_BUILDS: the reference's k-means budget,
    then larger batches): each build's k-means and assignment times and
    cluster sizes, then K5_REQUESTS requests of K5_Q queries at each
    nprobe and flat, and K5_Q single-query requests at the first nprobe;
    the full probe held against flat as (k1) holds it.  Returns K1's
    timing at the pruned serving round (the first build, the first
    nprobe): one superchunk of its rows."""
    import numpy as np
    import torch

    from repro_torch.core.evaluator import IVFPreparedCorpus
    from repro_torch.index import IVFIndex

    g = torch.Generator(device=dev).manual_seed(SEED)

    def normed(x):
        return x / x.norm(dim=1, keepdim=True)

    t0 = time.perf_counter()
    centers = normed(torch.randn(K5_TOPICS, D, generator=g, device=dev))
    topic = torch.randint(0, K5_TOPICS, (K5_N,), generator=g, device=dev)
    docs = normed(centers[topic] + 0.12 * torch.randn(
        K5_N, D, generator=g, device=dev))
    picks = torch.randperm(K5_N, generator=g, device=dev)[:K5_Q * K5_REQUESTS]
    queries = normed(docs[picks] + 0.04 * torch.randn(
        len(picks), D, generator=g, device=dev))
    del centers, topic
    torch.cuda.synchronize()
    print(f"[k] (k5) {K5_N} unit rows x {D} float32 around {K5_TOPICS} "
          f"topics drawn on {card} ({K5_N * D * 4 / 2**30:.2f} GiB) in "
          f"{time.perf_counter() - t0:.3f} s")
    hashes = np.arange(K5_N, dtype=np.int64)
    ev = trove_evaluator(dev, trove)
    requests = [queries[K5_Q * r: K5_Q * (r + 1)] for r in range(K5_REQUESTS)]
    singles = [requests[0][i: i + 1] for i in range(K5_Q)]

    def run(space_for, batches):
        outs, ms, scanned, stats = [], [], [], []
        for qb in batches:
            t0 = time.perf_counter()
            sized, load_chunk, to_ids = space_for(qb)
            driver = ev.make_driver()
            vals, pos = driver.search(qb, sized, load_chunk, K)
            outs.append((to_ids(pos), vals))
            ms.append((time.perf_counter() - t0) * 1e3)
            scanned.append(len(sized) if not isinstance(sized, int)
                           else sized)
            stats.append(driver.stats)
        return outs, ms, scanned, stats

    def flat_space(qb):
        return K5_N, lambda lo, hi: docs[lo:hi], lambda pos: np.where(
            pos >= 0, hashes[np.clip(pos, 0, None)], -1)

    def counted(name, space_for, batches):
        return on_path(paths, f"(k5) {name} (fused, kernel)",
                       "fused_score_topk",
                       lambda: run(space_for, batches),
                       lambda r: predict(r[3], "fused", "kernel"))

    flat = counted(f"{K5_REQUESTS} x {K5_Q}-query requests flat", flat_space,
                   requests)
    flat_ids = np.concatenate([o[0] for o in flat[0]])
    timing = None
    for steps, batch in K5_BUILDS:
        knobs = f"train_steps {steps}, train_batch {batch}"
        with BuildLog() as log:
            t0 = time.perf_counter()
            index = IVFIndex.build(lambda lo, hi: docs[lo:hi], K5_N,
                                   K5_CLUSTERS, train_steps=steps,
                                   train_batch=batch, device=dev)
            build_s = time.perf_counter() - t0
        sizes = index.cluster_sizes()
        print(f"[k] (k5) IVFIndex.build, {K5_CLUSTERS} clusters, {knobs}, on "
              f"{card}: {build_s:.3f} s (k-means {log.kmeans_s[0]:.3f} s, "
              f"assignment {log.assign_s[0]:.3f} s); cluster sizes "
              f"{int(sizes.min())}..{int(sizes.max())}, median "
              f"{float(np.median(sizes)):.0f}, {int((sizes == 0).sum())} "
              f"empty")

        def space(nprobe, index=index):
            return IVFPreparedCorpus(hashes, K5_N, lambda rows: docs[rows],
                                     index, nprobe, rows_device=dev)

        for nprobe in K5_NPROBES:
            outs, ms, scanned, _ = counted(
                f"{K5_REQUESTS} x {K5_Q}-query requests nprobe {nprobe}, "
                f"{knobs}", space(nprobe).round_for, requests)
            held = "pruned"
            if nprobe >= K5_CLUSTERS:
                ties = sum(same_ranking(
                    f"(k5) nprobe {nprobe} request {r} vs flat", o[0], o[1],
                    f[0], f[1]) for r, (o, f) in enumerate(zip(outs,
                                                               flat[0])))
                held = (f"scores bitwise equal to flat, ids outside {ties} "
                        f"tied slots")
            rec = recall(np.concatenate([o[0] for o in outs]), flat_ids)
            print(f"[k] (k5) nprobe {nprobe}, {knobs}, on {card}: median "
                  f"{statistics.median(ms):.3f} ms a {K5_Q}-query request "
                  f"(flat {statistics.median(flat[1]):.3f}), rows scanned "
                  f"mean {statistics.mean(scanned):.0f} of {K5_N}, recall@"
                  f"{K} vs flat {rec:.4f}; {held}")
        nprobe = K5_NPROBES[0]
        outs, ms, scanned, _ = counted(
            f"{K5_Q} single-query requests nprobe {nprobe}, {knobs}",
            space(nprobe).round_for, singles)
        rec = recall(np.concatenate([o[0] for o in outs]),
                     flat_ids[:K5_Q])
        print(f"[k] (k5) {K5_Q} single-query requests nprobe {nprobe}, "
              f"{knobs}, on {card}: median {statistics.median(ms):.3f} ms, "
              f"rows scanned mean {statistics.mean(scanned):.0f} of {K5_N},"
              f" recall@{K} vs flat {rec:.4f}")
        if timing is None:
            # K1 at the pruned serving round: the first superchunk of
            # request 0's space at the first nprobe
            sized, load_chunk, _ = space(nprobe).round_for(requests[0])
            n = min(len(sized), S * C)
            rows = load_chunk(0, n)
            n_steps = -(-n // C)
            tile = torch.cat([rows, rows.new_zeros((n_steps * C - n, D))]
                             ).view(n_steps, C, D)
            start = torch.arange(n_steps, dtype=torch.int32, device=dev) * C
            timing = k1_time(
                dev, requests[0].contiguous(), tile, start,
                (n - start).clamp_(max=C),
                f"Q={K5_Q} S={n_steps} C={C} d={D} k={K}, (k5) nprobe "
                f"{nprobe} round's first superchunk ({len(sized)} rows a "
                f"round)", phase="k")
    again = counted(f"{K5_REQUESTS} x {K5_Q}-query requests flat, again",
                    flat_space, requests)
    print(f"[k] (k5) flat on {card}: median "
          f"{statistics.median(flat[1]):.3f} ms a {K5_Q}-query request "
          f"before the IVF requests, {statistics.median(again[1]):.3f} ms "
          f"after them")
    return timing


# -- (l) retrieval training on the card ---------------------------------------

# (l1) / (l2): launch/train.py over make_retrieval_dataset(256, 2048, 64)
# (its own default data), batches of L_BATCH queries x L_GROUP passages,
# L_QLEN / L_PLEN token budgets, a checkpoint every L_EVERY steps, a
# failure injected at L_FAIL_AT; (l4) mines L_DEPTH deep and retrains to
# L_RETRAIN steps from (l1)'s last checkpoint; (l3) serves L_REQUESTS
# requests of L_REQ_Q queries.  The learning rate is L_LR, not the
# default 1e-3: AdamW moves every weight by about the rate a step, and
# 20 steps of 1e-3 on weights drawn at 0.02 collapse the embeddings (the
# in-batch loss settles at ln(16), every score equal, on an H100).
L_STEPS, L_BATCH, L_GROUP, L_QLEN, L_PLEN, L_LR = 20, 8, 2, 32, 128, 1e-4
L_EVERY, L_FAIL_AT, L_RETRAIN, L_DEPTH = 10, 15, 25, 20
L_REQUESTS, L_REQ_Q = 8, 32
L_DATA = dict(n_queries=256, n_docs=2048, n_topics=64)


class TrainLog:
    """What a training run did, recorded here by wrapping, in the script:
    ``RetrievalTrainer.init_state`` (a copy of the initial params) and
    ``RetrievalCollator.__call__`` (each batch's padded and real token
    counts); ``fail_at`` makes ``RetrievalTrainer.train`` inject a
    failure at that step; without ``keep_initial`` no copy is taken."""

    def __init__(self, fail_at: int | None = None, keep_initial=True):
        self.fail_at = fail_at
        self.keep_initial = keep_initial
        self.initial = None
        self.tokens: list = []

    def __enter__(self):
        from repro_torch.core.collator import RetrievalCollator
        from repro_torch.training.trainer import RetrievalTrainer

        self._orig = (RetrievalTrainer.init_state, RetrievalTrainer.train,
                      RetrievalCollator.__call__)
        init_state, train, collate = self._orig

        def recorded_init(trainer, params=None):
            state = init_state(trainer, params)
            if not self.keep_initial:
                return state
            self.initial = {k: (v.clone() if not isinstance(v, dict) else
                                {n: t.clone() for n, t in v.items()})
                            for k, v in state["params"].items()}
            return state

        def failing_train(trainer, state=None, inject_failure_at=None):
            return train(trainer, state, self.fail_at)

        def recorded_collate(coll, features):
            batch = collate(coll, features)
            if "query" in batch:
                self.tokens.append(tuple(
                    (int(batch[s]["mask"].size), int(batch[s]["mask"].sum()))
                    for s in ("query", "passage")))
            return batch

        RetrievalTrainer.init_state = recorded_init
        if self.fail_at is not None:
            RetrievalTrainer.train = failing_train
        RetrievalCollator.__call__ = recorded_collate
        return self

    def __exit__(self, *exc):
        from repro_torch.core.collator import RetrievalCollator
        from repro_torch.training.trainer import RetrievalTrainer
        (RetrievalTrainer.init_state, RetrievalTrainer.train,
         RetrievalCollator.__call__) = self._orig


# Training steps traced by torch.profiler after the last phase, as
# PROFILED is (its CUDA tracing may cost every later launch): callables.
STEP_TRACES = []
L_TRACE_STEPS = 5


def trace_steps(trainer, state, batch, card: str) -> None:
    """L_TRACE_STEPS more training steps on a copy of (l1)'s state, under
    torch.profiler's CUDA activity: the step's synchronised wall ms
    against the device's busy ms (kernels, copies and fills summed), so
    the idle share; kernels and host-to-device copies a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trainer._step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(L_TRACE_STEPS):
            trainer._step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / L_TRACE_STEPS * 1e3
    busy = kernels = htod = 0
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        busy += e.self_device_time_total
        if "HtoD" in e.key:
            htod += e.count
        elif not e.key.startswith(("Memcpy", "Memset")):
            kernels += e.count
    if busy <= 0:
        print(f"[l] (l1) traced step on {card}: {wall:.3f} ms, device "
              f"time not measured (the profiler recorded none)")
        return
    busy_ms = busy / L_TRACE_STEPS / 1e3
    print(f"[l] (l1) traced step (torch.profiler, {L_TRACE_STEPS} steps) on "
          f"{card}: {wall:.3f} ms wall, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall:.3f}); "
          f"{kernels / L_TRACE_STEPS:.0f} kernels and "
          f"{htod / L_TRACE_STEPS:.0f} host-to-device copies a step")


@contextlib.contextmanager
def remat_off(off: bool = True):
    """trove-base's full config with ``remat=False`` while it lasts (the
    launchers read it through ``trove_base.get_config``), if ``off``."""
    import dataclasses

    from repro_torch.configs import trove_base
    full = trove_base.get_config
    if off:
        trove_base.get_config = lambda: dataclasses.replace(full(),
                                                            remat=False)
    try:
        yield
    finally:
        trove_base.get_config = full


def no_launches(_) -> dict:
    """The training paths run no kernel: every count stays 0."""
    return {"fused_score_topk": 0, "topk_update": 0, "embedding_bag": 0,
            "embedding_bag_backward": 0}


def train_argv(data_dir: str, out_dir: str, dev) -> list:
    return ["--data-dir", data_dir, "--output_dir", out_dir, "--device",
            dev.type, "--max_steps", str(L_STEPS), "--per_device_batch_size",
            str(L_BATCH), "--group_size", str(L_GROUP), "--query_max_len",
            str(L_QLEN), "--passage_max_len", str(L_PLEN),
            "--checkpoint_every", str(L_EVERY), "--async_checkpoint", "true",
            "--log_every", "1", "--learning_rate", str(L_LR)]


def same_params(name: str, got, want) -> None:
    import torch

    from repro_torch.training.tree import flatten
    for (key, a), (_, b) in zip(flatten(got), flatten(want)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"{name}: params/{key} differs")


def max_param_diff(got, want) -> float:
    from repro_torch.training.tree import flatten
    return max(float((a.float() - b.float()).abs().max())
               for (_, a), (_, b) in zip(flatten(got), flatten(want)))


def check_checkpoints(ckpt_dir: str, state) -> str:
    """(l1)'s checkpoints in the reference's layout: the kept step
    directories, each with its manifest and npz, every leaf of the state
    under its ``/``-joined path, and the last one's parameters decoded
    straight from the npz bit for bit (bf16 as raw uint16 words)."""
    import numpy as np
    import torch

    from repro_torch.training.tree import flatten

    want_dirs = [f"step_{s:08d}" for s in (L_EVERY, L_STEPS)]
    if sorted(os.listdir(ckpt_dir)) != want_dirs:
        fail(f"(l1) checkpoints {sorted(os.listdir(ckpt_dir))}, expected "
             f"{want_dirs}")
    keys = {k for k, _ in flatten(state)}
    for d in want_dirs:
        if sorted(os.listdir(os.path.join(ckpt_dir, d))) != [
                "arrays.npz", "manifest.json"]:
            fail(f"(l1) {d}: {os.listdir(os.path.join(ckpt_dir, d))}")
        with open(os.path.join(ckpt_dir, d, "manifest.json")) as f:
            manifest = json.load(f)
        if set(manifest["leaves"]) != keys:
            fail(f"(l1) {d}: leaves {sorted(manifest['leaves'])[:6]}...")
    leaves = manifest["leaves"]
    n_bf16 = 0
    with np.load(os.path.join(ckpt_dir, want_dirs[-1], "arrays.npz")) as z:
        for key, t in flatten(state["params"]):
            key = f"params/{key}"
            arr = z[key]
            if t.dtype == torch.bfloat16:
                n_bf16 += 1
                if leaves[key]["dtype"] != "bfloat16" or arr.dtype.str != \
                        "|V2":
                    fail(f"(l1) {key}: stored {arr.dtype.str}, manifest "
                         f"{leaves[key]['dtype']}")
                bits = t.detach().cpu().view(torch.int16).numpy()
                same = np.array_equal(arr.view(np.uint16),
                                      bits.view(np.uint16))
            else:
                same = np.array_equal(arr, t.detach().cpu().numpy())
            if not same:
                fail(f"(l1) {key}: the npz differs from the final params")
        if int(z["step"]) != L_STEPS:
            fail(f"(l1) the last checkpoint's step leaf {z['step']}")
    return (f"{', '.join(want_dirs)} in the reference's layout "
            f"({len(keys)} leaves), {n_bf16} bf16 param leaves decoded "
            f"bit-exact from the npz")


def load_dataset(data_dir: str):
    """(queries, corpus, qrels) dicts of the launcher's data files."""
    queries, corpus, qrels = {}, {}, {}
    for name, out in (("queries.jsonl", queries), ("corpus.jsonl", corpus)):
        with open(os.path.join(data_dir, name)) as f:
            for line in f:
                rec = json.loads(line)
                out[rec["_id"]] = rec["text"]
    with open(os.path.join(data_dir, "qrels", "train.tsv")) as f:
        for line in f:
            q, d, s = line.rstrip("\n").split("\t")
            qrels.setdefault(q, {})[d] = float(s)
    return queries, corpus, qrels


def mined_triplets(path: str) -> dict:
    out: dict = {}
    with open(path) as f:
        for line in f:
            q, d, s = line.rstrip("\n").split("\t")
            out.setdefault(q, []).append((d, float(s)))
    return out


def check_mined(fused: str, torch_path: str) -> str:
    """The TSVs mined on (fused, kernel) and (torch, kernel): the same
    queries and per query the same number of lines; scores within TOL
    (K1 sums each score in another order than cuBLAS); documents equal
    wherever the (torch, kernel) score is more than TOL from its
    neighbours (a query's last line excepted: its neighbour past the
    depth is not in the file).  Returns the counts of byte-identical
    lines and of lines with the same document."""
    import numpy as np
    import torch

    a, b = mined_triplets(fused), mined_triplets(torch_path)
    if list(a) != list(b):
        fail("(l4) the two mined TSVs name other queries")
    lines = open(fused).read().splitlines()
    same = sum(x == y for x, y in zip(lines,
                                      open(torch_path).read().splitlines()))
    for q in a:
        if len(a[q]) != len(b[q]):
            fail(f"(l4) query {q}: {len(a[q])} vs {len(b[q])} negatives")
        va = np.array([s for _, s in a[q]], np.float32)
        vb = np.array([s for _, s in b[q]], np.float32)
        if np.abs(va - vb).max() > TOL:
            fail(f"(l4) query {q}: scores differ by "
                 f"{np.abs(va - vb).max()}")
        sep = separated(torch.from_numpy(vb[None]))[0].numpy()
        # the last line's lower neighbour is the first candidate past the
        # depth, which neither file shows: a near-tie there may swap it
        sep[-1] = False
        da = np.array([d for d, _ in a[q]])[sep]
        db = np.array([d for d, _ in b[q]])[sep]
        if not np.array_equal(da, db):
            fail(f"(l4) query {q}: documents differ where separated: "
                 f"fused {a[q]}, torch {b[q]}")
    same_doc = sum(x[0] == y[0] for q in a for x, y in zip(a[q], b[q]))
    return (f"{same_doc} of {len(lines)} lines the same document, {same} "
            f"byte-identical")


def phase_training(dev, card: str) -> dict:
    """(l): (l1) ``launch/train.py`` at trove-base's full width, (l2) the
    same run with an injected failure against an uninterrupted one under
    deterministic algorithms, (l3) ``serve.main --ckpt-dir`` on (l1)'s
    checkpoint, (l4) the paper's round trip: mine on K1 and K2, retrain
    on the mined negatives from (l1)'s checkpoint, evaluate."""
    import contextlib
    import functools
    import io
    import shutil

    import numpy as np
    import torch

    from repro_torch.core import sharded_search
    from repro_torch.core.collator import RetrievalCollator
    from repro_torch.core.config import (DataArguments, MaterializedQRelConfig,
                                         RetrievalTrainingArguments)
    from repro_torch.core.datasets import BinaryDataset
    from repro_torch.data.synthetic import make_retrieval_dataset
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.launch import serve, train
    from repro_torch.models.encoder import DefaultEncoder
    from repro_torch.models.retriever import BiEncoderRetriever
    from repro_torch.training import checkpoint
    from repro_torch.training.trainer import RetrievalTrainer
    from repro_torch.training.tree import flatten, tree_map

    paths: dict = {}
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        queries, corpus, qrels = make_retrieval_dataset(data_dir, **L_DATA)
        out1 = os.path.join(tmp, "l1")

        # (l1) the launcher at full width
        log = TrainLog()
        out = io.StringIO()
        if cuda:
            torch.empty(0, device=dev)        # the allocator exists
            torch.cuda.reset_peak_memory_stats(dev)

        def run_l1():
            with contextlib.redirect_stdout(out), log:
                return train.main(train_argv(data_dir, out1, dev))

        t0 = time.perf_counter()
        trainer, state = on_path(paths, "(l1) launch.train", None, run_l1,
                                 no_launches)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        cfg = trainer.retriever.encoder.cfg
        n_params = sum(t.numel() for t in state["params"]["blocks"].values()
                       ) + sum(t.numel() for n, t in state["params"].items()
                               if n != "blocks")
        logs = trainer.logs
        if [r["step"] for r in logs] != list(range(L_STEPS)) or not all(
                np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                for r in logs):
            fail(f"(l1) logs {[(r['step'], r['loss']) for r in logs]}")
        if int(state["step"]) != L_STEPS or not logs[-1]["loss"] < \
                logs[0]["loss"]:
            fail(f"(l1) ended at step {int(state['step'])}, loss "
                 f"{logs[0]['loss']} -> {logs[-1]['loss']}")
        # every weight matrix must move; a norm scale at 1.0 may not: in
        # bf16 (no float32 master copy, as in the reference) an update
        # below half its ulp (2^-9) rounds back to 1.0
        unchanged = [k for k, t in flatten(state["params"])
                     if torch.equal(t, dict(flatten(log.initial))[k])]
        if any(not k.split("/")[-1].startswith(("ln", "final_ln"))
               for k in unchanged):
            fail(f"(l1) params unchanged by training: {unchanged}")
        held = check_checkpoints(os.path.join(out1, "checkpoints"), state)
        times = trainer.step_ms()
        med = {p: statistics.median(t[p] for t in times)
               for p in ("total", "forward", "backward", "update")}
        toks = log.tokens[:L_STEPS]
        padded = statistics.median(q[0] + p[0] for q, p in toks)
        real = statistics.median(q[1] + p[1] for q, p in toks)
        print(f"[l] (l1) launch.train {cfg.name} {cfg.n_layers} x "
              f"{cfg.d_model}, {n_params / 1e6:.1f} M params, {cfg.dtype}, "
              f"{L_STEPS} steps of {L_BATCH} queries x {L_GROUP} passages "
              f"({L_QLEN} / {L_PLEN} tokens at most) on {card}: "
              f"{wall:.2f} s of launcher")
        print(f"[l] (l1) step ms (median of {len(times)}, "
              f"{'CUDA events' if cuda else 'host clock'}): "
              f"{med['total']:.3f} = forward {med['forward']:.3f} + "
              f"backward {med['backward']:.3f} + clip + optimizer "
              f"{med['update']:.3f}; first step {times[0]['total']:.3f}; "
              f"{padded:.0f} padded ({real:.0f} real) query + passage "
              f"tokens a step: {padded / med['total'] * 1e3:.0f} padded "
              f"({real / med['total'] * 1e3:.0f} real) tokens/s; peak "
              f"memory {peak / 2**30:.3f} GiB")
        if cuda:
            traced = {k: v for k, v in state.items() if k != "rng"}
            STEP_TRACES.append(functools.partial(
                trace_steps, trainer,
                tree_map(lambda t: t.clone(), traced),
                next(trainer._batches(0)), card))
        print(f"[l] (l1) loss {logs[0]['loss']:.4f} -> {logs[-1]['loss']:.4f}"
              f" (falling), grad_norm {logs[0]['grad_norm']:.3f} -> "
              f"{logs[-1]['grad_norm']:.3f}, every logged loss "
              f"and grad_norm finite, every weight matrix changed, "
              f"{len(unchanged)} norm leaves bitwise unchanged "
              f"{unchanged}; {held}")

        # (l2) an injected failure resumed, and the run without remat, all
        # deterministic
        runs, peaks = {}, {}
        torch.use_deterministic_algorithms(True)
        try:
            for name, fail_at in (("whole", None), ("resumed", L_FAIL_AT),
                                  ("without remat", None)):
                rlog = TrainLog(fail_at)
                if cuda:
                    torch.cuda.reset_peak_memory_stats(dev)

                def run_l2(rlog=rlog, name=name):
                    with contextlib.redirect_stdout(io.StringIO()), rlog, \
                            remat_off(name == "without remat"):
                        return train.main(train_argv(
                            data_dir, os.path.join(tmp, f"l2-{name}"), dev))

                runs[name] = on_path(paths, f"(l2) launch.train {name}",
                                     None, run_l2, no_launches)
                peaks[name] = gib(torch.cuda.max_memory_allocated(dev)
                                  if cuda else 0)
        finally:
            torch.use_deterministic_algorithms(False)
        (_, whole), (resumed_tr, resumed) = runs["whole"], runs["resumed"]
        norem_tr, norem = runs["without remat"]
        if norem_tr.retriever.encoder.cfg.remat or not \
                trainer.retriever.encoder.cfg.remat:
            fail("(l2) remat is not on in (l1) and off in the run without")
        same_params("(l2) remat on vs off", whole["params"], norem["params"])
        whole_ms, norem_ms = (statistics.median(t["total"] for t in
                                                tr.step_ms())
                              for tr in (runs["whole"][0], norem_tr))
        steps = [r["step"] for r in resumed_tr.logs]
        want_steps = list(range(L_FAIL_AT)) + list(range(L_EVERY + 1,
                                                         L_STEPS))
        if steps != want_steps:
            fail(f"(l2) logged steps {steps}, expected {want_steps}")
        same_params("(l2) resumed vs uninterrupted", resumed["params"],
                    whole["params"])
        print(f"[l] (l2) failure injected at step {L_FAIL_AT}, step_"
              f"{L_EVERY:08d} restored, steps {L_EVERY + 1}-{L_STEPS - 1} "
              f"rerun: final params bitwise equal to an uninterrupted run "
              f"(both under torch.use_deterministic_algorithms); the "
              f"deterministic run vs (l1)'s max abs param difference "
              f"{max_param_diff(whole['params'], state['params']):.3g}")
        print(f"[l] (l2) the same deterministic run without remat: final "
              f"params bitwise equal to the run with it (each layer "
              f"checkpointed); its step median {norem_ms:.3f} ms against "
              f"{whole_ms:.3f} with remat (the trainer's step_ms), peak "
              f"{peaks['without remat']:.3f} GiB against "
              f"{peaks['whole']:.3f}")
        del runs, whole, resumed, resumed_tr, norem, norem_tr

        # (l3) serve.main --ckpt-dir on (l1)'s checkpoint
        for q in (1, 2, 4, 8, 16, 32):
            sharded_search.autotune_superchunk_size(
                q, cfg.d_model, C, K, "fused", "kernel", dev.type)
        restored = []
        restore = checkpoint.restore_checkpoint

        def recording(path, template):
            restored.append(restore(path, template))
            return restored[-1]

        served = ServedLog()
        sout = io.StringIO()

        def run_l3():
            checkpoint.restore_checkpoint = recording
            try:
                with contextlib.redirect_stdout(sout), served:
                    return serve.main([
                        "--data-dir", data_dir, "--device", dev.type,
                        "--ckpt-dir", os.path.join(out1, "checkpoints"),
                        "--topk", str(K), "--n-requests", str(L_REQUESTS),
                        "--batch", str(L_REQ_Q), "--max-batch",
                        str(L_REQ_Q), "--workers", "1"])
            finally:
                checkpoint.restore_checkpoint = restore

        try:
            stats = serving_path(paths, "(l3) serve.main --ckpt-dir (fused, "
                                 "kernel)", run_l3)
            if len(restored) != 1:
                fail(f"(l3) {len(restored)} restores")
            same_params("(l3) restored vs trained", restored[0]["params"],
                        state["params"])
            held = check_served("(l3) serve.main --ckpt-dir", served,
                                list(corpus), L_REQUESTS)
        finally:
            served.close()
        print(f"[l] (l3) serve.main --ckpt-dir on {card}: restored params "
              f"bitwise equal to the trainer's; {L_REQUESTS} requests of "
              f"{L_REQ_Q} queries p50 {stats['p50_ms']:.3f} ms; {held}")

        # (l4) mine on K1 and K2, retrain on the mined negatives, evaluate
        retriever = trainer.retriever
        collator = RetrievalCollator(
            DataArguments(vocab_size=cfg.vocab_size, group_size=L_GROUP,
                          query_max_len=L_QLEN, passage_max_len=L_PLEN),
            HashTokenizer(cfg.vocab_size))
        trove = {"retriever": retriever, "collator": collator,
                 "params": state["params"]}
        mined = {}
        for score, heap in (("fused", "kernel"), ("torch", "kernel")):
            ev = trove_evaluator(dev, trove, score, heap)
            path = os.path.join(tmp, f"mined-{score}.tsv")
            mined[score] = path
            negs = on_path(
                paths, f"(l4) mine_hard_negatives ({score}, {heap})",
                path_kernel(score, heap),
                lambda ev=ev, path=path: ev.mine_hard_negatives(
                    queries, corpus, qrels, depth=L_DEPTH,
                    output_path=path),
                lambda _, ev=ev, score=score, heap=heap: predicted(
                    ev, score, heap))
            if not negs:
                fail(f"(l4) ({score}, {heap}) mined nothing")
        held = check_mined(mined["fused"], mined["torch"])
        print(f"[l] (l4) mine_hard_negatives depth {L_DEPTH} on (fused, "
              f"kernel) and (torch, kernel): {len(negs)} triplets each, "
              f"scores within {TOL}, documents equal where separated; "
              f"{held}")

        out4 = os.path.join(tmp, "l4")
        os.makedirs(os.path.join(out4, "checkpoints"))
        shutil.copytree(os.path.join(out1, "checkpoints",
                                     f"step_{L_STEPS:08d}"),
                        os.path.join(out4, "checkpoints",
                                     f"step_{L_STEPS:08d}"))
        paths_cfg = dict(query_path=os.path.join(data_dir, "queries.jsonl"),
                         corpus_path=os.path.join(data_dir, "corpus.jsonl"))
        dataset = BinaryDataset(
            collator.args, retriever.format_query, retriever.format_passage,
            MaterializedQRelConfig(
                min_score=1, qrel_path=os.path.join(data_dir, "qrels",
                                                    "train.tsv"), **paths_cfg),
            MaterializedQRelConfig(group_random_k=2,
                                   qrel_path=mined["fused"], **paths_cfg),
            cache_root=os.path.join(tmp, "cache"))
        retrainer = RetrievalTrainer(
            retriever, RetrievalTrainingArguments(
                output_dir=out4, max_steps=L_RETRAIN, learning_rate=L_LR,
                per_device_batch_size=L_BATCH, checkpoint_every=L_EVERY,
                log_every=1), collator, dataset, device=dev)
        state4 = on_path(paths, "(l4) retrain on mined negatives", None,
                         retrainer.train, no_launches)
        steps = [r["step"] for r in retrainer.logs]
        if steps != list(range(L_STEPS, L_RETRAIN)) or int(
                state4["step"]) != L_RETRAIN or not all(
                np.isfinite(r["loss"]) for r in retrainer.logs):
            fail(f"(l4) retrain logged {steps}, step {int(state4['step'])}")
        metrics = {}
        for name, params in (("seeded", log.initial),
                             ("trained", state["params"]),
                             ("retrained", state4["params"])):
            ev = trove_evaluator(dev, {**trove, "params": params})
            metrics[name] = on_path(
                paths, f"(l4) evaluate {name} (fused, kernel)",
                "fused_score_topk",
                lambda ev=ev: ev.evaluate(queries, corpus, qrels),
                lambda _, ev=ev: predicted(ev, "fused", "kernel"))
            if not all(0.0 <= m <= 1.0 for m in metrics[name].values()):
                fail(f"(l4) {name} metrics {metrics[name]}")
        print(f"[l] (l4) retrained steps {L_STEPS}-{L_RETRAIN - 1} from "
              f"(l1)'s step_{L_STEPS:08d} on the mined negatives: loss "
              f"{retrainer.logs[0]['loss']:.4f} -> "
              f"{retrainer.logs[-1]['loss']:.4f}; evaluate (fused, kernel) "
              f"seeded {rounded(metrics['seeded'])}, trained "
              f"{rounded(metrics['trained'])}, retrained "
              f"{rounded(metrics['retrained'])}")
        del trainer, state, retrainer, state4, trove
    if cuda:
        torch.cuda.empty_cache()
    print(f"[l] phase (l): {time.perf_counter() - t_phase:.1f} s")
    return paths


# -- (f) recsys scoring at full width -----------------------------------------

# (arch, shapes run): AutoInt's and BST's bulk / retrieval attention
# tensors alone are 12-28 GB and run no kernel, so they run serve_p99 only
RECSYS_PLAN = (("deepfm", ("serve_p99", "serve_bulk", "retrieval_cand")),
               ("wide-deep", ("serve_p99", "retrieval_cand")),
               ("autoint", ("serve_p99",)), ("bst", ("serve_p99",)))
# K4 launches per forward: DeepFM's linear term and FM sum, Wide&Deep's
# wide term; AutoInt and BST gather only
BAGS_PER_FORWARD = {"deepfm": 2, "wide_deep": 1, "autoint": 0, "bst": 0}


def deepfm_logits_f64(params, idx, n_mlp):
    """DeepFM's logits in float64 on the host, from the parameter rows
    the ids touch (the reference formula, summed in another precision)."""
    import torch
    emb = params["table"][idx].double().cpu()              # (B, F, D)
    lin = params["linear_table"][idx][..., 0].double().cpu().sum(-1)
    sum_v = emb.sum(1)
    fm = 0.5 * ((sum_v * sum_v) - (emb * emb).sum(1)).sum(-1)
    x = emb.reshape(emb.shape[0], -1)
    for i in range(n_mlp):
        x = x @ params[f"mlp_w{i}"].double().cpu() + params[
            f"mlp_b{i}"].double().cpu()
        if i < n_mlp - 1:
            x = torch.relu(x)
    return lin + fm + x[:, 0] + params["bias"].double().cpu()[0]


def timed(fn) -> float:
    """Host-clock ms of ``fn`` ending in a synchronize."""
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_recsys(dev, card: str) -> dict:
    """(f) the recsys serve and retrieval cells at full published width,
    seeded random weights drawn on the card; returns each path's launch
    counts."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import recsys

    paths: dict = {}
    for name, shapes in RECSYS_PLAN:
        arch = get_arch(name)
        cfg = arch.cfg
        torch.cuda.reset_peak_memory_stats()
        params = {}
        t_init = timed(lambda: params.update(recsys.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)))
        n_params = sum(p.numel() for p in params.values())
        print(f"[f] {name}: {cfg.n_fields} fields, table "
              f"{cfg.total_vocab} x {cfg.embed_dim}, {n_params / 1e6:.1f} M "
              f"params {str(cfg.dtype)[6:]}, drawn on the card in "
              f"{t_init:.1f} ms")
        bags = BAGS_PER_FORWARD[cfg.kind]
        rng = np.random.default_rng(SEED)
        for shape in shapes:
            spec = arch.shapes[shape]
            cell = arch.build_cell(shape, dev)
            batch = arch.smoke_inputs(shape, rng, dev)
            retrieval = spec["kind"] == "retrieval"
            want = {"fused_score_topk": 0, "topk_update": int(retrieval),
                    "embedding_bag": bags, "embedding_bag_backward": 0}
            kernel = "topk_update" if retrieval else (
                "embedding_bag" if bags else None)
            path = f"recsys {name} {shape}"

            def run(cell=cell, batch=batch):
                out = cell.fn(params, batch)
                torch.cuda.synchronize()
                return out

            out = on_path(paths, path, kernel, run, lambda _, w=want: w)
            if retrieval:
                check_retrieval(path, cfg, params, batch, out, spec["topk"])
                lat = [timed(lambda: run()) for _ in range(3)]
                print(f"[f] {path} latency ms on {card}: "
                      f"{json.dumps([round(x, 3) for x in lat])} (median "
                      f"{statistics.median(lat):.3f}; 1 user x "
                      f"{spec['n_candidates']} candidates, top-"
                      f"{spec['topk']})")
                continue
            b = spec["batch"]
            if out.shape != (b,) or not bool(((out > 0) & (out < 1)).all()):
                fail(f"{path}: probabilities not in (0, 1) / shape "
                     f"{tuple(out.shape)}")
            if cfg.kind == "deepfm" and shape == "serve_p99":
                idx = batch["sparse_idx"][:8]
                want64 = deepfm_logits_f64(params, idx.long(),
                                           len(cfg.mlp_dims) + 1)
                got = recsys.forward(cfg, params, batch)[:8].double().cpu()
                err = float((got - want64).abs().max())
                perr = float((out[:8].double().cpu()
                              - torch.sigmoid(want64)).abs().max())
                if not (err <= 1e-4 and perr <= 1e-4):
                    fail(f"{path}: logits vs float64 error {err}, "
                         f"probabilities {perr} (atol 1e-4)")
                print(f"[f] {path}: 8 rows vs a float64 host recomputation: "
                      f"logit max abs error {err:.3g}, probability "
                      f"{perr:.3g} (atol 1e-4)")
            if shape == "serve_p99":
                batches = [arch.smoke_inputs(shape, rng, dev)
                           for _ in range(20)]
                lat = [timed(lambda bb=bb: cell.fn(params, bb))
                       for bb in batches]
                print(f"[f] {path} batch latency on {card}: median "
                      f"{statistics.median(lat):.3f} ms, p90 "
                      f"{sorted(lat)[17]:.3f} ms over 20 batches of {b} "
                      f"(max {max(lat):.3f})")
            else:
                lat = [timed(lambda: cell.fn(params, batch))
                       for _ in range(5)]
                med = statistics.median(lat)
                print(f"[f] {path} on {card}: median {med:.3f} ms per batch "
                      f"of {b}, {b / med * 1e3:.0f} examples/s")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        held = sum(p.numel() * p.element_size() for p in params.values())
        print(f"[f] {name}: peak device memory {peak:.2f} GiB (params "
              f"{held / 2 ** 30:.2f} GiB)")
        del params
        torch.cuda.empty_cache()
    return paths


def check_retrieval(path, cfg, params, batch, out, k) -> None:
    """The cell's top-k against an exact float64 top-k of the same
    scores: values within TOL, ids equal wherever neighbours are more
    than TOL apart."""
    import torch

    from repro_torch.models import recsys
    vals, ids = out
    if vals.shape != (k,) or ids.shape != (k,) or not bool(
            torch.isfinite(vals).all()):
        fail(f"{path}: bad top-k {tuple(vals.shape)} / {tuple(ids.shape)}")
    scores = recsys.retrieval_scores(cfg, params, batch).double()
    wv, wpos = torch.sort(scores, descending=True, stable=True)
    wv = wv[:k].float()[None]
    want_ids = batch["cand_idx"][wpos[:k]]
    err = float((vals[None] - wv).abs().max())
    sep = separated(wv)[0]
    if err > TOL or not torch.equal(ids[sep], want_ids[sep]):
        fail(f"{path}: top-k vs exact float64 top-k: error {err}")
    print(f"[f] {path}: top-{k} vs exact float64 top-k: max abs error "
          f"{err:.3g}, ids equal on all {int(sep.sum())} slots separated "
          f"by more than {TOL}")


# -- (m) recsys training at full width ----------------------------------------

# (m1) steps of each ranker's train_batch cell on one seeded batch; (m2)
# steps of each of two seeded runs held bitwise; (m3) examples whose
# gradients are held against a float64 recomputation; its tolerance, a
# share of the largest |gradient| of each tensor: float32 sums of <= 512
# terms carry ~1e-6 of it, and 1e-4 leaves two decades.
M_STEPS, M2_STEPS, M3_BATCH, M3_RTOL = 10, 3, 512, 1e-4
# (m3)'s AdamW step: the share of elements it may hold loosely (a
# gradient within 2 M3_RTOL of its tensor's largest, not 0), so that a
# sign flipped or a row missed cannot hide there
M3_LOOSE = 0.1
# AdamW as the train_batch cell runs it: make_train_cell's learning rate
# and the reference OptimizerConfig's defaults (repro/training/
# optimizer.py), restated here for (m3)'s host step
ADAM_LR, ADAM_WD, ADAM_EPS, ADAM_CLIP = 1e-3, 0.01, 1e-8, 1.0
M2_ARCHS = ("deepfm", "wide-deep")


def bag_launches(kind: str, forwards: int, backwards: int) -> dict:
    """Each kernel's launches on a recsys training path: K4 per forward and
    K4T per backward, BAGS_PER_FORWARD times each; K1 and K2 never."""
    bags = BAGS_PER_FORWARD[kind]
    return {"fused_score_topk": 0, "topk_update": 0,
            "embedding_bag": bags * forwards,
            "embedding_bag_backward": bags * backwards}


class StepMarks:
    """CUDA events inside a train cell's step, recorded by wrapping
    ``forward`` (an (owner, attribute) pair, ``recsys.forward`` unless
    given; its end) and ``configs.base.clip_by_global_norm`` (its start),
    so a step splits into forward, backward and clip + optimizer without
    a change to the cell."""

    def __init__(self, forward=None):
        from repro_torch.configs import base
        if forward is None:
            from repro_torch.models import recsys
            forward = (recsys, "forward")
        self.marks: list = []
        self.splits: list = []          # per step: its four events
        self._saved = [forward, (base, "clip_by_global_norm")]
        self._orig = [getattr(m, n) for m, n in self._saved]

    def _mark(self):
        import torch
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.marks.append(e)

    def __enter__(self):
        fwd, clip = self._orig

        def forward(*a, **kw):
            out = fwd(*a, **kw)
            self._mark()
            return out

        def clip_by_global_norm(*a, **kw):
            self._mark()
            return clip(*a, **kw)

        for (mod, name), fn in zip(self._saved, (forward,
                                                 clip_by_global_norm)):
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self._saved, self._orig):
            setattr(mod, name, fn)

    def step(self, fn):
        """Run ``fn`` (one step) between a start and an end event; returns
        its output."""
        self.marks = []
        self._mark()
        out = fn()
        self._mark()
        self.splits.append(self.marks)
        return out


def train_steps(cell, state, batch, steps: int, marks=None) -> list:
    """``steps`` steps of ``cell`` on one batch; each step's metrics."""
    metrics = []
    for _ in range(steps):
        if marks is None:
            state, m = cell.fn(state, batch)
        else:
            state, m = marks.step(lambda: cell.fn(state, batch))
        metrics.append(m)
    return metrics


def train_state(arch, dev):
    import torch

    from repro_torch.configs.base import init_train_state
    from repro_torch.models import recsys
    params = recsys.init_params(
        arch.cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    cell = arch.build_cell(TRAIN_SHAPE, dev)
    return cell, init_train_state(cell, params)


def phase_recsys_training(dev, card: str) -> dict:
    """(m) the recsys train_batch cell at full published width, seeded
    random weights drawn on the card; returns each path's launch
    counts."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch

    paths: dict = {}
    t_phase = time.perf_counter()
    for name in ("deepfm", "wide-deep", "autoint", "bst"):
        arch = get_arch(name)
        cfg = arch.cfg
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cell, state = train_state(arch, dev)
        batch = arch.smoke_inputs(TRAIN_SHAPE, np.random.default_rng(SEED),
                                  dev)
        b = batch["labels"].shape[0]
        held = sum(p.numel() * p.element_size()
                   for p in state["params"].values())
        marks = StepMarks()
        bags = BAGS_PER_FORWARD[cfg.kind]

        def run(cell=cell, state=state, batch=batch, marks=marks):
            with marks:
                out = train_steps(cell, state, batch, M_STEPS, marks)
            torch.cuda.synchronize()
            return out

        path = f"(m1) recsys train {name} {TRAIN_SHAPE} x {M_STEPS}"
        metrics = on_path(paths, path,
                          "embedding_bag_backward" if bags else None, run,
                          lambda _, k=cfg.kind: bag_launches(k, M_STEPS,
                                                             M_STEPS))
        loss = [float(m["loss"]) for m in metrics]
        gnorm = [float(m["grad_norm"]) for m in metrics]
        if not (np.isfinite(loss).all() and np.isfinite(gnorm).all()):
            fail(f"{path}: loss {loss} / grad_norm {gnorm} not finite")
        # a smoke check, not evidence that the update is right ((m3) holds
        # one step against a host AdamW): AdamW's first steps at the
        # cell's fixed rate (1e-3) move every weight by about the rate and
        # may overshoot, so the loss must come back below its start within
        # the run's second half
        if not min(loss[M_STEPS // 2:]) < loss[0]:
            fail(f"{path}: the loss did not fall on the repeated batch: "
                 f"{loss}")
        split = {"forward": [], "backward": [], "update": [], "total": []}
        for s0, f, c, s1 in marks.splits:
            split["forward"].append(s0.elapsed_time(f))
            split["backward"].append(f.elapsed_time(c))
            split["update"].append(c.elapsed_time(s1))
            split["total"].append(s0.elapsed_time(s1))
        med = {k: statistics.median(v) for k, v in split.items()}
        peak = torch.cuda.max_memory_allocated()
        print(f"[m] (m1) {name} {TRAIN_SHAPE} B={b} on {card}: losses "
              f"{[round(x, 6) for x in loss]} over {M_STEPS} steps on one "
              f"batch (lowest of the second half "
              f"{min(loss[M_STEPS // 2:]):.6f} < first {loss[0]:.6f}), "
              f"grad_norms "
              f"{[round(x, 6) for x in gnorm]}, all finite")
        print(f"[m] (m1) {name} step median {med['total']:.3f} ms (CUDA "
              f"events; forward {med['forward']:.3f} + loss and backward "
              f"{med['backward']:.3f} + clip and AdamW {med['update']:.3f}), "
              f"steps ms {[round(x, 3) for x in split['total']]}, "
              f"{b / med['total'] * 1e3:.0f} examples/s, peak device memory "
              f"{peak / 2 ** 30:.2f} GiB against params "
              f"{held / 2 ** 30:.2f} GiB")
        del state["opt"]                   # (m3) and (m4) need the params
        torch.cuda.empty_cache()
        if bags:
            recsys_grad_check(dev, arch, state["params"], paths)
        if cfg.kind == "deepfm":
            serve_trained(dev, arch, state["params"], paths)
        del cell, state, batch, marks, metrics
    recsys_deterministic(dev, paths)
    torch.cuda.empty_cache()
    print(f"[m] phase (m): {time.perf_counter() - t_phase:.1f} s")
    return paths


def recsys_grad_check(dev, arch, params, paths: dict) -> None:
    """(m3) the gradients of DeepFM's (or Wide&Deep's) loss on M3_BATCH
    examples at full width — ``table`` and the bag table
    (``linear_table`` / ``wide_table``, through K4T alone) on the rows
    the batch touches, and ``mlp_w0`` — against the reference's formula
    (repro/models/recsys.py:238-248) recomputed on the host in float64
    from the same parameter rows."""
    import numpy as np
    import torch

    from repro_torch.models import recsys
    from repro_torch.models.losses import BCELoss
    cfg = arch.cfg
    rng = np.random.default_rng(SEED + 3)
    batch = arch.smoke_inputs("serve_p99", rng, dev)
    idx = batch["sparse_idx"][:M3_BATCH]
    labels = torch.from_numpy(
        rng.integers(0, 2, idx.shape[0]).astype(np.float32)).to(dev)
    deepfm = cfg.kind == "deepfm"
    bag_table = "linear_table" if deepfm else "wide_table"
    names = ("table", bag_table, "mlp_w0")

    def grads():
        leaves = {k: p.detach().requires_grad_(k in names)
                  for k, p in params.items()}
        loss = BCELoss()(recsys.forward(cfg, leaves, {"sparse_idx": idx}),
                         labels)
        out = torch.autograd.grad(loss, [leaves[k] for k in names])
        torch.cuda.synchronize()
        return out

    got = on_path(paths, f"(m3) {arch.name} gradients B={idx.shape[0]}",
                  "embedding_bag_backward", grads,
                  lambda _: bag_launches(cfg.kind, 1, 1))
    rows, inv = torch.unique(idx.long(), return_inverse=True)
    host = {k: params[k][rows] for k in names[:2]}
    host.update({k: p for k, p in params.items() if k not in names[:2]})
    host = {k: p.detach().double().cpu().requires_grad_(True)
            for k, p in host.items()}
    inv, y = inv.cpu(), labels.double().cpu()
    emb = host["table"][inv]                               # (B, F, D)
    lin = host[bag_table][inv][..., 0].sum(-1)
    fm = 0.0
    if deepfm:
        sum_v = emb.sum(1)
        fm = 0.5 * ((sum_v * sum_v) - (emb * emb).sum(1)).sum(-1)
    x = emb.reshape(emb.shape[0], -1)
    n_mlp = len(cfg.mlp_dims) + 1
    for i in range(n_mlp):
        x = x @ host[f"mlp_w{i}"] + host[f"mlp_b{i}"]
        if i < n_mlp - 1:
            x = torch.relu(x)
    logits = lin + fm + x[:, 0] + host["bias"][0]
    loss = (torch.clamp_min(logits, 0) - logits * y
            + torch.log1p(torch.exp(-logits.abs()))).mean()
    loss.backward()
    report = []
    for name, g in zip(names, got):
        want = host[name].grad
        g = g[rows] if name != "mlp_w0" else g
        err = float((g.double().cpu() - want).abs().max())
        scale = float(want.abs().max())
        if not (scale > 0 and err <= M3_RTOL * scale):
            fail(f"(m3) d{name}: max abs error {err} against a largest "
                 f"|gradient| of {scale} (tolerance {M3_RTOL} of it)")
        report.append(f"d{name} {err:.3g} of {scale:.3g}")
    # rows no id touches get no gradient
    for name, g in zip(names[:2], got[:2]):
        live = int(g.abs().sum(1).count_nonzero())
        if live > rows.numel():
            fail(f"(m3) d{name}: {live} rows nonzero, {rows.numel()} "
                 f"touched")
    print(f"[m] (m3) {arch.name} full width, {idx.shape[0]} examples, "
          f"{rows.numel()} rows touched: gradients against a float64 host "
          f"recomputation of the reference formula, max abs error "
          f"{'; '.join(report)} (tolerance {M3_RTOL} of the largest "
          f"|gradient|); no untouched row nonzero")
    recsys_update_check(dev, arch, params,
                        {"sparse_idx": idx, "labels": labels}, host, rows,
                        names[:2], paths)


def recsys_update_check(dev, arch, params, batch, host, rows, tables,
                        paths: dict) -> None:
    """(m3) one step of the train_batch cell on the same examples, from a
    fresh AdamW state on a copy of ``params``, against AdamW's first step
    (repro/training/optimizer.py adamw_update after clip_by_global_norm)
    computed on the host in float64 from (m3)'s float64 gradients
    ``host[k].grad``: every element of the dense parameters and of the
    ``tables``' touched rows, and on the card every untouched row, which
    weight decay alone moves.

    AdamW's first step moves an element by lr (g / (|g| + eps) + wd p)
    with g clipped (its moments are g and g g once bias-corrected), so
    about lr sign(g): a sign flipped or a row missed is off by lr or 2 lr.
    An element whose host gradient exceeds twice (m3)'s gradient
    tolerance delta (M3_RTOL of its tensor's largest |gradient|) is held
    to lr times 2 eps delta / (|g| + eps)^2, how far delta can move g /
    (|g| + eps), plus 1e-4 for float32's bias corrections (1 - 0.999
    rounds 1.3e-5 off) and moments; one whose host gradient is exactly 0
    (a unit no example activates) to that 1e-4, as weight decay alone
    moves it; any other (within 2 delta of 0) may take either sign and
    is held to 2 lr, and at most M3_LOOSE of the elements may be such.
    Each also gets 2^-22 |p| for the rounding of its float32 result.  An
    untouched row must be within 2^-21 |p| of p (1 - lr wd)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import init_train_state
    cfg = arch.cfg
    b = batch["labels"].shape[0]
    copy = {k: p.detach().clone() for k, p in params.items()}
    cell = arch.build_cell(TRAIN_SHAPE, dev)
    state = init_train_state(cell, copy)

    def run():
        out = cell.fn(state, batch)
        torch.cuda.synchronize()
        return out

    _, metrics = on_path(paths, f"(m3) {arch.name} one AdamW step B={b}",
                         "embedding_bag_backward", run,
                         lambda _: bag_launches(cfg.kind, 1, 1))
    del state, cell
    torch.cuda.empty_cache()
    lr = float(np.float32(ADAM_LR))         # schedule() gives a float32 rate
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in host.items()}
    gn = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
    scale = min(1.0, ADAM_CLIP / max(gn, 1e-9))
    card_gn = float(metrics["grad_norm"])
    if not abs(card_gn - gn) <= M3_RTOL * gn:
        fail(f"(m3) {arch.name} step: grad_norm {card_gn} against the "
             f"host's {gn}")
    n_all = n_clear = n_zero = 0
    worst = 0.0
    for k, p0 in host.items():
        p0 = p0.detach()
        g = grads[k] * scale
        delta = M3_RTOL * float(g.abs().max())
        want = p0 - lr * (g / (g.abs() + ADAM_EPS) + ADAM_WD * p0)
        got = (copy[k][rows] if k in tables else copy[k]).double().cpu()
        clear, zero = g.abs() > 2 * delta, g == 0
        tol_u = torch.where(
            clear, 2 * ADAM_EPS * delta / (g.abs() + ADAM_EPS) ** 2,
            torch.where(zero, 0.0, 2.0)) + 1e-4
        tol = lr * tol_u + 2.0 ** -22 * p0.abs()
        ratio = float(((got - want).abs() / tol).max())
        if not ratio <= 1.0:
            fail(f"(m3) {arch.name} step: {k} off the host AdamW step by "
                 f"{ratio:.3g} times its tolerance")
        worst = max(worst, ratio)
        n_all += g.numel()
        n_clear += int(clear.sum())
        n_zero += int(zero.sum())
    loose = n_all - n_clear - n_zero
    if loose > M3_LOOSE * n_all:
        fail(f"(m3) {arch.name} step: {loose} of {n_all} elements have a "
             f"gradient within 2 delta of 0 and not 0 (at most {M3_LOOSE} "
             f"of them)")
    untouched = 0
    for k in tables:
        p0, p1 = params[k], copy[k]
        off = (p1 - p0 * (1 - lr * ADAM_WD)).abs() > 2.0 ** -21 * p0.abs()
        off[rows] = False
        if bool(off.any()):
            fail(f"(m3) {arch.name} step: {int(off.any(1).sum())} untouched "
                 f"rows of {k} moved by more than weight decay")
        untouched += p0.shape[0] - rows.numel()
        del off
    del copy
    torch.cuda.empty_cache()
    print(f"[m] (m3) {arch.name} one AdamW step on the same {b} examples "
          f"against a float64 host step from the host gradients (grad_norm "
          f"{card_gn:.6g}, host {gn:.6g}, clip scale {scale:.6g}): "
          f"{n_all} elements (dense and touched rows): {n_clear} with a "
          f"gradient clear of 2 delta, {n_zero} with a gradient of 0, "
          f"{loose} held to 2 lr; the largest error "
          f"{worst:.3g} of its tolerance; {untouched} untouched rows of "
          f"{' and '.join(tables)} within 2^-21 |p| of p (1 - lr wd)")


def serve_trained(dev, arch, params, paths: dict) -> None:
    """(m4) the trained DeepFM through the serve_p99 cell."""
    import numpy as np
    import torch
    batch = arch.smoke_inputs("serve_p99", np.random.default_rng(SEED + 4),
                              dev)
    cell = arch.build_cell("serve_p99", dev)

    def run():
        out = cell.fn(params, batch)
        torch.cuda.synchronize()
        return out

    out = on_path(paths, "(m4) trained DeepFM serve_p99", "embedding_bag",
                  run, lambda _: bag_launches(arch.cfg.kind, 1, 0))
    b = arch.shapes["serve_p99"]["batch"]
    if out.shape != (b,) or not bool(((out > 0) & (out < 1)).all()):
        fail(f"(m4): probabilities not in (0, 1) / shape {tuple(out.shape)}")
    print(f"[m] (m4) trained DeepFM serve_p99: {b} probabilities in (0, 1), "
          f"mean {float(out.mean()):.6f}")


def recsys_deterministic(dev, paths: dict) -> None:
    """(m2) DeepFM and Wide&Deep: M2_STEPS steps twice from one seed
    under deterministic algorithms; the final parameters bitwise
    equal."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    torch.use_deterministic_algorithms(True)
    try:
        for name in M2_ARCHS:
            arch = get_arch(name)
            finals = []
            for run_no in (1, 2):
                torch.cuda.empty_cache()
                cell, state = train_state(arch, dev)
                batch = arch.smoke_inputs(
                    TRAIN_SHAPE, np.random.default_rng(SEED), dev)

                def run(cell=cell, state=state, batch=batch):
                    out = train_steps(cell, state, batch, M2_STEPS)
                    torch.cuda.synchronize()
                    return out

                on_path(paths, f"(m2) {name} deterministic run {run_no}",
                        "embedding_bag_backward", run,
                        lambda _, k=arch.cfg.kind: bag_launches(
                            k, M2_STEPS, M2_STEPS))
                finals.append(state["params"])
                del cell, state, batch
            differ = [k for k in finals[0]
                      if not torch.equal(finals[0][k], finals[1][k])]
            if differ:
                fail(f"(m2) {name}: parameters differ between two seeded "
                     f"runs: {differ}")
            print(f"[m] (m2) {name}: {M2_STEPS} steps twice from seed "
                  f"{SEED} under deterministic algorithms: all "
                  f"{len(finals[0])} parameters bitwise equal")
            del finals
    finally:
        torch.use_deterministic_algorithms(False)


# -- (n) the dense LM encoders at full width ---------------------------------

N_ARCHS = ("qwen2-0.5b", "stablelm-3b", "gemma-7b")
N_PAIRS = (("fused", "kernel"), ("torch", "kernel"), ("torch", "torch"))
# (n1): (c)'s recipe (Q queries, 64 topics, SEED) at a sixteenth of its
# corpus: the encodes are host-bound, and at 8192 docs (n1)'s 12 passes
# took 185 s of (n)'s 242 s; 4096 docs gave room to (o), 2048 to (p),
# 1024 to (s), 512 to (t) (PERF.md §4).  512 docs are a quarter of a
# superchunk of S = 64 chunks of C; (p1) takes the same corpus
N1_DOCS = 512
# (n3): one row of the prefill_32k cell (the reference's batch of 32 is
# 32 x (B, H, 4096, 32768) float32 score chunks: far past one card), its
# attention in chunks of the configs' 4096; chunked against one pass at
# N3_CHECK tokens (2 chunks)
N3_SEQ, N3_CHECK = 32768, 8192
# (n4): passages and queries encoded in bf16 and in float32; gemma-7b's
# float32 copy (34 GB) is cut to its first N4_GEMMA_LAYERS layers
N4_TEXTS, N4_TOPK, N4_GEMMA_LAYERS = 64, 10, 4
# (n2): the launcher's requests (S pinned to 64 for every rung)
N2_REQUESTS, N2_BATCH = 4, 8
# Tolerances, stated before the first run on the card (PERF.md §6):
# (n3) chunked against unchunked attention, the embedding's cosine (bf16
# activations; cuBLAS may pick other algorithms per chunk, so the bits
# are not promised); (n4) bf16 against float32 embeddings, each row's
# cosine, and the mean overlap of their top-10 over the 64 passages
N3_MIN_COS = 0.999
N4_MIN_COS, N4_MIN_OVERLAP = 0.99, 0.5


def lm_model(dev, name: str, cfg=None) -> dict:
    """An LM encoder at full width (or ``cfg``) with seeded weights drawn
    on the card, its retriever and collator."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.collator import RetrievalCollator
    from repro_torch.core.config import DataArguments
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models.encoder import DefaultEncoder
    from repro_torch.models.retriever import BiEncoderRetriever

    cfg = cfg or get_arch(name).cfg
    retriever = BiEncoderRetriever(DefaultEncoder(cfg))
    t0 = time.perf_counter()
    params = retriever.init_params(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    return {"cfg": cfg, "retriever": retriever, "params": params,
            "init_s": init_s,
            "collator": RetrievalCollator(
                DataArguments(vocab_size=cfg.vocab_size),
                HashTokenizer(cfg.vocab_size))}


def gib(n_bytes: float) -> float:
    return n_bytes / 2 ** 30


class EncodeLog:
    """What one online search scored, recorded by wrapping, in the
    script: the query embeddings ``ShardedSearchDriver.search`` gets, and
    every corpus chunk ``PipelineChunkSource.open_slice`` yields, by
    offset (device tensors, kept without a copy or a sync)."""

    def __init__(self):
        self.queries: list = []
        self.chunks: dict = {}

    def __enter__(self):
        from repro_torch.core.encode_pipeline import PipelineChunkSource
        from repro_torch.core.sharded_search import ShardedSearchDriver
        self._orig = (ShardedSearchDriver.search,
                      PipelineChunkSource.open_slice)
        search, open_slice = self._orig

        def logged_search(driver, q_emb, *args, **kw):
            self.queries.append(q_emb)
            return search(driver, q_emb, *args, **kw)

        def logged_slice(src, lo, hi, chunk_size):
            for off, emb in open_slice(src, lo, hi, chunk_size):
                self.chunks[off] = emb
                yield off, emb

        ShardedSearchDriver.search = logged_search
        PipelineChunkSource.open_slice = logged_slice
        return self

    def __exit__(self, *exc):
        from repro_torch.core.encode_pipeline import PipelineChunkSource
        from repro_torch.core.sharded_search import ShardedSearchDriver
        (ShardedSearchDriver.search,
         PipelineChunkSource.open_slice) = self._orig

    def rows(self):
        """(queries, docs) as float64 numpy arrays, docs in corpus
        order."""
        import torch
        if len(self.queries) != 1:
            fail(f"expected one search, saw {len(self.queries)}")
        docs = torch.cat([self.chunks[o] for o in sorted(self.chunks)])
        return (self.queries[0].double().cpu().numpy(),
                docs.double().cpu().numpy())


def k1_against_f64(tag: str, log: EncodeLog, ids, vals, corpus) -> float:
    """K1's scores against a float64 host product of the embeddings the
    search scored: each returned id's score within TOL of its exact
    score, and the ranking within TOL of the exact top-k (ids equal
    where separated).  Returns the largest score error."""
    import numpy as np

    from repro_torch.data.table import stable_id_hash_array

    q, docs = log.rows()
    hashes = stable_id_hash_array(list(corpus))
    if docs.shape[0] != len(hashes):
        fail(f"{tag}: {docs.shape[0]} rows scored of {len(hashes)}")
    exact = q @ docs.T
    pos_of = {h: i for i, h in enumerate(hashes.tolist())}
    pos = np.vectorize(pos_of.__getitem__)(ids)
    err = float(np.abs(vals - exact[np.arange(len(q))[:, None], pos]).max())
    if not err <= TOL:
        fail(f"{tag}: K1 score error {err} against float64 above {TOL}")
    order = np.argsort(-exact, axis=1, kind="stable")[:, :K]
    check_exact(f"{tag} vs exact float64 top-k", ids, vals, hashes[order],
                np.take_along_axis(exact, order, 1).astype(np.float32))
    return err


def k1_held(dev, q: int, s: int, d: int, tag: str, timed: bool,
            k: int | None = None):
    """K1 at (q, s, C, d, k) (k = K unless given) on seeded unit vectors:
    within TOL of its plain version, ids equal where separated; then, if
    ``timed``, timed as in (b) (:func:`k1_time`), the row returned (else
    None)."""
    import torch

    from repro_torch.kernels import ops, ref, topk

    k = K if k is None else k
    g = torch.Generator(device=dev).manual_seed(SEED + d)

    def unit(*shape):
        x = torch.randn(*shape, generator=g, device=dev)
        return x / x.norm(dim=-1, keepdim=True)

    queries, tile = unit(q, d), unit(s, C, d)
    offs = torch.arange(s, dtype=torch.int32, device=dev) * C
    nvs = torch.full((s,), C, dtype=torch.int32, device=dev)
    v, i = ops.empty_state(q, k, dev)
    want = ref.fused_score_topk_ref(v.clone(), i.clone(), queries, tile,
                                    offs, nvs)
    topk.fused_score_topk_(v, i, queries, tile, offs, nvs)
    torch.cuda.synchronize()
    err = compare(f"{tag} K1 Q={q} S={s} d={d}", (v, i), want, False)
    rows, splits, span = topk.fused_split_plan(q, s * C, topk.sm_count(dev))
    print(f"[{tag[1]}] {tag} K1 at Q={q} S={s} C={C} d={d} k={k} "
          f"({splits} range(s) of {span} rows, tiles of {rows}) vs its plain "
          f"version: max abs error {err:.3g} (tol {TOL}), ids equal where "
          f"separated")
    if not timed:
        return None
    t = k1_time(dev, queries, tile, offs, nvs,
                f"Q={q} S={s} C={C} d={d} k={k}", phase=tag[1])
    t["max_abs_err"] = err
    return t


class K1Calls:
    """The shape (Q, S, C, d, k) of every K1 call a path makes, recorded
    by wrapping ``topk.fused_score_topk_`` here, in the script (the
    wrapper it calls still counts each launch once)."""

    def __enter__(self):
        from repro_torch.kernels import topk
        self.shapes: set = set()
        self._orig = launch = topk.fused_score_topk_

        def logged(vals, ids, queries, tile, *args, **kw):
            self.shapes.add((queries.shape[0], *tile.shape, vals.shape[1]))
            return launch(vals, ids, queries, tile, *args, **kw)

        topk.fused_score_topk_ = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import topk
        topk.fused_score_topk_ = self._orig


def lm_evaluate(dev, card: str, name: str, lm: dict, trove: dict,
                paths: dict, tag: str = "(n1)", pairs=N_PAIRS) -> None:
    """(n1) (and (o3), (p1), (p3): ``tag``): evaluate over ``trove``'s
    dataset on ``pairs`` (the three, or (fused, kernel) and (torch,
    kernel)), launches predicted; fused within TOL of torch and of a
    float64 host product; then a mine on (fused, kernel)."""
    import numpy as np
    import torch

    queries, corpus, qrels = (trove["queries"], trove["corpus"],
                              trove["qrels"])
    data = dict(lm, queries=queries, corpus=corpus, qrels=qrels)
    d = lm["cfg"].d_model
    runs, log = {}, EncodeLog()
    torch.cuda.reset_peak_memory_stats(dev)
    for score, heap in pairs:
        ev = trove_evaluator(dev, data, score, heap)
        kernel = path_kernel(score, heap)
        searched = []
        search = ev.search

        def recorded(*args, search=search, searched=searched, **kw):
            searched.append(search(*args, **kw))
            return searched[-1]

        ev.search = recorded

        def want(_, score=score, heap=heap, ev=ev):
            return predicted(ev, score, heap)

        def run(ev=ev, fused=score == "fused"):
            if fused:
                with log:
                    return ev.evaluate(queries, corpus, qrels)
            return ev.evaluate(queries, corpus, qrels)

        tokens = ev.encode_pipeline.stats["tokens_padded"]
        t0 = time.perf_counter()
        metrics = on_path(paths, f"{tag} {name} evaluate ({score}, {heap})",
                          kernel, run, want)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = ev.encode_pipeline.stats["tokens_padded"] - tokens
        _, ids, vals = searched[0]
        if ids.shape != (Q, K) or not np.isfinite(vals).all() or (
                np.diff(vals, axis=1) > 0).any():
            fail(f"{tag} {name} ({score}, {heap}): bad result")
        if not all(0.0 <= m <= 1.0 for m in metrics.values()):
            fail(f"{tag} {name} ({score}, {heap}): metrics {metrics}")
        runs[(score, heap)] = (ids, vals)
        st = ev.last_search_stats
        print(f"[{tag[1]}] {tag} {name} evaluate ({score}, {heap}) on "
              f"{card}: {wall:.3f} s, {tokens} padded tokens encoded, "
              f"{tokens / wall:.0f} padded tokens/s, {st['executor']} x"
              f"{st['dispatch_rounds']} calls of S={st['superchunk_size']}"
              f", metrics {rounded(metrics)}")
        if (score, heap) == ("fused", "kernel"):
            f64_err = k1_against_f64(f"{tag} {name}", log, ids, vals, corpus)
            negs = on_path(
                paths, f"{tag} {name} mine_hard_negatives (fused, kernel)",
                kernel, lambda ev=ev: ev.mine_hard_negatives(
                    queries, corpus, qrels, depth=20), want)
            if not negs or any(not np.isfinite(s) for _, _, s in negs):
                fail(f"{tag} {name}: mine_hard_negatives bad")
            print(f"[{tag[1]}] {tag} {name} mine_hard_negatives (fused, "
                  f"kernel): {len(negs)} triplets")
    if ("torch", "torch") in runs:
        err, same = check_backends(f"{tag} {name}", runs), (
            "(torch, kernel) == (torch, torch) bitwise; ")
    else:
        err, same = check_exact(f"{tag} {name} fused vs torch",
                                *runs[("fused", "kernel")],
                                *runs[("torch", "kernel")]), ""
    print(f"[{tag[1]}] {tag} {name} d = {d}: {same}fused vs torch max abs "
          f"error {err:.3g}; K1's "
          f"largest score error against a float64 host product "
          f"{f64_err:.3g} (tol {TOL}), ids equal where separated; peak "
          f"{gib(torch.cuda.max_memory_allocated(dev)):.2f} GiB on {card}")


def lm_prefill(dev, card: str, name: str, lm: dict, paths: dict,
               checks: list) -> None:
    """(n3): the prefill_32k encode cell at one row of N3_SEQ tokens, its
    attention in chunks of 4096 (counted by wrapping the score function),
    ms and peak memory (no kernel launched); then chunked against one
    pass at N3_CHECK."""
    import dataclasses

    import torch

    from repro_torch.configs.lm_arch import LMArch
    from repro_torch.models import transformer
    from repro_torch.training import tree

    cfg, params = lm["cfg"], lm["params"]

    def cell_for(c, seq):
        arch = LMArch(c, shapes={"prefill_32k": dict(
            kind="encode", seq_len=seq, global_batch=1)})
        return arch, arch.build_cell("prefill_32k", dev)

    arch, cell = cell_for(cfg, N3_SEQ)
    batch = arch.smoke_inputs("prefill_32k", torch.Generator(
        device=dev).manual_seed(SEED), dev)
    chunks = []
    inner = transformer._attn_scores_softmax

    def counted(q, *args):
        chunks.append(q.shape[1])
        return inner(q, *args)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    transformer._attn_scores_softmax = counted
    try:
        t0 = time.perf_counter()
        emb = on_path(paths, f"(n3) {name} prefill_32k cell", None,
                      lambda: cell.fn(params, batch), no_launches)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        transformer._attn_scores_softmax = inner
    peak = gib(torch.cuda.max_memory_allocated(dev))
    n_chunks = N3_SEQ // cfg.attn_chunk
    if chunks != [cfg.attn_chunk] * (n_chunks * cfg.n_layers):
        fail(f"(n3) {name}: attention calls {len(chunks)} of "
             f"{sorted(set(chunks))} rows, not {n_chunks} chunks x "
             f"{cfg.n_layers} layers")
    norm = float(emb.norm())
    if emb.shape != (1, cfg.d_model) or abs(norm - 1) > 1e-3:
        fail(f"(n3) {name}: embedding {tuple(emb.shape)}, norm {norm}")
    score_gib = gib(cfg.n_heads * cfg.attn_chunk * N3_SEQ * 4)
    param_gib = gib(sum(t.nbytes for t in tree.leaves(params)))
    print(f"[n] (n3) {name} prefill_32k cell, 1 x {N3_SEQ} tokens, "
          f"attention in {n_chunks} chunks of {cfg.attn_chunk} on {card}: "
          f"{ms:.1f} ms, {N3_SEQ / ms * 1e3:.0f} tokens/s, peak {peak:.2f} "
          f"GiB (params {param_gib:.2f} GiB, one chunk's float32 scores "
          f"{score_gib:.2f} GiB)")
    short = {k: t[:, :N3_CHECK].contiguous() for k, t in batch.items()}
    embs = [cell_for(c, N3_CHECK)[1].fn(params, short) for c in (
        cfg, dataclasses.replace(cfg, attn_chunk=0))]
    cos = float((embs[0] * embs[1]).sum())
    diff = float((embs[0] - embs[1]).abs().max())
    same = torch.equal(embs[0], embs[1])
    print(f"[n] (n3) {name} at {N3_CHECK} tokens, "
          f"{N3_CHECK // cfg.attn_chunk} "
          f"chunks against one pass: cosine {cos:.6f}, max abs "
          f"{diff:.3g}, bitwise {same} (tol cosine >= {N3_MIN_COS})")
    if not cos >= N3_MIN_COS:
        checks.append(f"(n3) {name}: chunked vs unchunked cosine {cos}")


def lm_precision(dev, card: str, name: str, lm: dict, trove: dict,
                 paths: dict, checks: list) -> None:
    """(n4): N4_TEXTS passages and queries encoded with the bf16 weights
    and with the same weights cast to float32 (gemma-7b: a config of its
    first N4_GEMMA_LAYERS layers over those layers of the same params),
    each row's cosine and the overlap of the top-N4_TOPK passages of the
    queries."""
    import dataclasses

    import numpy as np
    import torch

    cfg, params = lm["cfg"], lm["params"]
    if name == "gemma-7b":
        depth = min(N4_GEMMA_LAYERS, cfg.n_layers)
        cfg = dataclasses.replace(cfg, n_layers=depth)
        params = dict(params, blocks={k: t[:depth] for k, t
                                      in params["blocks"].items()})
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    f32_params = {k: ({n: t.float() for n, t in v.items()}
                      if isinstance(v, dict) else v.float())
                  for k, v in params.items()}
    passages = list(trove["corpus"].values())[:N4_TEXTS]
    queries = list(trove["queries"].values())[:N4_TEXTS]

    def encode_both():
        out = []
        for c, p in ((cfg, params), (f32, f32_params)):
            ev = trove_evaluator(dev, dict(lm_model_parts(c, lm), params=p))
            out.append([ev._encode_texts(t, q, device=True).double()
                        for t, q in ((passages, False), (queries, True))])
        return out

    out = on_path(paths, f"(n4) {name} bf16 and float32 encodes", None,
                  encode_both, no_launches)
    del f32_params
    (p16, q16), (p32, q32) = out
    cos = torch.cat([(p16 * p32).sum(1), (q16 * q32).sum(1)])
    top16 = torch.topk(q16 @ p16.T, N4_TOPK).indices.cpu().numpy()
    top32 = torch.topk(q32 @ p32.T, N4_TOPK).indices.cpu().numpy()
    overlap = float(np.mean([len(set(a) & set(b)) / N4_TOPK
                             for a, b in zip(top16, top32)]))
    print(f"[n] (n4) {name} ({cfg.n_layers} layers) bf16 vs float32 on "
          f"{card}: {N4_TEXTS} passages + {N4_TEXTS} queries, cosine min "
          f"{float(cos.min()):.6f} mean {float(cos.mean()):.6f}; top-"
          f"{N4_TOPK} overlap {overlap:.3f} (tol cosine >= {N4_MIN_COS}, "
          f"overlap >= {N4_MIN_OVERLAP})")
    if not (float(cos.min()) >= N4_MIN_COS and overlap >= N4_MIN_OVERLAP):
        checks.append(f"(n4) {name}: cosine min {float(cos.min())}, "
                      f"overlap {overlap}")


def lm_model_parts(cfg, lm: dict) -> dict:
    """A retriever and collator for ``cfg`` (lm's collator: one vocab)."""
    from repro_torch.models.encoder import DefaultEncoder
    from repro_torch.models.retriever import BiEncoderRetriever
    return {"retriever": BiEncoderRetriever(DefaultEncoder(cfg)),
            "collator": lm["collator"]}


def pin_superchunk(dev, d: int, n_queries, k: int) -> None:
    """The launchers' S autotune keys at width ``d`` (on ``dev``'s type,
    the launchers' device) pinned to S, so their counted runs launch only
    their rounds' K1 calls, at S = 64 (phase (n) runs last: no later
    launcher reads these keys)."""
    import torch

    from repro_torch.core import sharded_search
    for q in n_queries:
        sharded_search._AUTOTUNE_CACHE[(q, d, C, k, "fused", "kernel",
                                        str(torch.device(dev.type)))] = S


def lm_launchers(dev, card: str, paths: dict) -> list:
    """(n2): ``serve.main --arch`` at ``--workers 1`` for trove-base and
    the three LM archs, one after the other on ONE ``--data-dir``: each
    encodes its own corpus into its own cache directory (before the
    repair a second encoder read the first's rows), each request within
    TOL of a solo ``search_texts``, and K1 held against its plain version
    at every shape the run gave it (:class:`K1Calls`; the requests
    compare K1 only with itself), and at S = 64, the pinned S over a
    corpus of 64 chunks or more; then ``evalsuite.main --arch
    qwen2-0.5b``.  Returns K1's timings at the run's Q = 1 and Q =
    N2_BATCH."""
    import contextlib
    import gc
    import io

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.table import stable_id_hash_array
    from repro_torch.launch import evalsuite, serve

    rungs = [1]
    while rungs[-1] < N2_BATCH:
        rungs.append(2 * rungs[-1])
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "serve-data")
        argv = ["--data-dir", data, "--device", dev.type, "--topk", str(K),
                "--n-requests", str(N2_REQUESTS), "--batch", str(N2_BATCH),
                "--max-batch", str(N2_BATCH), "--workers", "1"]
        timings = []
        for name in ("trove-base",) + N_ARCHS:
            cfg = get_arch(name).cfg
            pin_superchunk(dev, cfg.d_model, rungs, K)
            out, served, calls = io.StringIO(), ServedLog(), K1Calls()

            def run(name=name, out=out, served=served, calls=calls):
                with contextlib.redirect_stdout(out), served, calls:
                    return serve.main(argv + ["--arch", name])

            t0 = time.perf_counter()
            try:
                stats = serving_path(
                    paths, f"(n2) serve.main --arch {name} (fused, kernel)",
                    run)
                corpus = [json.loads(line)["_id"] for line in open(
                    os.path.join(data, "corpus.jsonl"))]
                held = check_served(f"(n2) serve.main --arch {name}",
                                    served, corpus, N2_REQUESTS)
                wrote = set(stable_id_hash_array(corpus).tolist())
                if not wrote <= served.written:
                    fail(f"(n2) {name}: encoded {len(served.written)} "
                         f"corpus rows, not all {len(wrote)}")
            finally:
                served.close()
            wall = time.perf_counter() - t0
            fs = stats["frontend"]
            if fs["completed"] != N2_REQUESTS + len(rungs) or fs["failed"]:
                fail(f"(n2) {name}: {json.dumps(fs)}")
            print(f"[n] (n2) serve.main --arch {name} ({cfg.d_model} wide) "
                  f"on {card}: {wall:.1f} s, its {len(wrote)} corpus rows "
                  f"encoded into {serve.cache_dir(data, name, False)}; "
                  f"{N2_REQUESTS} requests of {N2_BATCH}, p50 "
                  f"{stats['p50_ms']:.3f} ms; {held}")
            # the run's frontend (and with it the launcher's weights) is
            # held by the log and the closure until here
            del served, stats, run
            gc.collect()
            torch.cuda.empty_cache()
            if {(q, c, dd, k) for q, _, c, dd, k in calls.shapes} != {
                    (q, C, cfg.d_model, K) for q in rungs}:
                fail(f"(n2) {name}: K1 calls {sorted(calls.shapes)}")
            for q, s, *_ in sorted(calls.shapes):
                t = k1_held(dev, q, s, cfg.d_model, f"(n2) {name}",
                            timed=q in (1, N2_BATCH))
                timings += [t] if t else []
            k1_held(dev, N2_BATCH, S, cfg.d_model, f"(n2) {name}",
                    timed=False)
        print(f"[n] (n2) one data dir, caches "
              f"{sorted(os.listdir(os.path.join(data, 'emb_cache')))}")

        cfg = get_arch("qwen2-0.5b").cfg
        pin_superchunk(dev, cfg.d_model, (16, 32), 10)
        root = os.path.join(tmp, "suite")
        out = io.StringIO()

        def suite():
            with contextlib.redirect_stdout(out):
                return evalsuite.main([
                    "--arch", "qwen2-0.5b", "--data-root", root,
                    "--device", dev.type, "--out-dir",
                    os.path.join(root, "out")])

        t0 = time.perf_counter()
        results = serving_path(
            paths, "(n2) evalsuite.main --arch qwen2-0.5b (fused, kernel)",
            suite)
        wall = time.perf_counter() - t0
        if set(results) != {"d0", "d1", "combined"} or not all(
                0.0 <= m <= 1.0 for row in results.values()
                for m in row.values()):
            fail(f"(n2) evalsuite: {results}")
        print(f"[n] (n2) evalsuite.main --arch qwen2-0.5b on {card}: "
              f"{wall:.1f} s, combined {rounded(results['combined'])}")
        gc.collect()
        torch.cuda.empty_cache()
        return timings


def phase_lm_encoders(dev, card: str) -> tuple[dict, list]:
    """(n) qwen2-0.5b, stablelm-3b and gemma-7b at full width, bf16,
    seeded weights drawn on the card, each freed before the next: (n1)
    evaluate / mine through K1 and K2 over (c)'s recipe at N1_DOCS docs,
    (n3) the prefill cell at 32k, (n4) bf16 against float32; then (n2)
    the launchers; and K1 held and timed at each width, at (n1)'s and
    (n2)'s shapes.  Returns each path's
    launches and the K1 timings."""
    import gc

    import torch

    from repro_torch.data.synthetic import make_retrieval_dataset
    from repro_torch.training import tree

    with tempfile.TemporaryDirectory() as tmp:
        queries, corpus, qrels = make_retrieval_dataset(
            tmp, n_queries=Q, n_docs=N1_DOCS, n_topics=64, seed=SEED)
    trove = {"queries": queries, "corpus": corpus, "qrels": qrels}
    paths: dict = {}
    checks: list = []
    timings = []
    for name in N_ARCHS:
        t0 = time.perf_counter()
        lm = lm_model(dev, name)
        cfg = lm["cfg"]
        n_bytes = sum(t.nbytes for t in tree.leaves(lm["params"]))
        print(f"[n] {name}: {cfg.n_layers} x {cfg.d_model}, "
              f"{cfg.n_heads} heads x {cfg.head_dim} over "
              f"{cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.3f} B params, "
              f"{gib(n_bytes):.2f} GiB in {cfg.dtype}, drawn in "
              f"{lm['init_s']:.2f} s on {card}")
        lm_evaluate(dev, card, name, lm, trove, paths)
        lm_prefill(dev, card, name, lm, paths, checks)
        lm_precision(dev, card, name, lm, trove, paths, checks)
        decode_turn(dev, card, name, lm, paths, "(n) LM encoders")
        del lm
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[n] {name}: {time.perf_counter() - t0:.1f} s")
        timings.append(k1_held(dev, Q, S, cfg.d_model, "(n1)", timed=True))
    timings += lm_launchers(dev, card, paths)
    if checks:
        fail("; ".join(checks))
    return paths, timings


# -- (o) the dense LM encoders under training ---------------------------------

# (o1): launch/train.py --arch at full width over (l)'s dataset (L_DATA) and
# batch (L_BATCH queries x L_GROUP passages, L_QLEN / L_PLEN tokens at
# most) at L_LR for O1_STEPS steps, only the final save asked for; AdamW for
# qwen2-0.5b and stablelm-3b, Adafactor for gemma-7b (AdamW's float32
# moments alone are 63.6 GiB there).  The final save is written only for
# the archs in O1_SAVED (qwen2-0.5b's is served in (o3), granite's read in
# (p2)); stablelm-3b's and gemma-7b's (24.8 + 19.9 GiB) are recorded as
# asked for and not written, to make room for (p).  (o3): (o1)'s weights
# evaluated and mined over (c)'s recipe at O3_DOCS docs, and qwen2-0.5b's
# checkpoint
# served (O3_REQUESTS requests of O3_BATCH queries).  (o2): the train_4k
# cell (Adafactor) on (o1)'s weights for O2_STEPS steps at O2_LEN tokens,
# its batch cut to O2_BATCH queries and as many passages (the reference's
# 256 x 4096 runs on a mesh; PERF.md §4); then remat on against off for
# qwen2-0.5b at O2R_BATCH x O2R_LEN, under deterministic algorithms.
O_ARCHS = (("qwen2-0.5b", "adamw"), ("stablelm-3b", "adamw"),
           ("gemma-7b", "adafactor"))
O1_STEPS = 5
O1_SAVED = ("qwen2-0.5b", "granite-moe-3b-a800m")
O2_BATCH = {"qwen2-0.5b": 4, "stablelm-3b": 2, "gemma-7b": 2,
            "granite-moe-3b-a800m": 4}
O2_LEN, O2_STEPS = 4096, 2
O2R_LEN, O2R_BATCH = 1024, 2
O3_DOCS, O3_REQUESTS, O3_BATCH = 1024, 4, 8
# Peak GiB reckoned before the first run on the card (PERF.md §4): (o1)
# bf16 params + bf16 gradients + the optimizer's float32 state + two
# float32 copies of the largest leaf (the in-place clip and update);
# (o2) params + gradients + state + the layer inputs remat keeps + one
# layer's recomputed float32 attention scores (3-4 score tensors); (p2)'s
# granite-moe-3b-a800m with Adafactor: 6.14 params + 6.14 grads + 0.79
# state + 2 x 3.75 (one (32, 40, 1536, 512) expert leaf in float32), and
# train_4k at 4 + 4 x 4096: 6.14 + 6.14 + 0.79 + 3.0 (96 KiB a token
# kept) + 3-5 x 1.5 (24 heads x 4096^2 float32 scores a sequence) + ~2
# (the expert buffers at cap 1024)
O1_RECKONED = {"qwen2-0.5b": 6.5, "stablelm-3b": 34.0, "gemma-7b": 51.5,
               "granite-moe-3b-a800m": 20.6}
O2_RECKONED = {"qwen2-0.5b": 18.0, "stablelm-3b": 28.0, "gemma-7b": 52.0,
               "granite-moe-3b-a800m": 48.0}


def o1_train(dev, card: str, name: str, optimizer: str, data_dir: str,
             tmp: str, paths: dict, tag: str = "(o1)"):
    """(o1) (and (p2), ``tag``): ``launch.train --arch name`` at full
    width, bf16, seeded weights; (trainer, final state, the final
    checkpoint's directory, None when ``name`` is not in O1_SAVED: the
    save is then recorded as asked for and not written)."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from repro_torch.launch import train
    from repro_torch.training.checkpoint import CheckpointManager

    out_dir = os.path.join(tmp, f"o1-{name}")
    free = shutil.disk_usage(tmp).free
    log = TrainLog(keep_initial=False)
    argv = ["--arch", name, "--optimizer", optimizer, "--data-dir",
            data_dir, "--output_dir", out_dir, "--device", dev.type,
            "--max_steps", str(O1_STEPS), "--per_device_batch_size",
            str(L_BATCH), "--group_size", str(L_GROUP), "--query_max_len",
            str(L_QLEN), "--passage_max_len", str(L_PLEN),
            "--checkpoint_every", str(10 * O1_STEPS), "--log_every", "1",
            "--learning_rate", str(L_LR)]

    saves, save = [], CheckpointManager.save

    def asked(mgr, step, state, blocking=None):
        saves.append(step)

    def run():
        if name not in O1_SAVED:
            CheckpointManager.save = asked
        try:
            with contextlib.redirect_stdout(io.StringIO()), log:
                return train.main(argv)
        finally:
            CheckpointManager.save = save

    cuda = dev.type == "cuda"
    if cuda:
        torch.empty(0, device=dev)        # the allocator exists
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer, state = on_path(paths, f"{tag} launch.train --arch {name}",
                             None, run, no_launches)
    wall = time.perf_counter() - t0
    peak = gib(torch.cuda.max_memory_allocated(dev)) if cuda else 0.0
    cfg = trainer.retriever.encoder.cfg
    logs = trainer.logs
    if (cfg.name, cfg.dtype, cfg.remat) != (name, torch.bfloat16, True):
        fail(f"{tag} {name}: trained {cfg.name} in {cfg.dtype}, remat "
             f"{cfg.remat}")
    if [r["step"] for r in logs] != list(range(O1_STEPS)) or not all(
            np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
            for r in logs) or int(state["step"]) != O1_STEPS:
        fail(f"{tag} {name}: logs {[(r['step'], r['loss']) for r in logs]}")
    ckpts = os.path.join(out_dir, "checkpoints")
    final = f"step_{O1_STEPS:08d}"
    written = [] if saves else [final]
    if sorted(os.listdir(ckpts)) != written or saves not in ([], [O1_STEPS]):
        fail(f"{tag} {name}: checkpoints {sorted(os.listdir(ckpts))}, "
             f"saves asked for and not written {saves}")
    step_dir = os.path.join(ckpts, final) if written else None
    n_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                  for f in os.listdir(step_dir)) if written else 0
    times = trainer.step_ms()
    med = {p: statistics.median(t[p] for t in times[1:])
           for p in ("total", "forward", "backward", "update")}
    toks = log.tokens[:O1_STEPS]
    padded = statistics.median(q[0] + p[0] for q, p in toks)
    real = statistics.median(q[1] + p[1] for q, p in toks)
    p = tag[1]
    print(f"[{p}] {tag} launch.train --arch {name} --optimizer "
          f"{optimizer}: {cfg.n_layers} x {cfg.d_model}, {cfg.dtype}, "
          f"remat, {O1_STEPS} steps of {L_BATCH} queries x {L_GROUP} "
          f"passages ({L_QLEN} / {L_PLEN} tokens at most) on {card}: "
          f"{wall:.2f} s of launcher, {gib(free):.1f} GiB of disk free "
          f"before it")
    print(f"[{p}] {tag} {name} step ms (median of steps 1-{O1_STEPS - 1}, "
          f"{'CUDA events' if cuda else 'host clock'}): "
          f"{med['total']:.3f} = forward {med['forward']:.3f} + backward "
          f"{med['backward']:.3f} + clip + {optimizer} "
          f"{med['update']:.3f}; first step {times[0]['total']:.3f}; "
          f"{padded:.0f} padded ({real:.0f} real) tokens a step: "
          f"{padded / med['total'] * 1e3:.0f} padded tokens/s; peak "
          f"{peak:.2f} GiB (reckoned {O1_RECKONED[name]:.1f})")
    losses = " ".join(f"{r['loss']:.4f}" for r in logs)
    aux = ""
    if cfg.moe:
        if not all(np.isfinite(r["moe_aux_loss"]) and r["moe_aux_loss"] > 0
                   for r in logs):
            fail(f"{tag} {name}: moe_aux_loss "
                 f"{[r['moe_aux_loss'] for r in logs]}")
        aux = (" (moe_aux_loss " + " ".join(
            f"{r['moe_aux_loss']:.4f}" for r in logs) + ", weighted 0.01)")
    saved = (f"final checkpoint {final}: {gib(n_bytes):.2f} GiB ({n_bytes} "
             f"bytes)" if written else f"final save of step {O1_STEPS} "
             f"asked for, not written")
    print(f"[{p}] {tag} {name} loss {losses}{aux}, all finite; {saved}")
    return trainer, state, step_dir


def o3_score(dev, card: str, name: str, trainer, state, trove: dict,
             paths: dict) -> None:
    """(o3): evaluate on the three pairs and mine on (fused, kernel) with
    (o1)'s trained weights (:func:`lm_evaluate`'s rules), and K1 held
    against its plain version at every shape those runs gave it."""
    from repro_torch.core.collator import RetrievalCollator
    from repro_torch.core.config import DataArguments
    from repro_torch.data.tokenizer import HashTokenizer

    cfg = trainer.retriever.encoder.cfg
    lm = {"cfg": cfg, "retriever": trainer.retriever,
          "params": state["params"],
          "collator": RetrievalCollator(
              DataArguments(vocab_size=cfg.vocab_size),
              HashTokenizer(cfg.vocab_size))}
    with K1Calls() as calls:
        lm_evaluate(dev, card, name, lm, trove, paths, tag="(o3)")
    # evaluate's k = K, the mine's its depth
    if {(q, c, d) for q, _, c, d, _ in calls.shapes} != {
            (Q, C, cfg.d_model)}:
        fail(f"(o3) {name}: K1 calls {sorted(calls.shapes)}")
    for q, s, _, d, k in sorted(calls.shapes):
        k1_held(dev, q, s, d, f"(o3) {name}", timed=False, k=k)


def o3_serve(dev, card: str, name: str, data_dir: str, step_dir: str,
             state, paths: dict) -> None:
    """(o3): ``serve.main --arch name --ckpt-dir`` on (o1)'s checkpoint:
    the restored params bitwise the trainer's, each request within TOL of
    a solo search, the cache directory named by the checkpoint's step and
    manifest digest, K1 held at every shape the run gave it."""
    import contextlib
    import hashlib
    import io

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.training import checkpoint

    d = get_arch(name).cfg.d_model
    rungs = [1]
    while rungs[-1] < O3_BATCH:
        rungs.append(2 * rungs[-1])
    pin_superchunk(dev, d, rungs, K)
    restored, restore = [], checkpoint.restore_checkpoint

    def recording(path, template):
        restored.append(restore(path, template))
        return restored[-1]

    served, calls = ServedLog(), K1Calls()

    def run():
        checkpoint.restore_checkpoint = recording
        try:
            with contextlib.redirect_stdout(io.StringIO()), served, calls:
                return serve.main([
                    "--arch", name, "--data-dir", data_dir, "--device",
                    dev.type, "--ckpt-dir", os.path.dirname(step_dir),
                    "--topk", str(K), "--n-requests", str(O3_REQUESTS),
                    "--batch", str(O3_BATCH), "--max-batch", str(O3_BATCH),
                    "--workers", "1"])
        finally:
            checkpoint.restore_checkpoint = restore

    t0 = time.perf_counter()
    try:
        stats = serving_path(paths, f"(o3) serve.main --arch {name} "
                             f"--ckpt-dir (fused, kernel)", run)
        if len(restored) != 1:
            fail(f"(o3) {name}: {len(restored)} restores")
        same_params(f"(o3) {name} restored vs trained",
                    restored[0]["params"], state["params"])
        corpus = [json.loads(line)["_id"] for line in open(
            os.path.join(data_dir, "corpus.jsonl"))]
        held = check_served(f"(o3) serve.main --arch {name} --ckpt-dir",
                            served, corpus, O3_REQUESTS)
    finally:
        served.close()
    wall = time.perf_counter() - t0
    with open(os.path.join(step_dir, "manifest.json"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    cache = os.path.join(data_dir, "emb_cache", f"{name}-"
                         f"{os.path.basename(step_dir)}-{digest}")
    if not os.path.isdir(cache):
        fail(f"(o3) {name}: no cache at {cache}: "
             f"{os.listdir(os.path.join(data_dir, 'emb_cache'))}")
    if {(q, c, dd, k) for q, _, c, dd, k in calls.shapes} != {
            (q, C, d, K) for q in rungs}:
        fail(f"(o3) {name} serve: K1 calls {sorted(calls.shapes)}")
    for q, s, *_ in sorted(calls.shapes):
        k1_held(dev, q, s, d, f"(o3) {name} serve", timed=False)
    print(f"[o] (o3) serve.main --arch {name} --ckpt-dir on {card}: "
          f"{wall:.1f} s, restored params bitwise equal to the trainer's, "
          f"cache {os.path.basename(cache)} (the checkpoint's step and "
          f"manifest digest); {O3_REQUESTS} requests of {O3_BATCH}, p50 "
          f"{stats['p50_ms']:.3f} ms; {held}")


def o2_cell(dev, card: str, name: str, params, paths: dict,
            tag: str = "(o2)") -> None:
    """(o2) (and (p2), ``tag``): the train_4k cell at full width, O2_LEN
    tokens kept, the batch cut to O2_BATCH[name] queries + as many
    passages, O2_STEPS steps on ``params`` (updated in place) from a zero
    Adafactor state: ms a step, tokens/s, peak GiB, finite losses; for an
    MoE stack the loss's 0.01 x aux term apart (the passages' aux,
    recorded by wrapping ``transformer.forward_hidden``)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import init_train_state
    from repro_torch.configs.lm_arch import LMArch
    from repro_torch.models import transformer
    from repro_torch.models.losses import InfoNCELoss

    arch = get_arch(name)
    b = O2_BATCH[name]
    cut = LMArch(arch.cfg, arch.optimizer, shapes={
        "train_4k": dict(arch.shapes["train_4k"], global_batch=b)})
    if cut.shapes["train_4k"]["seq_len"] != O2_LEN:
        fail(f"{tag} {name}: train_4k is {cut.shapes['train_4k']}")
    batch = cut.smoke_inputs("train_4k", torch.Generator(
        device=dev).manual_seed(SEED), dev)
    cell = cut.build_cell("train_4k", device=dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    state = init_train_state(cell, params)
    # the forward ends with the loss (InfoNCE), the backward at the clip
    marks = StepMarks(forward=(InfoNCELoss, "__call__")) if cuda else None
    auxes, hidden = [], transformer.forward_hidden

    def passage_aux(cfg, params, tokens, mask, mesh=None):
        out = hidden(cfg, params, tokens, mask, mesh)
        if tokens is batch["passage"]["tokens"]:
            auxes.append(out[1].detach())
        return out

    def run():
        transformer.forward_hidden = passage_aux
        try:
            with marks or contextlib.nullcontext():
                return train_steps(cell, state, batch, O2_STEPS, marks)
        finally:
            transformer.forward_hidden = hidden

    metrics = on_path(paths, f"{tag} {name} train_4k", None, run,
                      no_launches)
    split = {p: [0.0] for p in ("total", "forward", "backward", "update")}
    if cuda:
        torch.cuda.synchronize(dev)
        split = {p: [] for p in split}
        for s0, f, c, s1 in marks.splits:
            split["forward"].append(s0.elapsed_time(f))
            split["backward"].append(f.elapsed_time(c))
            split["update"].append(c.elapsed_time(s1))
            split["total"].append(s0.elapsed_time(s1))
    peak = gib(torch.cuda.max_memory_allocated(dev)) if cuda else 0.0
    losses = [float(m["loss"]) for m in metrics]
    if not all(np.isfinite(x) for x in losses) or int(state["step"]) != \
            O2_STEPS or len(auxes) != O2_STEPS:
        fail(f"{tag} {name}: losses {losses}, step {int(state['step'])}, "
             f"{len(auxes)} passage encodes")
    aux = [0.01 * float(a) for a in auxes]
    if arch.cfg.moe != all(a > 0 for a in aux):
        fail(f"{tag} {name}: 0.01 x aux {aux}")
    terms = (f" = InfoNCE {' '.join(f'{x - a:.4f}' for x, a in zip(losses, aux))}"
             f" + 0.01 x aux {' '.join(f'{a:.5f}' for a in aux)}"
             if arch.cfg.moe else "")
    tokens = 2 * b * O2_LEN
    last = {p: v[-1] for p, v in split.items()}
    print(f"[{tag[1]}] {tag} {name} train_4k ({cell.optimizer}, remat) at {b} "
          f"queries + {b} passages x {O2_LEN} tokens on {card}: step ms "
          f"{' / '.join(f'{x:.1f}' for x in split['total'])} (CUDA "
          f"events), the last {last['total']:.1f} = forward "
          f"{last['forward']:.1f} + backward {last['backward']:.1f} + "
          f"clip + {cell.optimizer} {last['update']:.1f}; "
          f"{tokens / max(last['total'], 1e-9) * 1e3:.0f} tokens/s; peak "
          f"{peak:.2f} GiB (reckoned {O2_RECKONED[name]:.1f}); loss "
          f"{' '.join(f'{x:.4f}' for x in losses)}{terms}")
    del state


def o2_remat(dev, card: str, paths: dict, name: str = "qwen2-0.5b",
             tag: str = "(o2)") -> None:
    """(o2) (and (p2): ``name``, ``tag``): the arch's train_4k step at
    O2R_BATCH x O2R_LEN from one seed with remat on and off, under
    deterministic algorithms: the gradients (recorded by wrapping
    ``configs.base.clip_by_global_norm``, which receives them) and the
    updated parameters bitwise equal."""
    import dataclasses

    import torch

    from repro_torch.configs import base, get_arch
    from repro_torch.configs.lm_arch import LMArch
    from repro_torch.models import transformer
    from repro_torch.training.tree import leaves

    cfg = get_arch(name).cfg
    shapes = {"train_4k": dict(kind="train", seq_len=O2R_LEN,
                               global_batch=O2R_BATCH)}
    clip = base.clip_by_global_norm
    cuda = dev.type == "cuda"
    out = {}
    for remat in (True, False):
        arch = LMArch(dataclasses.replace(cfg, remat=remat), "adafactor",
                      shapes)
        params = transformer.init_params(
            arch.cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        batch = arch.smoke_inputs("train_4k", torch.Generator(
            device=dev).manual_seed(SEED + 1), dev)
        cell = arch.build_cell("train_4k", device=dev)
        state = base.init_train_state(cell, params)
        grads = []

        def recorded(g, max_norm):
            grads.extend(t.clone() for t in leaves(g))
            return clip(g, max_norm)

        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        base.clip_by_global_norm = recorded
        torch.use_deterministic_algorithms(True)
        try:
            _, m = on_path(paths, f"{tag} {name} train_4k remat "
                           f"{'on' if remat else 'off'}", None,
                           lambda: cell.fn(state, batch), no_launches)
        finally:
            torch.use_deterministic_algorithms(False)
            base.clip_by_global_norm = clip
        if cuda:
            torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
        peak = gib(torch.cuda.max_memory_allocated(dev)) if cuda else 0.0
        out[remat] = (grads, state["params"], float(m["loss"]), wall, peak)
        del state, params
    (g1, p1, l1, ms1, pk1), (g0, p0, l0, ms0, pk0) = out[True], out[False]
    if len(g1) != len(g0) or not all(torch.equal(a, b) for a, b in
                                     zip(g1, g0)):
        fail(f"{tag} {name} remat on vs off: the gradients differ")
    same_params(f"{tag} {name} remat on vs off", p1, p0)
    if l1 != l0:
        fail(f"{tag} {name} remat on vs off: loss {l1} vs {l0}")
    print(f"[{tag[1]}] {tag} {name} train_4k at {O2R_BATCH} + {O2R_BATCH} x "
          f"{O2R_LEN} tokens, remat on vs off under deterministic "
          f"algorithms on {card}: {len(g1)} gradient leaves and the updated "
          f"params bitwise equal, loss {l1:.6f}; a step {ms1:.1f} / "
          f"{ms0:.1f} ms (host clock after a sync), peak {pk1:.2f} / "
          f"{pk0:.2f} GiB")
    del out, g1, g0, p1, p0


def phase_lm_training(dev, card: str) -> dict:
    """(o) qwen2-0.5b, stablelm-3b and gemma-7b trained at full width, one
    after the other, each freed before the next: (o1) the launcher, (o3)
    its weights scored through K1 and K2 (and qwen2-0.5b's checkpoint
    served), the checkpoint deleted, (o2) the train_4k cell on the same
    weights; then (o2)'s remat check.  Returns each path's launches."""
    import gc
    import shutil

    import torch

    from repro_torch.data.synthetic import make_retrieval_dataset

    paths: dict = {}
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        make_retrieval_dataset(data_dir, **L_DATA)
        queries, corpus, qrels = make_retrieval_dataset(
            os.path.join(tmp, "o3"), n_queries=Q, n_docs=O3_DOCS,
            n_topics=64, seed=SEED)
        trove = {"queries": queries, "corpus": corpus, "qrels": qrels}
        for name, optimizer in O_ARCHS:
            t0 = time.perf_counter()
            trainer, state, step_dir = o1_train(dev, card, name, optimizer,
                                                data_dir, tmp, paths)
            o3_score(dev, card, name, trainer, state, trove, paths)
            if name == "qwen2-0.5b":
                o3_serve(dev, card, name, data_dir, step_dir, state, paths)
            shutil.rmtree(os.path.join(tmp, f"o1-{name}"))
            params = state["params"]
            del trainer, state
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            o2_cell(dev, card, name, params, paths)
            del params
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            print(f"[o] {name}: {time.perf_counter() - t0:.1f} s")
        o2_remat(dev, card, paths)
    if cuda:
        torch.cuda.empty_cache()
    return paths


# -- (p) the MoE FFN at full width -------------------------------------------

P_GRANITE, P_LLAMA4 = "granite-moe-3b-a800m", "llama4-maverick-400b-a17b"
# (p3): llama4-maverick at its published width with its depth cut to one
# (dense, MoE) pair (its 48 layers are 739 GiB in bf16), over (o3)'s
# O3_DOCS docs on two pairs
P3_LAYERS = 2
P3_PAIRS = (("fused", "kernel"), ("torch", "kernel"))
# (p4): the serve launcher's requests; the tie check's batch of passages
P4_REQUESTS, P4_BATCH = 8, 8
P1_TIE_TEXTS = C


class RouteLog:
    """Every ``transformer._route`` call of a run, recorded by wrapping it
    here, in the script: per padded length S, the token-slots routed and
    those the capacity dropped (padding included).  With ``ties`` each
    call's choice is also held to the tie rule: among the experts whose
    probability equals a token's k-th chosen one, the chosen are the
    lowest indices (the probabilities recomputed from the same product,
    softmax and inputs)."""

    def __init__(self, ties: bool = False):
        self.ties = ties
        self.slots: dict = {}
        self.dropped: dict = {}
        self.tokens = 0
        self.tied: list = []
        self.broken: list = []

    def __enter__(self):
        from repro_torch.models import transformer
        self._orig = route = transformer._route

        def logged(cfg, h, router):
            out = route(cfg, h, router)
            keep, s = out[3], h.shape[1]
            self.slots[s] = self.slots.get(s, 0) + keep.numel()
            self.dropped.setdefault(s, []).append((~keep).sum())
            if self.ties:
                self._hold(cfg, h, router, out[1])
            return out

        transformer._route = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer._route = self._orig

    def _hold(self, cfg, h, router, choice):
        import torch
        import torch.nn.functional as F
        probs = torch.softmax(
            torch.einsum("bsd,de->bse", h, router).float(), dim=-1)
        tied = probs == probs.gather(-1, choice[..., -1:])
        chosen = F.one_hot(choice, cfg.n_experts).sum(-2).bool()
        n = (tied & chosen).sum(-1, keepdim=True)
        lowest = tied & (tied.cumsum(-1) <= n)
        self.broken.append(((tied & chosen) != lowest).any(-1).sum())
        self.tied.append((tied & ~chosen).any(-1).sum())
        self.tokens += probs.shape[0] * probs.shape[1]

    def shares(self) -> str:
        """Each padded length's dropped share of its token-slots."""
        return ", ".join(
            f"S={s}: {int(sum(self.dropped[s]))} of {self.slots[s]} "
            f"({int(sum(self.dropped[s])) / self.slots[s]:.4f})"
            for s in sorted(self.slots))


def moe_header(name: str, lm: dict, card: str) -> None:
    from repro_torch.training import tree
    cfg = lm["cfg"]
    n_bytes = sum(t.nbytes for t in tree.leaves(lm["params"]))
    print(f"[p] {name}: {cfg.n_layers} x {cfg.d_model}, {cfg.n_heads} "
          f"heads x {cfg.head_dim} over {cfg.n_kv_heads} KV, "
          f"{cfg.n_dense_layers} dense (d_ff {cfg.d_ff}) + "
          f"{cfg.n_moe_layers} MoE layers ({cfg.n_experts} experts of "
          f"{cfg.moe_d_ff}, top-{cfg.top_k}, {cfg.n_shared_experts} "
          f"shared, capacity factor {cfg.capacity_factor}), vocab "
          f"{cfg.vocab_size}: {cfg.param_count():,} params "
          f"({cfg.active_param_count():,} active), {gib(n_bytes):.2f} GiB "
          f"in {cfg.dtype}, drawn in {lm['init_s']:.2f} s on {card}")


def moe_evaluate(dev, card: str, name: str, lm: dict, trove: dict,
                 paths: dict, tag: str, pairs=N_PAIRS) -> None:
    """(p1), (p3): :func:`lm_evaluate` over ``trove`` with every route
    recorded (the dropped share at each padded length), then K1 held
    against its plain version at every shape those runs gave it."""
    with RouteLog() as routes, K1Calls() as calls:
        lm_evaluate(dev, card, name, lm, trove, paths, tag=tag, pairs=pairs)
    print(f"[p] {tag} {name}: token-slots the capacity dropped, by padded "
          f"length: {routes.shares()}")
    if {(q, c, d) for q, _, c, d, _ in calls.shapes} != {
            (Q, C, lm["cfg"].d_model)}:
        fail(f"{tag} {name}: K1 calls {sorted(calls.shapes)}")
    for q, s, _, d, k in sorted(calls.shapes):
        k1_held(dev, q, s, d, f"{tag} {name}", timed=False, k=k)


def moe_ties(dev, card: str, lm: dict, trove: dict) -> None:
    """(p1): the tie rule on one real bf16 batch, the first P1_TIE_TEXTS
    passages, every layer's route held (:class:`RouteLog`)."""
    passages = list(trove["corpus"].values())[:P1_TIE_TEXTS]
    ev = trove_evaluator(dev, lm)
    with RouteLog(ties=True) as routes:
        ev._encode_texts(passages, False, device=True)
    broken, tied = int(sum(routes.broken)), int(sum(routes.tied))
    if broken:
        fail(f"(p1) tie rule: {broken} tokens chose a higher expert than "
             f"an unchosen equal one")
    print(f"[p] (p1) tie rule on one bf16 batch of {len(passages)} "
          f"passages on {card}: {routes.tokens} token-layers routed, "
          f"{tied} with an unchosen expert equal to the k-th chosen "
          f"({tied / routes.tokens:.4f}), every one of them with the lower "
          f"indices chosen; dropped {routes.shares()}")


def query_rungs(ev, texts) -> list:
    """The padded length each query of ``texts`` is encoded at when they
    are encoded together (the pipeline's own grouping: rows sorted by
    length, batches of the query batch size, each padded to the rung of
    its longest row)."""
    import numpy as np
    pipe = ev.encode_pipeline
    max_len = ev.collator.max_len_for(True)
    enc = pipe.tokenize(texts, max_len, ev.retriever.format_query)
    lengths = np.array([len(e) for e in enc])
    b = pipe._batch_dim(len(enc), ev.args.query_batch_size)
    order = np.argsort(lengths, kind="stable")
    out = [0] * len(enc)
    for lo in range(0, len(enc), b):
        idx = order[lo: lo + b]
        rung = pipe._fit(max(lengths[idx].max(), 1), pipe.ladder(max_len))
        for i in idx:
            out[i] = rung
    return out


def moe_served_rungs(tag: str, served: ServedLog) -> str:
    """Each served query against a search of it alone: the same padded
    length gives the same embedding; where its request padded it longer
    than it pads alone (mixed rungs), the capacity may drop other tokens
    and its ids move.  Counts the mixed queries and their top-K overlap
    with the served row (not held: the reference pads alike)."""
    import numpy as np
    backend = served.frontends[0].backend
    ev, prepared = backend.ev, backend.prepared
    mixed, overlaps, same_err = 0, [], 0.0
    for (texts, fut) in served.requests:
        ids, vals = fut.result(timeout=D_RESULT_S)
        together = query_rungs(ev, texts)
        for j, text in enumerate(texts):
            alone_ids, alone_vals = ev.search_texts([text], prepared)
            if query_rungs(ev, [text])[0] == together[j]:
                same_err = max(same_err, check_exact(
                    f"{tag} query at its request's rung vs alone",
                    ids[j: j + 1], vals[j: j + 1], alone_ids, alone_vals))
                continue
            mixed += 1
            overlaps.append(len(set(ids[j]) & set(alone_ids[0])) / K)
    n = sum(len(t) for t, _ in served.requests)
    moved = (f"top-{K} overlap with the served row mean "
             f"{np.mean(overlaps):.3f}, min {min(overlaps):.3f}"
             if overlaps else "none moved")
    return (f"{n - mixed} of {n} queries at their request's rung alone "
            f"too, each within {same_err:.3g} of its solo search (tol "
            f"{TOL}); {mixed} mixed rungs: {moved}")


def moe_launchers(dev, card: str, paths: dict, tmp: str) -> None:
    """(p4): ``serve.main --arch granite-moe-3b-a800m`` at ``--workers 1``
    on its own data dir, each request within TOL of a solo search of the
    same queries (one encode batch: the same padded length), each query
    against a search of it alone where its padded length is the same,
    and the mixed ones counted; K1 held at every shape; then
    ``evalsuite.main --arch granite-moe-3b-a800m`` on its own root."""
    import contextlib
    import gc
    import io

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import evalsuite, serve

    cfg = get_arch(P_GRANITE).cfg
    rungs = [1]
    while rungs[-1] < P4_BATCH:
        rungs.append(2 * rungs[-1])
    data = os.path.join(tmp, "p4-serve")
    pin_superchunk(dev, cfg.d_model, rungs, K)
    out, served, calls = io.StringIO(), ServedLog(), K1Calls()

    def run():
        with contextlib.redirect_stdout(out), served, calls:
            return serve.main([
                "--arch", P_GRANITE, "--data-dir", data, "--device",
                dev.type, "--topk", str(K), "--n-requests",
                str(P4_REQUESTS), "--batch", str(P4_BATCH), "--max-batch",
                str(P4_BATCH), "--workers", "1"])

    t0 = time.perf_counter()
    try:
        stats = serving_path(
            paths, f"(p4) serve.main --arch {P_GRANITE} (fused, kernel)",
            run)
        corpus = [json.loads(line)["_id"] for line in open(
            os.path.join(data, "corpus.jsonl"))]
        held = check_served(f"(p4) serve.main --arch {P_GRANITE}", served,
                            corpus, P4_REQUESTS)
        wall = time.perf_counter() - t0
        alone = moe_served_rungs("(p4)", served)
    finally:
        served.close()
    fs = stats["frontend"]
    if fs["completed"] != P4_REQUESTS + len(rungs) or fs["failed"]:
        fail(f"(p4) serve: {json.dumps(fs)}")
    print(f"[p] (p4) serve.main --arch {P_GRANITE} on {card}: {wall:.1f} "
          f"s; {P4_REQUESTS} requests of {P4_BATCH}, p50 "
          f"{stats['p50_ms']:.3f} ms; each request {held}; {alone}")
    del served, stats, run
    gc.collect()
    torch.cuda.empty_cache()
    if {(q, c, dd, k) for q, _, c, dd, k in calls.shapes} != {
            (q, C, cfg.d_model, K) for q in rungs}:
        fail(f"(p4) serve: K1 calls {sorted(calls.shapes)}")
    for q, s, *_ in sorted(calls.shapes):
        k1_held(dev, q, s, cfg.d_model, "(p4) serve", timed=False)

    pin_superchunk(dev, cfg.d_model, (16, 32), 10)
    root = os.path.join(tmp, "p4-suite")
    out = io.StringIO()

    def suite():
        with contextlib.redirect_stdout(out):
            return evalsuite.main([
                "--arch", P_GRANITE, "--data-root", root, "--device",
                dev.type, "--out-dir", os.path.join(root, "out")])

    t0 = time.perf_counter()
    results = serving_path(
        paths, f"(p4) evalsuite.main --arch {P_GRANITE} (fused, kernel)",
        suite)
    if set(results) != {"d0", "d1", "combined"} or not all(
            0.0 <= m <= 1.0 for row in results.values()
            for m in row.values()):
        fail(f"(p4) evalsuite: {results}")
    print(f"[p] (p4) evalsuite.main --arch {P_GRANITE} on {card}: "
          f"{time.perf_counter() - t0:.1f} s, combined "
          f"{rounded(results['combined'])}")
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe(dev, card: str) -> tuple[dict, list]:
    """(p) the MoE FFN at published widths, bf16, seeded weights drawn on
    the card, each model freed before the next: (p1) granite-moe-3b-a800m
    evaluated and mined through K1 and K2 over (c)'s recipe at N1_DOCS
    docs, the dropped shares and the tie rule; (p2) granite trained by
    ``launch/train.py --arch`` (Adafactor), its ``train_4k`` cell, remat
    on against off; (p3) llama4-maverick at its published width cut to
    one (dense, MoE) pair, evaluated at O3_DOCS; (p4) the launchers; K1
    held and timed at d = 1536 and 5120.  Returns each path's launches
    and the K1 timings."""
    import dataclasses
    import gc
    import shutil

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import make_retrieval_dataset

    paths: dict = {}
    timings = []
    cuda = dev.type == "cuda"

    def freed():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        make_retrieval_dataset(data_dir, **L_DATA)
        troves = {}
        for key, n_docs in (("p1", N1_DOCS), ("p3", O3_DOCS)):
            queries, corpus, qrels = make_retrieval_dataset(
                os.path.join(tmp, key), n_queries=Q, n_docs=n_docs,
                n_topics=64, seed=SEED)
            troves[key] = {"queries": queries, "corpus": corpus,
                           "qrels": qrels}

        t0 = time.perf_counter()
        lm = lm_model(dev, P_GRANITE)
        moe_header(P_GRANITE, lm, card)
        moe_evaluate(dev, card, P_GRANITE, lm, troves["p1"], paths, "(p1)")
        moe_ties(dev, card, lm, troves["p1"])
        decode_turn(dev, card, P_GRANITE, lm, paths, "(p) MoE")
        d = lm["cfg"].d_model
        del lm
        freed()
        timings.append(k1_held(dev, Q, S, d, "(p1)", timed=True))
        print(f"[p] (p1) {P_GRANITE}: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        trainer, state, step_dir = o1_train(
            dev, card, P_GRANITE, "adafactor", data_dir, tmp, paths,
            tag="(p2)")
        shutil.rmtree(os.path.join(tmp, f"o1-{P_GRANITE}"))
        params = state["params"]
        del trainer, state
        freed()
        o2_cell(dev, card, P_GRANITE, params, paths, tag="(p2)")
        del params
        freed()
        o2_remat(dev, card, paths, name=P_GRANITE, tag="(p2)")
        freed()
        print(f"[p] (p2) {P_GRANITE}: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_arch(P_LLAMA4).cfg, n_layers=P3_LAYERS)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        lm = lm_model(dev, P_LLAMA4, cfg)
        peak = gib(torch.cuda.max_memory_allocated(dev)) if cuda else 0.0
        moe_header(P_LLAMA4, lm, card)
        print(f"[p] (p3) {P_LLAMA4} cut to {P3_LAYERS} layers: the draw's "
              f"peak {peak:.2f} GiB (a float32 copy of one (1, "
              f"{cfg.n_experts}, {cfg.d_model}, {cfg.moe_d_ff}) leaf "
              f"beside the bf16 weights)")
        moe_evaluate(dev, card, P_LLAMA4, lm, troves["p3"], paths, "(p3)",
                     pairs=P3_PAIRS)
        decode_turn(dev, card, P_LLAMA4, lm, paths, "(p) MoE", consume=True)
        del lm
        freed()
        timings.append(k1_held(dev, Q, S, cfg.d_model, "(p3)", timed=True))
        print(f"[p] (p3) {P_LLAMA4}: {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        moe_launchers(dev, card, paths, tmp)
        print(f"[p] (p4): {time.perf_counter() - t0:.1f} s")
    freed()
    return paths, timings


# -- (q) the KV-cache decode ---------------------------------------------------

# Each serve cell's cache holds seeded N(0, 1) values (a zeroed cache makes
# every softmax uniform) and steps Q_STEPS times from len = s - Q_STEPS, the
# tokens after the first greedy: one warm-up step, then Q_STEPS - 1 timed,
# so the last step attends to all s positions.  Cuts where a cache at the
# published shape does not fit beside the weights (cache bytes = layers x 2
# x KV heads x head_dim x 2 x B x S, at most 40 GiB where cut; PERF.md §4):
# decode_32k keeps its 32,768 positions and cuts its batch, long_500k keeps
# its 524,288 and cuts its depth; llama4 runs at (p3)'s one (dense, MoE)
# pair.  Q_CUTS: name -> shape -> (batch, layers; None for the model's).
Q_STEPS = 4
Q_SEQ = {"decode_32k": 32768, "long_500k": 524288}
Q_CUTS = {
    "qwen2-0.5b": {"decode_32k": (128, None), "long_500k": (1, None)},
    "stablelm-3b": {"decode_32k": (4, None), "long_500k": (1, 8)},
    "gemma-7b": {"decode_32k": (2, None), "long_500k": (1, 5)},
    "granite-moe-3b-a800m": {"decode_32k": (20, None),
                             "long_500k": (1, None)},
    "llama4-maverick-400b-a17b": {"decode_32k": (32, None),
                                  "long_500k": (1, None)},
}
# (q1): Q1_ROWS x Q1_LEN tokens decoded teacher-forced from an empty cache
# against lm_logits(forward_hidden) of the same tokens; the float32 run on
# float32 copies of the first Q1_F32_LAYERS layers (TF32 off), held to the
# reference test's tolerance (tests/test_models.py); an MoE's capacity
# factor raised to n_experts / top_k, so the prefill drops nothing
Q1_ROWS, Q1_LEN, Q1_F32_LAYERS = 2, 64, 4
Q1_RTOL, Q1_ATOL = 2e-2, 2e-4
# (q2): rows 0 and B - 1 of the batch-B step against a batch-1 step on the
# row's slice of the cache, the logits and the K / V written at len each
# within Q2_TOL of the row's largest magnitude (bf16 activations: cuBLAS
# sums other shapes in other orders, a bf16 ulp is 2^-8 of a value, and
# 24-32 layers carry it; a wrong row or position is off by O(1))
Q2_TOL = 5e-2
# (q) seconds, by the phase whose turn ran them
DECODE_SECONDS: dict = {}


def cut_depth(cfg, params, layers: int):
    """``cfg`` and ``params`` cut to their first ``layers`` layers (views
    of the same weights)."""
    import dataclasses
    cut = dataclasses.replace(cfg, n_layers=layers)
    out = dict(params)
    for stack, depth in (("blocks", cut.n_dense_layers),
                         ("moe_blocks", cut.n_moe_layers)):
        if stack in params:
            out[stack] = {k: t[:depth] for k, t in params[stack].items()}
    return cut, out


def weight_bytes(params, experts_read: float, cfg) -> float:
    """Bytes of weights one decode step reads: every leaf once, less the
    MoE experts no token chose (``experts_read``: the distinct experts of
    the step summed over its MoE layers)."""
    from repro_torch.training import tree
    total = sum(t.nbytes for t in tree.leaves(params))
    if "moe_blocks" in params:
        routed = sum(params["moe_blocks"][k].nbytes
                     for k in ("we_gate", "we_up", "we_down"))
        per_expert = routed / (cfg.n_moe_layers * cfg.n_experts)
        total += experts_read * per_expert - routed
    return total


class ExpertLog:
    """The experts each ``transformer._moe_token`` call chose (``choices``,
    (tokens, k) each) and how many distinct ones it read (``calls``),
    recorded by wrapping it in the script: the route recomputed from its
    inputs (the same product, softmax and stable sort) and kept on the
    card, read only after the steps."""

    def __enter__(self):
        import torch

        from repro_torch.models import transformer
        self.calls, self.choices = [], []
        inner = self.inner = transformer._moe_token

        def wrapped(cfg, lp, h):
            probs = torch.softmax((h.reshape(-1, h.shape[-1])
                                   @ lp["router"]).float(), -1)
            choice = torch.sort(probs, dim=-1, descending=True,
                                stable=True).indices[:, : cfg.top_k]
            seen = torch.zeros(cfg.n_experts, device=h.device)
            self.calls.append(seen.index_fill_(0, choice.flatten(), 1).sum())
            self.choices.append(choice)
            return inner(cfg, lp, h)

        transformer._moe_token = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer._moe_token = self.inner

    def per_step(self, steps: int) -> float:
        return sum(float(c) for c in self.calls) / steps if steps else 0.0


def trace_decode(cell, params, cache, tokens, card: str, tag: str) -> None:
    """One more decode step (len set back one) under torch.profiler's CUDA
    activity: wall ms against the device's busy ms (so its idle share) and
    the device operations that took the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cache["len"].sub_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cell.fn(params, cache, tokens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ops) / 1e3
    if busy <= 0:
        print(f"[q] {tag} traced step on {card}: {wall:.3f} ms, device "
              f"time not measured (the profiler recorded none)")
        return
    top = "; ".join(f"{e.key[:60]} x{e.count} "
                    f"{e.self_device_time_total / 1e3:.3f} ms"
                    for e in ops[:6])
    print(f"[q] {tag} traced step (torch.profiler) on {card}: {wall:.3f} "
          f"ms wall, device busy {busy:.3f} ms (idle share "
          f"{1 - busy / wall:.3f}), {sum(e.count for e in ops)} device "
          f"operations; the most time: {top}")


def decode_cell(dev, card: str, name: str, cfg, params, shape: str,
                paths: dict, checks: list, trace: bool = False) -> None:
    """One serve cell at its cut (Q_CUTS): Q_STEPS steps through the
    LMArch cell from seeded cache values, timed in CUDA events; (q2) rows
    0 and B - 1 of the last step against batch-1 steps on their slices of
    the cache, (q3) sampled positions other than len unchanged and len
    advanced, (q4) finite (B, V) logits on every step."""
    import torch

    from repro_torch.configs.lm_arch import LM_SHAPES, LMArch
    from repro_torch.models import transformer
    from repro_torch.training import tree

    cuda = dev.type == "cuda"
    b, layers = Q_CUTS[name][shape]
    full_b = LM_SHAPES[shape]["global_batch"]
    s = Q_SEQ[shape]
    whole, whole_params = cfg.n_layers, params
    if layers is not None:
        cfg, params = cut_depth(cfg, params, layers)
    tag = f"(q) {name} {shape}"
    arch = LMArch(cfg, shapes={shape: dict(kind="serve", seq_len=s,
                                           global_batch=b)})
    cell = arch.build_cell(shape, dev)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    # alive before the cell: the weights, and what the phase around it
    # holds
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    cache, tokens = arch.smoke_inputs(
        shape, torch.Generator(device=dev).manual_seed(SEED), dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cache["k"].normal_(generator=g)
    cache["v"].normal_(generator=g)
    cache["len"].fill_(s - Q_STEPS)
    cache_bytes = cache["k"].nbytes + cache["v"].nbytes
    per_token = cache_bytes / (b * s)
    param_bytes = sum(t.nbytes for t in tree.leaves(params))
    # a cut model's weights are views: the whole model stays alive
    alive_bytes = sum(t.nbytes for t in tree.leaves(whole_params))
    base = base or alive_bytes
    scores = b * cfg.n_heads * s * 4
    transient = max(2 * scores + 2 * transformer.DECODE_CHUNK_BYTES,
                    transformer.LOGIT_BLOCK_BYTES
                    + 2 * b * cfg.vocab_size * 4)
    reckoned = base + cache_bytes + transient
    print(f"[q] {tag}: {cfg.n_layers} of {whole} layers, B = {b}, S = {s}: "
          f"cache {per_token:,.0f} B a token x {b} x {s} = "
          f"{gib(cache_bytes):.2f} GiB (whole shape: "
          f"{gib(per_token / cfg.n_layers * whole * full_b * s):,.1f}"
          f" GiB), weights {gib(param_bytes):.2f} GiB; alive before the "
          f"cell {gib(base):.2f} GiB (the whole model's weights "
          f"{gib(alive_bytes):.2f}); peak reckoned "
          f"{gib(reckoned):.2f} GiB (+ float32 scores and probabilities "
          f"{gib(2 * scores):.3f}, a float32 K / V chunk "
          f"{gib(transformer.DECODE_CHUNK_BYTES):.2f} x 2, or the logits "
          f"and a vocabulary block)")
    samples = sorted({0, 1, s // 2, s - 2})
    state = {}

    def run():
        toks, ms, logits = tokens, [], None
        with ExpertLog() as experts:
            for i in range(Q_STEPS):
                if i == Q_STEPS - 1:
                    state["before"] = [(cache["k"][:, :, p].clone(),
                                        cache["v"][:, :, p].clone())
                                       for p in samples]
                    state["tokens"] = toks
                    mark = len(experts.choices)
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                t0 = time.perf_counter()
                logits, out = cell.fn(params, cache, toks)
                if cuda:
                    end.record()
                    torch.cuda.synchronize()
                    ms.append(start.elapsed_time(end))
                else:
                    ms.append((time.perf_counter() - t0) * 1e3)
                if out is not cache:
                    checks.append(f"{tag}: the step returned another cache")
                if logits.shape != (b, cfg.vocab_size) or not bool(
                        torch.isfinite(logits).all()):
                    checks.append(f"{tag}: step {i} logits "
                                  f"{tuple(logits.shape)}, not finite "
                                  f"(B, V)")
                toks = logits.argmax(-1).to(torch.int32)
        state["experts"] = experts.per_step(Q_STEPS)
        state["routes"] = experts.choices[mark:]
        return ms, logits

    ms, logits = on_path(paths, tag, None, run, no_launches)
    peak = gib(torch.cuda.max_memory_allocated(dev)) if cuda else 0.0
    step = statistics.median(ms[1:])
    # (q3): positions other than len untouched; len one more
    pos = s - 1
    moved = [p for p, (k, v) in zip(samples, state["before"])
             if not (torch.equal(cache["k"][:, :, p], k)
                     and torch.equal(cache["v"][:, :, p], v))]
    if moved or int(cache["len"]) != s:
        checks.append(f"{tag} (q3): positions {moved} changed, len "
                      f"{int(cache['len'])} (want {s})")
    # (q2): rows 0 and B - 1 against batch-1 steps on their slices.  An
    # MoE row whose route differs somewhere between the two steps (bf16
    # sums in other orders move a router logit across the k-th expert's)
    # computes another function from that layer on: its K / V are held up
    # to and including the first such layer (computed before its FFN),
    # its logits only where no layer's route differs
    written = (cache["k"][:, :, pos].clone(), cache["v"][:, :, pos].clone())
    moe_layers = [i for i, (m, _) in enumerate(
        transformer._stack_order(cfg, params)) if m]
    worst = {"logits": 0.0, "kv": 0.0}
    agree, flipped = 0, {}
    for r in sorted({0, b - 1}):
        row = {"k": cache["k"][:, r: r + 1], "v": cache["v"][:, r: r + 1],
               "len": torch.tensor(pos, dtype=torch.int32, device=dev)}
        with ExpertLog() as one_log:
            one, _ = cell.fn(params, row, state["tokens"][r: r + 1])
        flips = [layer for layer, mine, theirs in zip(
            moe_layers, one_log.choices, state["routes"])
            if set(mine[0].tolist()) != set(theirs[r].tolist())]
        flipped[r] = flips
        upto = flips[0] + 1 if flips else cfg.n_layers
        agree += int(one[0].argmax() == logits[r].argmax())
        if not flips:
            worst["logits"] = max(worst["logits"], float(
                (one[0] - logits[r]).abs().max()) / float(
                    logits[r].abs().max()))
        for got, want in zip((row["k"][:upto, 0, pos],
                              row["v"][:upto, 0, pos]),
                             (written[0][:upto, r], written[1][:upto, r])):
            worst["kv"] = max(worst["kv"], float(
                (got.float() - want.float()).abs().max()) / float(
                    want.float().abs().max()))
    if not max(worst.values()) <= Q2_TOL:
        checks.append(f"{tag} (q2): batch-1 rows off by {worst} (routes "
                      f"differing at MoE layers {flipped})")
    experts = state["experts"]
    read = weight_bytes(params, experts, cfg) if cfg.moe else param_bytes
    from repro_torch.launch.roofline import HBM_BW
    bound = (cache_bytes + read) / HBM_BW * 1e3
    print(f"[q] {tag} on {card}: step {step:.3f} ms (median of "
          f"{len(ms) - 1}, {'CUDA events' if cuda else 'host clock'}; "
          f"warm-up {ms[0]:.3f}), {b / step * 1e3:,.1f} tokens/s, cache "
          f"read at {cache_bytes / step / 1e6:,.1f} GB/s; bound "
          f"{bound:.3f} ms (cache {gib(cache_bytes):.2f} GiB + weights "
          f"read {gib(read):.2f} GiB"
          + (f", {experts:.1f} distinct experts a step over "
             f"{cfg.n_moe_layers} MoE layers" if cfg.moe else "")
          + f", at 3.35 TB/s), {step / bound:.1f}x it; peak {peak:.2f} GiB "
          f"(reckoned {gib(reckoned):.2f})")
    routes = ("" if not cfg.moe else
              f", routes differing at MoE layers {flipped} (the logits of "
              f"such a row not held, its K / V up to the first)")
    print(f"[q] {tag} (q2) rows {sorted({0, b - 1})} against batch-1 steps "
          f"on their cache slices: logits off by {worst['logits']:.3g}, "
          f"K / V at len by {worst['kv']:.3g} of the row's largest (tol "
          f"{Q2_TOL}){routes}, argmax equal {agree} of {len({0, b - 1})}; (q3) "
          f"{len(samples)} sampled positions unchanged, len {s - 1} -> "
          f"{int(cache['len'])}; (q4) {Q_STEPS} steps' logits finite "
          f"({b}, {cfg.vocab_size})")
    if trace and cuda:
        trace_decode(cell, params, cache, state["tokens"], card, tag)
    del cache


def decode_vs_prefill(dev, card: str, name: str, cfg, params, paths: dict,
                      checks: list, f32: bool) -> None:
    """(q1): Q1_ROWS x Q1_LEN seeded tokens decoded teacher-forced through
    the serve cell from an empty cache, against lm_logits of
    forward_hidden over the same tokens; ``f32``: float32 copies of the
    first Q1_F32_LAYERS layers (those of ``params`` itself where it is
    float32 already), held to Q1_RTOL / Q1_ATOL."""
    import dataclasses

    import torch

    from repro_torch.configs.lm_arch import LMArch
    from repro_torch.models import transformer

    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        if transformer.capacity(cfg, Q1_LEN) < Q1_LEN:
            fail(f"(q1) {name}: capacity {transformer.capacity(cfg, Q1_LEN)}"
                 f" drops at {Q1_LEN} tokens")
    if f32:
        if cfg.n_layers > Q1_F32_LAYERS:
            cfg, params = cut_depth(cfg, params, Q1_F32_LAYERS)
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        params = {k: ({n: t.float() for n, t in v.items()}
                      if isinstance(v, dict) else v.float())
                  for k, v in params.items()}
    kind = "float32" if f32 else str(cfg.dtype).replace("torch.", "")
    arch = LMArch(cfg, shapes={"decode_32k": dict(
        kind="serve", seq_len=Q1_LEN, global_batch=Q1_ROWS)})
    cell = arch.build_cell("decode_32k", dev)
    toks = torch.randint(3, cfg.vocab_size, (Q1_ROWS, Q1_LEN),
                         generator=torch.Generator(device=dev).manual_seed(
                             SEED), device=dev, dtype=torch.int32)

    def run():
        cache = transformer.init_cache(cfg, Q1_ROWS, Q1_LEN, dev)
        steps = [cell.fn(params, cache, toks[:, t])[0]
                 for t in range(Q1_LEN)]
        with torch.no_grad():
            hidden, _ = transformer.forward_hidden(cfg, params, toks,
                                                   torch.ones_like(toks))
            full = transformer.lm_logits(cfg, params, hidden)
        return torch.stack(steps, 1), full

    dec, full = on_path(paths, f"(q1) {name} {kind} decode vs prefill",
                        None, run, no_launches)
    diff = (dec - full).abs()
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    line = (f"[q] (q1) {name} {kind}, {cfg.n_layers} layers"
            + (f", capacity factor {cfg.capacity_factor:g}"
               if cfg.moe else "")
            + f": {Q1_ROWS} x {Q1_LEN} tokens decoded from an empty cache "
            f"against the prefill's logits on {card}: largest |diff| "
            f"{float(diff.max()):.3g} (logits up to "
            f"{float(full.abs().max()):.3g}), argmax equal at {agree:.4f} "
            f"of the positions")
    if f32:
        ok = bool((diff <= Q1_ATOL + Q1_RTOL * full.abs()).all())
        print(f"{line} (tol rtol {Q1_RTOL}, atol {Q1_ATOL}: "
              f"{'within' if ok else 'OUTSIDE'})")
        if not ok:
            checks.append(f"(q1) {name} float32: decode off the prefill by "
                          f"{float(diff.max())}")
    else:
        print(line)
        if not bool(torch.isfinite(dec).all()):
            checks.append(f"(q1) {name} {kind}: logits not finite")


def float_leaf(tree: dict, key: str, dev) -> None:
    """``tree[key]`` replaced by its float32 copy.  On the card the old
    leaf's block goes back to the driver after (the next, larger float32
    leaf may not fit a cached one); where the copy would not fit beside
    its source (llama4's 20 GiB expert leaves, at the card's edge), the
    source goes through host memory first and comes back 2^28 entries at a
    time."""
    import torch
    t = tree[key]
    if dev.type != "cuda":
        tree[key] = t.float()
        return
    if torch.cuda.mem_get_info(dev)[0] > t.numel() * 4 + 2 ** 30:
        tree[key] = t.float()
    else:
        host = t.cpu()
        tree[key] = None
        del t
        torch.cuda.empty_cache()
        out = torch.empty(host.shape, dtype=torch.float32, device=dev)
        src, dst = host.reshape(-1), out.view(-1)
        for lo in range(0, src.numel(), 1 << 28):
            dst[lo: lo + (1 << 28)] = src[lo: lo + (1 << 28)].to(dev)
        tree[key] = out
    t = None
    torch.cuda.empty_cache()


def decode_turn(dev, card: str, name: str, lm: dict, paths: dict,
                phase: str, consume: bool = False) -> None:
    """(q) for one arch while its weights are alive in another phase's
    turn: both serve cells (qwen2-0.5b's decode_32k traced), then (q1) in
    the model dtype at full depth and in float32.  ``consume``: the
    float32 copy replaces the bf16 weights leaf by leaf, so both never
    exist at once (llama4's pair: 65 GiB in float32); ``lm`` is spent
    then.  Its seconds are kept apart under "(q) decode"."""
    import gc

    import torch

    t0 = time.perf_counter()
    cuda = dev.type == "cuda"
    cfg, params = lm["cfg"], lm["params"]
    checks: list = []
    parts = {}
    for shape in Q_SEQ:
        t = time.perf_counter()
        decode_cell(dev, card, name, cfg, params, shape, paths, checks,
                    trace=name == "qwen2-0.5b" and shape == "decode_32k")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        parts[shape] = time.perf_counter() - t
    t = time.perf_counter()
    decode_vs_prefill(dev, card, name, cfg, params, paths, checks,
                      f32=False)
    parts["(q1) bf16"] = time.perf_counter() - t
    t = time.perf_counter()
    if consume:
        gc.collect()
        for stack in params.values():
            if isinstance(stack, dict):
                for k in list(stack):
                    float_leaf(stack, k, dev)
        for k in [k for k, v in params.items() if not isinstance(v, dict)]:
            float_leaf(params, k, dev)
        if cuda:
            torch.cuda.empty_cache()
    decode_vs_prefill(dev, card, name, cfg, params, paths, checks, f32=True)
    if cuda:
        torch.cuda.empty_cache()
    parts["(q1) float32"] = time.perf_counter() - t
    seconds = time.perf_counter() - t0
    DECODE_SECONDS[phase] = DECODE_SECONDS.get(phase, 0.0) + seconds
    print(f"[q] {name}: {seconds:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    if checks:
        fail("; ".join(checks))


# -- (r) the GNN: graphsage-reddit's train cells, its kernels, node search ----

R_ARCH = "graphsage-reddit"
R_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
# (r1): a warm-up step, then timed steps, in each of two runs from SEED
R_WARM, R_STEPS = 1, 3
# minibatch_lg's graph: Reddit's node count with 25 in-edges a node (the
# published 114.6 M edges would take ~7 GB of host memory in
# make_random_graph's candidate array)
R_REDDIT_NODES, R_REDDIT_DEGREE = 232_965, 25
# (r2): K4T's plain version builds a (D,) product for each entry whose id
# is below its rows (ogb_products' 61.9 M entries would take 32 GB twice
# over), so the whole call is held against it on ranges of this many
# gradient rows; timed calls at the largest shapes
R_HELD_ROWS, R_BIG_BYTES, R_BIG_N = 1 << 18, 1 << 30, 5
# (r3): query nodes (the first anchors of ``pairs``) searched over every
# node of ogb_products, and the exact top-k's row block
R_QUERIES, R_EXACT_BLOCK = 256, 1 << 18
# the cell one more step of which is traced after the last phase
R_TRACED = "ogb_products"


def gnn_launches(mode: str, n_layers: int, steps: int) -> dict:
    """Each kernel's launches on a GNN path: K4 per neighbour mean (one a
    layer a graph) and for the ``pairs`` rows of a full graph; K4T per
    mean of a layer past the first (whose input, the features, takes no
    gradient) and for the ``pairs`` rows; the minibatch none; K1, K2
    never."""
    graphs = {"full": 1, "batched": 2, "minibatch": 0}[mode]
    pairs = int(mode == "full")
    return {"fused_score_topk": 0, "topk_update": 0,
            "embedding_bag": steps * (graphs * n_layers + pairs),
            "embedding_bag_backward": steps * (graphs * (n_layers - 1)
                                               + pairs)}


class BagCalls:
    """The inputs of the first K4 / K4T call at each shape a path makes,
    recorded by wrapping ``embedding_bag.embedding_bag_`` and
    ``embedding_bag_backward_`` here, in the script (the wrappers still
    count each launch once): {(kernel, B, L, V, D, weighted): (table or
    gradient, idx, weights, V, K4T's ``keys`` or None)}.  The tensors are
    held, not copied."""

    def __init__(self):
        self.calls: dict = {}

    def __enter__(self):
        from repro_torch.kernels import embedding_bag as bag
        self._orig = fwd, bwd = (bag.embedding_bag_,
                                 bag.embedding_bag_backward_)

        def k4(out, table, idx, weights=None):
            key = ("K4", *idx.shape, table.shape[0], table.shape[1],
                   weights is not None)
            self.calls.setdefault(key, (table, idx, weights,
                                        table.shape[0], None))
            return fwd(out, table, idx, weights)

        def k4t(out, grad_out, idx, weights=None, *, keys=None):
            key = ("K4T", *idx.shape, out.shape[0], out.shape[1],
                   weights is not None)
            self.calls.setdefault(key, (grad_out, idx, weights,
                                        out.shape[0], keys))
            return bwd(out, grad_out, idx, weights, keys=keys)

        bag.embedding_bag_, bag.embedding_bag_backward_ = k4, k4t
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import embedding_bag as bag
        bag.embedding_bag_, bag.embedding_bag_backward_ = self._orig


def gnn_batch(dev, arch, shape: str) -> tuple[dict, dict]:
    """One cell's inputs at the published shape, drawn on the card: a
    full graph's or the batched graphs' from ``smoke_inputs`` with a
    seeded ``torch.Generator``; the minibatch's sampled by the port's
    ``NeighborSampler`` (the anchors, their positives by
    ``positive_pairs``, both 2-hop blocks) over ``make_random_graph(
    R_REDDIT_NODES, R_REDDIT_DEGREE)``, its features drawn on the card and
    gathered there by the sampled ids.  Returns (batch, notes)."""
    import numpy as np
    import torch

    from repro_torch.data import graph

    spec = arch.shapes[shape]
    g = torch.Generator(device=dev).manual_seed(SEED)
    if spec["mode"] != "minibatch":
        return arch.smoke_inputs(shape, g, dev), {}
    t0 = time.perf_counter()
    src, dst, _ = graph.make_random_graph(R_REDDIT_NODES, R_REDDIT_DEGREE,
                                          SEED)
    csr = graph.CSRGraph.from_edges(src, dst, R_REDDIT_NODES)
    sampler = graph.NeighborSampler(csr, spec["fanouts"], SEED)
    anchors = np.random.default_rng(SEED).choice(
        R_REDDIT_NODES, spec["batch_nodes"], replace=False)
    positives = sampler.positive_pairs(anchors)
    x = torch.randn((R_REDDIT_NODES, spec["d_feat"]), generator=g,
                    device=dev)
    batch = {}
    for side, nodes in (("a", anchors), ("p", positives)):
        for k, f in enumerate(sampler.sample_block(x, nodes)):
            batch[f"{side}{k}"] = f
    del x
    return batch, {"graph_edges": int(src.size),
                   "host_s": time.perf_counter() - t0}


def gnn_reckoned(arch, shape: str, batch: dict, width: int) -> float:
    """Peak bytes reckoned before a run, for a graph of N nodes (each view
    of the batched graphs alike): the inputs; the neighbour table (its
    int32 ids, and K4T's sorted keys and order); the tensors the backward
    keeps (layer 0's mean over the features, each later layer's mean, each
    layer's output, z: 4 (N, d)); and at the first backward the largest
    transient, four (N, d) gradients beside the stable sort of the ids
    (int32 keys, int64 order, the sort's double buffers: ~24 bytes a
    slot).  AdamW's state and the minibatch's blocks are small beside
    their inputs."""
    cfg = arch.shape_cfg(shape)
    spec = arch.shapes[shape]
    held = sum(t.numel() * t.element_size() for t in batch.values())
    if spec["mode"] == "minibatch":
        b, (f1, _) = spec["batch_nodes"], spec["fanouts"]
        return held + 2 * 4 * 4 * b * (1 + f1) * cfg.d_hidden
    if spec["mode"] == "full":
        n, sides = batch["x"].shape[0], 1
    else:
        n, sides = spec["n_graphs"] * spec["n_nodes"], 2
    nd = 4 * n * cfg.d_hidden
    per_graph = (12 * n * width + 4 * n * cfg.d_feat + 4 * nd
                 + 4 * nd + 24 * n * width)
    return held + sides * per_graph


def gnn_runs(dev, card: str, arch, shape: str, paths: dict,
             calls: BagCalls) -> dict:
    """(r1) one cell: R_WARM + R_STEPS steps in each of two runs from
    SEED (weights drawn on the card), the second run's parameters and
    losses bitwise the first's; step ms split by StepMarks (the forward's
    end is the loss's), peak GiB against its reckoning.  A full graph's
    runs each build its neighbour table once and carry it in the batch,
    as a caller of the cell keeps it; the batched graphs' steps build
    theirs, as a step over new graphs must.  Returns the first run's
    parameters, its batch and the table width."""
    import numpy as np
    import torch

    from repro_torch.configs.base import init_train_state
    from repro_torch.models import gnn
    from repro_torch.models.losses import InfoNCELoss

    spec = arch.shapes[shape]
    cfg = arch.shape_cfg(shape)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what the phase holds before the cell ((r)'s kept graphs, the traced
    # cell) counts in the peak too
    before = torch.cuda.memory_allocated()
    batch, notes = gnn_batch(dev, arch, shape)

    def with_table():
        if spec["mode"] != "full":
            return batch
        t0 = time.perf_counter()
        table = gnn.neighbor_table(batch["edge_src"], batch["edge_dst"],
                                   batch["x"].shape[0])
        torch.cuda.synchronize()
        notes["table_s"] = time.perf_counter() - t0
        return {**batch, "table": table}

    width, first = 0, with_table()
    if spec["mode"] == "full":
        t = first["table"]
        width = t.idx.shape[1]
        print(f"[r] (r1) {shape}: N = {t.n_nodes:,} nodes, E = "
              f"{t.n_edges:,} edges, neighbour table {t.n_nodes:,} x "
              f"{width} = {t.slots:,} slots ({t.slots / t.n_edges:.3f} a "
              f"edge, {t.slots * 4 / 1e9:.3f} GB of int32 ids), built in "
              f"{notes['table_s'] * 1e3:.3f} ms (host clock, once a run)")
        del t
    elif spec["mode"] == "batched":
        t = gnn.batched_table(batch["aedges"], batch["aemask"],
                              spec["n_nodes"])
        width = t.idx.shape[1]
        print(f"[r] (r1) {shape}: {spec['n_graphs']} graphs x "
              f"{spec['n_nodes']} nodes, a view's table {t.n_nodes} x "
              f"{width} = {t.slots} slots for {t.n_edges} edges")
        del t
    else:
        print(f"[r] (r1) {shape}: {spec['batch_nodes']} anchors and their "
              f"positives, fanouts {spec['fanouts']}, sampled over "
              f"{R_REDDIT_NODES:,} nodes / {notes['graph_edges']:,} edges "
              f"(graph, CSR and sampling {notes['host_s']:.2f} s on the "
              f"host)")
    reckoned = before + gnn_reckoned(arch, shape, batch, width)
    print(f"[r] (r1) {shape}: peak reckoned {gib(reckoned):.2f} GiB (the "
          f"{gib(before):.2f} GiB held before the cell included; run 2 "
          f"also holds run 1's first K4 / K4T inputs for (r2)"
          + (" and its table)" if spec["mode"] == "full" else ")"))
    steps = R_WARM + R_STEPS
    runs = []
    for run_no in (1, 2):
        run_batch = first if run_no == 1 else with_table()
        torch.cuda.reset_peak_memory_stats()
        params = gnn.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        cell = arch.build_cell(shape, dev)
        state = init_train_state(cell, params)
        marks = StepMarks(forward=(InfoNCELoss, "__call__"))

        def run(cell=cell, state=state, marks=marks, run_batch=run_batch):
            with marks:
                out = train_steps(cell, state, run_batch, steps, marks)
            torch.cuda.synchronize()
            return out

        path = f"(r1) gnn train {shape} run {run_no} x {steps}"
        with calls if run_no == 1 else contextlib.nullcontext():
            metrics = on_path(
                paths, path, None if spec["mode"] == "minibatch"
                else "embedding_bag", run,
                lambda _: gnn_launches(spec["mode"], cfg.n_layers, steps))
        loss = [float(m["loss"]) for m in metrics]
        if not np.isfinite(loss).all():
            fail(f"{path}: losses {loss} not finite")
        split = {"forward": [], "backward": [], "update": [], "total": []}
        for s0, f, c, s1 in marks.splits[R_WARM:]:
            split["forward"].append(s0.elapsed_time(f))
            split["backward"].append(f.elapsed_time(c))
            split["update"].append(c.elapsed_time(s1))
            split["total"].append(s0.elapsed_time(s1))
        med = {k: statistics.median(v) for k, v in split.items()}
        peak = torch.cuda.max_memory_allocated()
        per_step = {k: v // steps for k, v in paths[path].items() if v}
        print(f"[r] (r1) {shape} run {run_no} on {card}: losses "
              f"{[round(x, 6) for x in loss]}; step median "
              f"{med['total']:.3f} ms (CUDA events, steps "
              f"{R_WARM + 1}-{steps}: forward and loss "
              f"{med['forward']:.3f} + backward {med['backward']:.3f} + clip "
              f"and AdamW {med['update']:.3f}), steps ms "
              f"{[round(x, 3) for x in split['total']]}; peak "
              f"{gib(peak):.2f} GiB (reckoned {gib(reckoned):.2f}); "
              f"launches a step {json.dumps(per_step)}")
        runs.append((loss, {k: v.clone() for k, v in
                            state["params"].items()}))
        del state, cell, marks, metrics, run_batch
    (l1, p1), (l2, p2) = runs
    differ = [k for k in p1 if not torch.equal(p1[k], p2[k])]
    if l1 != l2 or differ:
        fail(f"(r1) {shape}: two runs from seed {SEED} differ: losses "
             f"{l1} / {l2}, parameters {differ}")
    print(f"[r] (r1) {shape}: two runs of {steps} steps from seed {SEED}: "
          f"losses and all {len(p1)} parameters bitwise equal (no "
          f"deterministic-algorithms switch)")
    if shape == R_TRACED:
        cell = arch.build_cell(shape, dev)
        state = init_train_state(cell, {k: v.clone() for k, v in
                                        p1.items()})
        cell.fn(state, first)          # a warm-up on run 1's table
        STEP_TRACES.append(lambda: gnn_trace(cell, state, first, card,
                                             shape))
    return {"params": p1, "batch": first, "width": width}


def gnn_trace(cell, state, batch, card: str, shape: str) -> None:
    """One more step of a GNN cell under torch.profiler's CUDA activity
    (after the last phase, with the other traces): wall ms against the
    device's busy ms (its idle share) and the device operations that took
    the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cell.fn(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in ops) / 1e3
    if busy <= 0:
        print(f"[r] (r1) {shape} traced step on {card}: {wall:.3f} ms, "
              f"device time not measured (the profiler recorded none)")
        return
    top = "; ".join(f"{e.key[:60]} x{e.count} "
                    f"{e.self_device_time_total / 1e3:.3f} ms"
                    for e in ops[:8])
    print(f"[r] (r1) {shape} traced step (torch.profiler) on {card}: "
          f"{wall:.3f} ms wall, device busy {busy:.3f} ms (idle share "
          f"{1 - busy / wall:.3f}), {sum(e.count for e in ops)} device "
          f"operations; the most time: {top}")


def k4_bag_timing(dev, key, table, idx, weights) -> dict:
    """K4 at one recorded GNN shape: the wrapper's call, its plain
    version, one F.embedding_bag (sum, ``per_sample_weights`` the slot
    weights where there are any) and the bound (bytes: the ids and
    weights, the rows they touch and the output; operations: 2 D a slot,
    padding included, which reads the zero row)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import ref, topk
    from repro_torch.launch.roofline import bound_ms
    b, n_slots = idx.shape
    v, d = table.shape
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    lib_idx = idx.long()
    rows = int(torch.unique(idx[(idx >= 0) & (idx < v)]).numel())
    cost = bag.bag_cost(b, n_slots, d, 4, weights is not None, rows)
    nbytes = cost[1]
    bound, bound_by = bound_ms(cost)
    n = R_BIG_N if b * d * 4 >= R_BIG_BYTES // 8 else 30

    def nothing():
        pass

    t = {"shape": f"GNN {key[0]} B={b} L={n_slots} V={v} D={d}"
                  f"{' weighted' if weights is not None else ''}",
         "plan": list(bag.bag_plan(b, n_slots, d, 4, topk.sm_count(dev))),
         "slots": b * n_slots,
         "ms": median_ms(lambda: bag.embedding_bag_(out, table, idx,
                                                   weights), nothing, n=n),
         "plain_ms": median_ms(lambda: ref.embedding_bag_ref(
             table, idx, weights), nothing, n=min(n, 3)),
         "library_ms": median_ms(lambda: F.embedding_bag(
             lib_idx, table, mode="sum", per_sample_weights=weights),
             nothing, n=n),
         "bound_ms": bound, "bound_bytes": nbytes, "bound_by": bound_by}
    print(f"[r] (r2) embedding_bag at {t['shape']} ({rows} distinct rows, "
          f"{b * n_slots:,} slots, padding included, plan "
          f"{t['plan']}): kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, library (F.embedding_bag) "
          f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']})")
    return t


def rows_of(idx, lo: int, hi: int):
    """``idx`` with every id outside gradient rows [lo, hi) moved past
    them (K4T's plain version drops such ids; padding, id < 0, adds to
    row 0 and stays where lo = 0) and the rest shifted by lo: the plain
    version on it gives rows [lo, hi) of the whole gradient, adding each
    row's entries in the same flat order."""
    import torch
    inside = (idx < hi) & ((idx >= lo) | (lo == 0))
    return torch.where(inside, idx - lo, hi - lo)


def k4t_held(name: str, got, grad, idx, weights, v: int) -> None:
    """K4T's whole gradient ``got`` (V, D) against its plain version,
    bitwise, R_HELD_ROWS rows at a time (each range's plain call builds
    only its own entries)."""
    from repro_torch.kernels import ref
    for lo in range(0, v, R_HELD_ROWS):
        hi = min(v, lo + R_HELD_ROWS)
        sub = idx if (lo, hi) == (0, v) else rows_of(idx, lo, hi)
        bag_compare(f"{name} rows {lo}-{hi}", got[lo:hi],
                    ref.embedding_bag_backward_ref(grad, sub, hi - lo,
                                                   weights), kernel="K4T")


def k4t_bag_timing(dev, key, grad, idx, weights, v: int, nonpad: int,
                   keys) -> dict:
    """K4T at one recorded GNN shape: the wrapper's whole call (its sort
    of the ids, then the kernel, which writes the (V, D) gradient once),
    the sort alone and the call on the path's kept ``BagKeys`` (what a
    full graph's train step pays: the caller sorts a graph once), beside
    its plain version (on gradient rows [0, R_HELD_ROWS) of the whole
    call where V is larger), the backward of one F.embedding_bag over the
    whole ids (autograd.grad, graph kept) and the bound (bytes: the ids
    and weights, the gradient read and the dense output written once;
    operations: 2 D a slot that is not padding, which the kernel
    skips)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import ops, ref, topk
    from repro_torch.launch.roofline import bound_ms
    b, n_slots = idx.shape
    d = grad.shape[1]
    out = torch.empty((v, d), dtype=grad.dtype, device=dev)
    cost = bag.bag_backward_cost(b, n_slots, v, d, 4, weights is not None,
                                 nonpad)
    nbytes = cost[1]
    bound, bound_by = bound_ms(cost)
    n = R_BIG_N if v * d * 4 >= R_BIG_BYTES // 8 else 30

    def nothing():
        pass

    # the library's table holds the zero row the padding ids (V) point at
    lib_table = torch.zeros((v + 1, d), device=dev, requires_grad=True)
    lib_out = F.embedding_bag(idx.long(), lib_table, mode="sum",
                              per_sample_weights=weights)
    if keys is None:
        keys = ops.BagKeys(idx)
    keys.sorted()
    t = {"shape": f"GNN {key[0]} B={b} L={n_slots} V={v} D={d}"
                  f"{' weighted' if weights is not None else ''}",
         "plan": list(bag.backward_plan(v, d, 4, topk.sm_count(dev))),
         "slots": b * n_slots, "not_padding": nonpad,
         "ms": median_ms(lambda: bag.embedding_bag_backward_(
             out, grad, idx, weights), nothing, n=n),
         "sort_ms": median_ms(lambda: bag.backward_keys(idx), nothing, n=n),
         "shared_sort_ms": median_ms(lambda: bag.embedding_bag_backward_(
             out, grad, idx, weights, keys=keys), nothing, n=n),
         "library_ms": median_ms(lambda: torch.autograd.grad(
             lib_out, lib_table, grad, retain_graph=True), nothing, n=n),
         "bound_ms": bound, "bound_bytes": nbytes, "bound_by": bound_by}
    del lib_out, lib_table
    rows = min(v, R_HELD_ROWS)
    sub = idx if rows == v else rows_of(idx, 0, rows)
    t["plain_ms"] = median_ms(lambda: ref.embedding_bag_backward_ref(
        grad, sub, rows, weights), nothing, n=min(n, 3))
    if rows < v:
        t["plain_rows"] = rows
    print(f"[r] (r2) embedding_bag_backward at {t['shape']} ({nonpad:,} of "
          f"{b * n_slots:,} slots not padding, plan {t['plan']}): whole "
          f"call {t['ms']:.4f} ms (its sort alone {t['sort_ms']:.4f}; the "
          f"call on the path's kept sort, as a full graph's train step "
          f"makes it, {t['shared_sort_ms']:.4f}), library (F.embedding_bag "
          f"backward, dense) {t['library_ms']:.4f} ms, bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']}); plain "
          f"{t['plain_ms']:.4f} ms"
          + (f" on gradient rows [0, {rows:,}) of the whole call"
             if rows < v else ""))
    return t


def gnn_kernels_held(dev, calls: BagCalls) -> tuple[list, list]:
    """(r2) K4 and K4T at every shape (r1) gave them, on the inputs of
    that shape's first call: bitwise equal to the plain version (phase
    (b)'s rule, tolerance 0).  K4T's whole call as the path makes it
    (every bag, the path's kept ``BagKeys``) is held on every gradient
    row, R_HELD_ROWS rows at a time, and the call that sorts its own ids
    gives the same bits; then each timed.  Returns (K4 timings, K4T
    timings)."""
    import torch

    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import ref
    k4, k4t = [], []
    for key, (x, idx, weights, v, keys) in sorted(
            calls.calls.items(), key=lambda kv: str(kv[0])):
        kind, b, n_slots = key[:3]
        name = f"(r2) GNN {kind} B={b} L={n_slots} V={v} D={key[4]}"
        if kind == "K4":
            got = torch.empty((b, x.shape[1]), dtype=x.dtype, device=dev)
            bag.embedding_bag_(got, x, idx, weights)
            bag_compare(name, got, ref.embedding_bag_ref(x, idx, weights))
            torch.cuda.synchronize()
            print(f"[r] {name}: bitwise equal to the plain version")
            del got
            k4.append(k4_bag_timing(dev, key, x, idx, weights))
        else:
            got = torch.empty((v, x.shape[1]), dtype=x.dtype, device=dev)
            bag.embedding_bag_backward_(got, x, idx, weights, keys=keys)
            k4t_held(name, got, x, idx, weights, v)
            own = torch.empty_like(got)
            bag.embedding_bag_backward_(own, x, idx, weights)
            if not torch.equal(bits(own), bits(got)):
                fail(f"K4T {name}: the call that sorts its own ids differs "
                     f"from the call on the path's kept sort")
            torch.cuda.synchronize()
            print(f"[r] {name}: the whole call on the path's "
                  f"{'kept' if keys is not None else 'own'} sort bitwise "
                  f"equal to the plain version on all {v:,} gradient rows"
                  + (f" ({R_HELD_ROWS:,} at a time)" if v > R_HELD_ROWS
                     else "") + ", and to the call that sorts its own ids")
            del got, own
            # K4T skips the padding, ids past its V rows
            nonpad = int((idx < v).sum())
            k4t.append(k4t_bag_timing(dev, key, x, idx, weights, v, nonpad,
                                      keys))
        torch.cuda.empty_cache()
    return k4, k4t


def exact_topk_device(q, rows, k: int):
    """Exact float64 top-k of ``q @ rows.T`` on the card, in blocks of
    R_EXACT_BLOCK rows -> (ids, values as float32), numpy."""
    import torch
    q64 = q.double()
    best_v = best_i = None
    for lo in range(0, rows.shape[0], R_EXACT_BLOCK):
        s = q64 @ rows[lo:lo + R_EXACT_BLOCK].double().T
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        i = i + lo
        if best_v is not None:
            v, pos = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], 1), 1, pos)
        best_v, best_i = v, i
    return best_i.cpu().numpy(), best_v.float().cpu().numpy()


def gnn_search(dev, card: str, arch, ogb: dict, small: dict,
               paths: dict) -> list:
    """(r3) node retrieval: ``GNNEncoder.encode`` over ogb_products' graph
    with (r1)'s trained parameters, then R_QUERIES query nodes searched
    over every node through ``ShardedSearchDriver`` at (fused, kernel), k =
    K, S, C: the ids against an exact float64 top-k where separated, the
    scores within TOL; K1 held at each shape the search gave it and timed
    at d = 128.  On full_graph_sm's nodes, all nine score x heap pairs:
    each score's three heaps bitwise equal, each within TOL of the exact
    top-k.  Returns K1's timing rows."""
    import numpy as np
    import torch

    from repro_torch.core.sharded_search import ShardedSearchDriver
    from repro_torch.models.encoder import GNNEncoder

    shape = "ogb_products"
    cfg = arch.shape_cfg(shape)
    b = ogb["batch"]                     # with (r1)'s neighbour table
    enc = GNNEncoder(cfg)
    t0 = time.perf_counter()

    def encode():
        with torch.no_grad():
            z = enc.encode(ogb["params"], b)
        torch.cuda.synchronize()
        return z

    # no pairs gathered and no backward: K4 once a layer
    z = on_path(paths, f"(r3) GNNEncoder.encode {shape}", "embedding_bag",
                encode, lambda _: {**gnn_launches("minibatch", 0, 0),
                                   "embedding_bag": cfg.n_layers})
    enc_s = time.perf_counter() - t0
    norms = z.norm(dim=1)
    zero = int((norms == 0).sum())
    if (z.shape != (b["x"].shape[0], cfg.d_hidden)
            or not bool(torch.isfinite(z).all())
            or float((norms[norms > 0] - 1).abs().max()) > TOL):
        fail(f"(r3) encode: z {tuple(z.shape)} not finite unit rows")
    print(f"[r] (r3) GNNEncoder.encode over {shape}'s {z.shape[0]:,} nodes "
          f"with (r1)'s trained parameters: {enc_s:.3f} s (host clock), z "
          f"{tuple(z.shape)} finite, unit rows ({zero} all-zero rows)")
    torch.cuda.empty_cache()
    q = z[b["pairs"][:R_QUERIES, 0].long()].contiguous()
    drv = ShardedSearchDriver(score_impl="fused", heap_impl="kernel",
                              chunk_size=C, superchunk_size=S, device=dev)

    def search():
        out = drv.search(q, z.shape[0], lambda lo, hi: z[lo:hi], K)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    with K1Calls() as k1:
        vals, ids = on_path(paths, f"(r3) node search {shape} (fused, "
                            f"kernel)", "fused_score_topk", search,
                            lambda _: predict([drv.stats], "fused",
                                              "kernel"))
    search_s = time.perf_counter() - t0
    want_i, want_v = exact_topk_device(q, z, K)
    err = check_exact("(r3) node search vs exact float64 top-k", ids, vals,
                      want_i, want_v)
    self_hits = float((ids[:, 0] == b["pairs"][:R_QUERIES, 0].cpu().numpy()
                       ).mean())
    print(f"[r] (r3) {R_QUERIES} query nodes over {z.shape[0]:,} nodes, k = "
          f"{K}, S = {S}, C = {C}: {drv.stats['dispatch_rounds']} K1 calls, "
          f"{search_s:.3f} s (host clock); ids equal the exact float64 "
          f"top-k where separated, max score error {err:.3g} (tol {TOL}); "
          f"each query's own node first in {self_hits:.4f} of the rows; K1 "
          f"shapes {sorted(k1.shapes)}")
    timings = []
    for (qn, s, c, d, k) in sorted(k1.shapes):
        t = k1_held(dev, qn, s, d, "(r3)", timed=(qn, s) == (R_QUERIES, S),
                    k=k)
        if t is not None:
            timings.append(t)
    del z, q, drv
    torch.cuda.empty_cache()

    # full_graph_sm: every score x heap pair on the trained small graph
    cfg = arch.shape_cfg("full_graph_sm")
    sb = small["batch"]
    with torch.no_grad():
        zs = GNNEncoder(cfg).encode(small["params"], sb)
    qs = zs[sb["pairs"][:R_QUERIES, 0].long()].contiguous()
    want_i, want_v = exact_topk_device(qs, zs, K)
    ties = 0
    for score in ("numpy", "torch", "fused"):
        outs = {heap: ShardedSearchDriver(
            score_impl=score, heap_impl=heap, chunk_size=C,
            superchunk_size=S, device=dev).search(
                qs, zs.shape[0], lambda lo, hi: zs[lo:hi], K)
            for heap in ("python", "torch", "kernel")}
        (v, i), (pv, pi) = outs["torch"], outs["python"]
        if not (np.array_equal(outs["kernel"][0], v)
                and np.array_equal(outs["kernel"][1], i)):
            fail(f"(r3) full_graph_sm ({score}, kernel) != ({score}, torch) "
                 f"bitwise")
        # heapq keeps the larger id on an exact tie (core/result_heap.py),
        # the device heaps the earlier candidate: ids equal where unique
        tied = np.zeros(v.shape, bool)
        tied[:, 1:] |= v[:, 1:] == v[:, :-1]
        tied[:, :-1] |= v[:, :-1] == v[:, 1:]
        if not (np.array_equal(pv, v) and np.array_equal(pi[~tied],
                                                         i[~tied])):
            fail(f"(r3) full_graph_sm ({score}, python) differs from "
                 f"({score}, torch) in values or in ids off exact ties")
        ties = max(ties, int(tied.sum()))
        check_exact(f"(r3) full_graph_sm {score} vs exact", i, v, want_i,
                    want_v)
    print(f"[r] (r3) full_graph_sm's {zs.shape[0]:,} nodes, {R_QUERIES} "
          f"queries, k = {K}: for each score impl its kernel heap == its "
          f"torch heap bitwise, and its python heap equal in values and in "
          f"ids off exact ties (up to {ties} tied slots: z is sparse after "
          f"ReLU); each score impl within {TOL} of the exact float64 "
          f"top-k, ids equal where separated")
    return timings


def phase_gnn(dev, card: str) -> tuple[dict, dict]:
    """(r) graphsage-reddit: (r1) its four train cells at published shape,
    (r2) K4 and K4T at every shape they gave, (r3) node search.  Returns
    (each path's launch counts, {kernel: timing rows})."""
    import torch

    from repro_torch.configs import get_arch

    arch = get_arch(R_ARCH)
    paths: dict = {}
    k4, k4t = [], []
    kept = {}
    for shape in R_SHAPES:
        calls = BagCalls()
        kept[shape] = gnn_runs(dev, card, arch, shape, paths, calls)
        a, b = gnn_kernels_held(dev, calls)
        k4 += a
        k4t += b
        del calls
        if shape not in ("ogb_products", "full_graph_sm"):
            del kept[shape]
        torch.cuda.empty_cache()
    k1 = gnn_search(dev, card, arch, kept["ogb_products"],
                    kept["full_graph_sm"], paths)
    del kept
    torch.cuda.empty_cache()
    return paths, {"embedding_bag": k4, "embedding_bag_backward": k4t,
                   "fused_score_topk": k1}


# -- (s) the analysis tools ----------------------------------------------------

# (s1) the dry run's 40 cells, counted on meta in a pool of S_WORKERS
# spawned processes (the host's cores; nothing reaches the card), each
# record held complete; (s2) three cells one card holds, stepped on the
# card and counted there under CostMode against a meta count of the same
# cell at the same shape: qwen2-0.5b train_4k at (o2)'s batch, DeepFM's
# train_batch (K4 and K4T), graphsage-reddit's minibatch_lg
S_WORKERS = 6
# modules a meta count imports on its first op (shape inference, the
# decompositions, symbolic shapes: ~840 modules, up to 14 s a process on
# a cold host): the pool's fork server imports them once, and each worker
# forks from it warm
S_PRELOAD = ("torch._dynamo", "torch._refs", "torch._prims", "torch._decomp",
             "torch._meta_registrations",
             "torch.fx.experimental.symbolic_shapes", "sympy",
             "repro_torch.launch.dryrun")
S2_CELLS = (("qwen2-0.5b", "train_4k"), ("deepfm", "train_batch"),
            ("graphsage-reddit", "minibatch_lg"))
S2_STEPS = 3
# the record keys every dry-run record carries (the reference's, less the
# compile's)
S_RECORD_KEYS = ("arch", "shape", "kind", "n_devices", "memory", "cost",
                 "collectives", "roofline", "flops_source",
                 "model_flops_global", "useful_compute_ratio", "wall_s")


def host_read_file(arch, shape: str) -> str | None:
    """The port's file in which a cell's step reads a device value on the
    host (so the dry run substitutes an analytic count): an LM serve
    cell's ``decode_step``, a full graph's or the batched graphs'
    neighbour table; None where the step is counted."""
    spec = arch.shapes[shape]
    if arch.family == "lm" and spec["kind"] == "serve":
        return "src/repro_torch/models/transformer.py"
    if arch.family == "gnn" and spec["mode"] in ("full", "batched"):
        return "src/repro_torch/models/gnn.py"
    return None


def s2_arch(name: str):
    """A (s2) cell's arch: qwen2-0.5b's train_4k cut to (o2)'s batch."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_arch import LMArch
    arch = get_arch(name)
    if name != "qwen2-0.5b":
        return arch
    return LMArch(arch.cfg, arch.optimizer, shapes={"train_4k": dict(
        arch.shapes["train_4k"], global_batch=O2_BATCH[name])})


def s1_check(rec: dict, arch) -> None:
    """A dry-run record complete, its FLOPs positive and its
    ``flops_source`` the one its step gives."""
    tag = f"(s1) {rec.get('arch')} {rec.get('shape')}"
    missing = [k for k in S_RECORD_KEYS if k not in rec]
    cost = rec.get("cost", {})
    if missing or not {"flops", "flops_by_dtype", "bytes"} <= set(cost) \
            or "model" not in rec.get("memory", {}) \
            or not cost["flops"] > 0 or rec["n_devices"] != 1:
        fail(f"{tag}: record incomplete (missing {missing}, cost {cost})")
    where = host_read_file(arch, rec["shape"])
    src = rec["flops_source"]
    if (src != "counted") if where is None else not src.startswith(
            f"analytic: {where}:"):
        fail(f"{tag}: flops_source {src!r}, expected "
             f"{'counted' if where is None else where}")


def s2_inputs(dev, name: str, arch, shape: str):
    """(params, batch) of a (s2) cell on the card: seeded weights drawn
    there, the batch as the earlier phases draw it ((o2)'s token rows,
    (m)'s DeepFM ids, (r1)'s sampled minibatch)."""
    import numpy as np
    import torch

    from repro_torch.models import gnn, recsys, transformer
    g = torch.Generator(device=dev).manual_seed(SEED)
    if arch.family == "lm":
        params = transformer.init_params(arch.cfg, g, dev)
        return params, arch.smoke_inputs(shape, g, dev)
    if arch.family == "recsys":
        params = recsys.init_params(arch.cfg, g, dev)
        return params, arch.smoke_inputs(shape, np.random.default_rng(SEED),
                                         dev)
    params = gnn.init_params(arch.shape_cfg(shape), g, dev)
    return params, gnn_batch(dev, arch, shape)[0]


def s2_cell(dev, card: str, name: str, shape: str, meta_of,
            paths: dict) -> None:
    """(s2) one cell on the card: a warm step, one step under CostMode
    (its FLOPs by dtype, bytes and kernel reports equal to those of the
    dry run's count of the same cell on meta, ``meta_of()``),
    S2_STEPS steps in CUDA events, the peak over the last one; the step
    against its roofline bound (counted, and with ``analytic_bytes``) and
    the peak against the memory model."""
    import torch

    from repro_torch.configs.base import init_train_state
    from repro_torch.launch import report
    from repro_torch.launch.roofline import CostMode
    arch = s2_arch(name)
    held = torch.cuda.memory_allocated(dev)
    t = time.perf_counter()
    params, batch = s2_inputs(dev, name, arch, shape)
    cell = arch.build_cell(shape, device=dev)
    state = init_train_state(cell, params)
    torch.cuda.synchronize(dev)
    mode = CostMode()
    ms = []
    wall = {"inputs": time.perf_counter() - t}

    def run():
        for label, ctx in (("warm", contextlib.nullcontext()),
                           ("counted", mode)):
            t = time.perf_counter()
            with ctx:
                cell.fn(state, batch)
            torch.cuda.synchronize(dev)
            wall[label] = time.perf_counter() - t
        for i in range(S2_STEPS):
            if i == S2_STEPS - 1:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            cell.fn(state, batch)
            end.record()
            torch.cuda.synchronize(dev)
            ms.append(start.elapsed_time(end))

    steps = 2 + S2_STEPS
    want = (bag_launches("deepfm", steps, steps) if name == "deepfm"
            else no_launches(None))
    on_path(paths, f"(s2) {name} {shape}",
            "embedding_bag" if name == "deepfm" else None, run,
            lambda _: want)
    peak = torch.cuda.max_memory_allocated(dev)
    card_cost = mode.cost()
    meta = meta_of()
    for key in ("flops_by_dtype", "bytes"):
        if card_cost[key] != meta["cost"][key]:
            fail(f"(s2) {name} {shape}: the card's {key} {card_cost[key]} "
                 f"!= meta's {meta['cost'][key]}")
    if mode.kernels != meta["kernels"]:
        fail(f"(s2) {name} {shape}: the card's kernel reports "
             f"{mode.kernels} != meta's {meta['kernels']}")
    terms = meta["roofline"]
    counted_ms = terms["step_lower_bound_s"] * 1e3
    rm = report.enrich(dict(meta), arch=arch)["roofline_model"]
    model_ms = rm["step_lower_bound_s"] * 1e3
    step = statistics.median(ms)
    mm = meta["memory"]["model"]
    print(f"[s] (s2) {name} {shape} on {card}: card count = meta count "
          f"(FLOPs {json.dumps(card_cost['flops_by_dtype'])}, "
          f"{card_cost['bytes']:,} bytes, {card_cost['transfer_bytes']:,} "
          f"host-link bytes, kernels {json.dumps(mode.kernels)}; inputs "
          f"{wall['inputs']:.2f} s, the warm step {wall['warm']:.2f} s, the counted one {wall['counted']:.2f} "
          f"s on the host clock); step ms "
          f"{' / '.join(f'{x:.3f}' for x in ms)} (CUDA events, median "
          f"{step:.3f}); bound {counted_ms:.3f} ms counted "
          f"({terms['dominant']}), {model_ms:.3f} ms with "
          f"analytic_bytes ({rm['dominant']}); step / bound "
          f"{step / counted_ms:.2f} / {step / model_ms:.2f}; peak "
          f"{gib(peak):.2f} GiB over one step, {gib(peak - held):.2f} of "
          f"it the cell's ({gib(held):.2f} held before it), against "
          f"memory_model "
          f"{gib(mm['total_bytes']):.2f} GiB (state + args "
          f"{gib(mm['state_and_args_bytes']):.2f}, grad "
          f"{gib(mm['grad_transient_bytes']):.2f}, activations "
          f"{gib(mm['activation_bytes']):.2f})")
    del params, batch, state, cell
    torch.cuda.empty_cache()


def phase_tools(dev, card: str) -> dict:
    """(s) the analysis tools: (s1) ``dryrun.run_cell`` for all 40 cells at
    published shape on meta, in a pool of processes forked from a fork
    server (a fresh interpreter, no thread or CUDA context of this one)
    that imported S_PRELOAD, each record
    checked and ``report.table`` printed as one line; (s2) three cells
    stepped on the card, each counted under CostMode there and held equal
    to its meta count, timed against its roofline bound, its peak against
    the memory model.  The pool counts (s2)'s meta cells too, while the
    first (s2) cell runs on the card.  Returns each path's launch
    counts."""
    import concurrent.futures
    import multiprocessing

    import torch

    from repro_torch.configs import all_cells, get_arch
    from repro_torch.launch import dryrun, report

    paths: dict = {}
    t0 = time.perf_counter()
    done: list = []
    cells = all_cells()
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(list(S_PRELOAD))
    # one thread a worker: the counts run no parallel region, and idle
    # intra-op threads of many processes would crowd the host's cores
    # the longest counts first: the deepest LM stacks' train cells, then
    # their prefills
    def cost_rank(i):
        arch = get_arch(cells[i][0])
        if arch.family != "lm":
            return 2, 0
        kind = arch.shapes[cells[i][1]]["kind"]
        return {"train": 0, "encode": 1}.get(kind, 2), -arch.cfg.n_layers

    futs: dict = {}

    def submit_all():
        """The submits, on a thread: the first waits for the fork server
        to import S_PRELOAD, while the card steps (s2)'s first cell."""
        for c in S2_CELLS:
            futs[c] = pool.submit(dryrun.run_cell, *c, arch=s2_arch(c[0]))
        for i in sorted(range(len(cells)), key=cost_rank):
            futs[i] = pool.submit(dryrun.run_cell, *cells[i])
            futs[i].add_done_callback(
                lambda _: done.append(time.perf_counter()))

    def result(key):
        feeder.join()
        return futs[key].result()

    with concurrent.futures.ProcessPoolExecutor(
            S_WORKERS, mp_context=ctx, initializer=torch.set_num_threads,
            initargs=(1,)) as pool:
        feeder = threading.Thread(target=submit_all)
        feeder.start()
        try:
            s2_cell(dev, card, *S2_CELLS[0],
                    lambda: result(S2_CELLS[0]), paths)
        finally:
            feeder.join()
        card_s = time.perf_counter() - t0
        recs = [futs[i].result() for i in range(len(cells))]
        metas = {c: futs[c].result() for c in S2_CELLS[1:]}
    # the fork server outlives the pool: stop it too
    server = getattr(multiprocessing.forkserver, "_forkserver", None)
    if server is not None and hasattr(server, "_stop"):
        server._stop()
    pool_s = time.perf_counter() - t0
    for rec in recs:
        s1_check(rec, get_arch(rec["arch"]))
        r, mm = rec["roofline"], rec["memory"]["model"]
        print(f"[s] (s1) {rec['arch']} {rec['shape']}: FLOPs "
              f"{rec['cost']['flops']:.4e} {rec['flops_source']}, bytes "
              f"{rec['cost']['bytes']:.4e}, memory {mm['total_bytes'] / 1e9:.2f}"
              f" GB{'' if mm['fits_80GB'] else ' (!)'}, bound "
              f"{r['step_lower_bound_s'] * 1e3:.3f} ms ({r['dominant']}), "
              f"counted in {rec['wall_s']:.1f} s")
    table = report.table([report.enrich(r) for r in recs])
    print(f"[s] (s1) {len(recs)} cells on meta in {max(done) - t0:.1f} s "
          f"({S_WORKERS} processes, beside (s2)'s first cell on the card, "
          f"{card_s:.1f} s; both {pool_s:.1f} s), for one H100 ({card}): "
          f"report.table {json.dumps(table)}")
    for c in S2_CELLS[1:]:
        s2_cell(dev, card, *c, lambda c=c: metas[c], paths)
    return paths


# -- (t) the device mesh: four rank processes on the one card ------------------

# A (data 2, model 2) mesh of T_WORLD rank processes (this script with
# ``--t-rank``) over a gloo group on the one card.  (t1) DeepFM train_batch
# at published shape on the psum lookup, (t2) qwen2-0.5b's train_4k cell
# at published width cut to T2_LAYERS layers, batch T2_BATCH, then one
# dp_mode="shard_map" int8 trainer step, (t3) the (t2) state saved on
# (2, 2) and restored onto (4, 1) and onto this process.
T_WORLD, T_SHAPE, T_AXES = 4, (2, 2), ("data", "model")
T_JOIN_S = 420
T_STEPS = 2
T1_ARCH, T2_ARCH = "deepfm", "qwen2-0.5b"
T2_LAYERS, T2_BATCH, T2_LEN = 2, 4, 4096
# Tolerances of a meshed step against the one-process oracle, keyed by
# the step's dtype, on the state after one AdamW step (t_against_oracle):
#   * loss: relative, over the first ``loss_steps`` steps (float32: sums
#     in other orders, every step; bf16: products of other shapes, the
#     first step: its states differ by the bf16 roundings below, and a
#     step at temperature 0.02 moves the loss by half; (t2f), the same LM
#     in float32, holds both);
#   * float32, entry by entry: each gradient (the first moment over
#     1 - b1) within ``moment`` x (the sum of |its terms| + T_FLOOR x the
#     slice's largest such sum) where the oracle counts the terms
#     (DeepFM's table rows: the bf16-rounded cotangents of the rows'
#     lookups; 2^-7 is one bf16 unit of a term whose float32 cotangent
#     rounds the other way, the floor a cotangent that cancels in
#     float32), else x (|itself| + T_FLOOR x its slice's largest)
#     (float32 sums in other orders); the second moment within what that
#     gradient tolerance allows a square.  A parameter whose oracle
#     gradient is clear of zero (its tolerance cannot flip the sign, and
#     the two Adam directions g / (|g| + eps) differ by at most
#     T_STEP_ATOL) within T_STEP_ATOL x lr of the oracle's plus its
#     rounding (``ulps`` units of float32); where both gradients are 0,
#     within its rounding (the same decay); elsewhere within 2 lr plus
#     rounding (opposite directions), on at most ``unclear`` of the
#     entries that have a gradient;
#   * bfloat16, leaf by leaf: each moment's error within ``norm`` (four
#     bf16 units) of the oracle's moment in the 2-norm (the gradients are
#     bf16 products whose inputs differ by bf16 roundings: entry errors
#     near the entry itself; (t2f) holds the same path entry by entry); a
#     parameter whose gradients are both 0 within its rounding (one bf16
#     unit and 4 of float32), every other within 2 lr plus rounding.
T_TOL = {"float32": dict(loss=1e-5, loss_steps=T_STEPS, moment=2 ** -7,
                         ulps=4, unclear=2e-2),
         "bfloat16": dict(loss=2e-2, loss_steps=1, norm=2 ** -5, ulps=1)}
T_FLOOR = 2 ** -10
T_STEP_ATOL = 2 ** -4
T_LR = 1e-3
T_CHUNK = 1 << 24           # entries a float64 piece of the leaf check
T_SLOW_N = 10               # timed calls of K4T and its library (~13 ms)
T_REDUCED = False           # the reduced archs (a CPU rehearsal)


def t_archs(reduced: bool):
    """(t1)'s DeepFM on the psum lookup and (t2)'s cut qwen2-0.5b (AdamW,
    train_4k at T2_LEN tokens, batch T2_BATCH), in its dtype (bf16) and
    in float32."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_arch import LMArch
    from repro_torch.configs.recsys_arch import RecSysArch

    rec, lm = get_arch(T1_ARCH), get_arch(T2_ARCH)
    if reduced:
        rec, lm = rec.reduced(), lm.reduced()
    deepfm = RecSysArch(dataclasses.replace(rec.cfg, embedding_impl="psum"),
                        shapes=rec.shapes)
    cfg = dataclasses.replace(lm.cfg, n_layers=T2_LAYERS)
    shapes = {"train_4k": dict(kind="train", seq_len=T2_LEN,
                               global_batch=T2_BATCH)}
    qwen = LMArch(cfg, "adamw", shapes=shapes)
    qwen32 = LMArch(dataclasses.replace(cfg, dtype=torch.float32), "adamw",
                    shapes=shapes)
    return deepfm, qwen, qwen32


def t_inputs(dev, deepfm, qwen, qwen32):
    """Seeded weights drawn on the card and the global batches."""
    import numpy as np
    import torch

    from repro_torch.models import recsys, transformer

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED)

    return {"deepfm": lambda: recsys.init_params(deepfm.cfg, gen(), dev),
            "qwen": lambda: transformer.init_params(qwen.cfg, gen(), dev),
            "qwen32": lambda: transformer.init_params(qwen32.cfg, gen(),
                                                      dev),
            "deepfm_batch": deepfm.smoke_inputs(
                "train_batch", np.random.default_rng(SEED), dev),
            "qwen_batch": qwen.smoke_inputs("train_4k", gen(), dev)}


class _RoundBF16:
    """x -> bf16 -> float32, the cotangent likewise (the psum lookup's
    casts and their transpose): an autograd Function made on first use."""
    fn = None

    @classmethod
    def apply(cls, x):
        import torch
        if cls.fn is None:
            class Fn(torch.autograd.Function):
                @staticmethod
                def forward(ctx, t):
                    return t.to(torch.bfloat16).float()

                @staticmethod
                def backward(ctx, g):
                    return g.to(torch.bfloat16).float()
            cls.fn = Fn
        return cls.fn.apply(x)


def deepfm_oracle_loss(cfg, abs_sums: dict | None = None):
    """The one-process test oracle of (t1): DeepFM's forward as the
    reference computes it on a mesh — the looked-up rows rounded to bf16
    (cotangent too), the linear term and FM sum over them — on the whole
    batch with whole tables; BCE.  While ``abs_sums["armed"]``, a
    backward puts there each table's sums of |its rows' rounded
    cotangents| (the terms of each row's gradient)."""
    import torch

    from repro_torch.models import recsys
    from repro_torch.models.losses import BCELoss
    bce = BCELoss()

    def lookup(params, name, idx):
        rows = params[name][idx]
        if abs_sums and abs_sums.get("armed") and rows.requires_grad:
            def add(g, table=params[name]):
                # g: the cotangent after _RoundBF16's rounding
                acc = torch.zeros_like(table)
                acc.index_add_(0, idx.reshape(-1),
                               g.abs().reshape(-1, table.shape[1]))
                abs_sums[name] = acc
            rows.register_hook(add)
        return _RoundBF16.apply(rows)

    def loss_fn(params, b):
        idx = b["sparse_idx"]
        n = idx.shape[0]
        emb = lookup(params, "table", idx)
        lin = lookup(params, "linear_table", idx)[..., 0].sum(-1)
        sum_v = emb.sum(1)
        fm = 0.5 * ((sum_v * sum_v) - (emb * emb).sum(1)).sum(-1)
        deep = recsys._mlp(params, emb.reshape(n, -1),
                           recsys._n_mlp(cfg))[:, 0]
        return bce(lin + fm + deep + params["bias"][0], b["labels"])

    return loss_fn


def t_save_tree(d: str, tree) -> None:
    """Each tensor leaf as ``d/<path>.npy`` (bf16 as its int16 bits)."""
    import numpy as np
    import torch

    from repro_torch.training.tree import flatten
    os.makedirs(d, exist_ok=True)
    dtypes = {}
    for path, t in flatten(tree):
        t = t.detach()
        dtypes[path] = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        np.save(os.path.join(d, path.replace("/", ".") + ".npy"),
                t.cpu().numpy())
    with open(os.path.join(d, "dtypes.json"), "w") as f:
        json.dump(dtypes, f)


def t_index(spec, shape, coords: dict, sizes: dict) -> tuple:
    """The slices that pick, from a leaf of ``shape``, the piece the rank
    at mesh ``coords`` (axis -> index, over axis ``sizes``) holds under
    ``spec``: a dimension split over axes (a, b) is a-major."""
    from repro_torch.sharding.partitioning import spec_axes
    index = []
    for dim, d in enumerate(shape):
        n, i = 1, 0
        for a in spec_axes(spec[dim] if dim < len(spec) else None):
            i, n = i * sizes[a] + coords[a], n * sizes[a]
        index.append(slice(i * (d // n), (i + 1) * (d // n)))
    return tuple(index)


def t_load_slice(d: str, path: str, spec, coords: dict, sizes: dict, dev):
    """This rank's slice of an oracle leaf under ``spec``, read through a
    memory map (only its bytes)."""
    import numpy as np
    import torch
    with open(os.path.join(d, "dtypes.json")) as f:
        dtype = json.load(f)[path]
    arr = np.load(os.path.join(d, path.replace("/", ".") + ".npy"),
                  mmap_mode="r")
    t = torch.from_numpy(np.array(arr[t_index(spec, arr.shape, coords,
                                              sizes)])).to(dev)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def t_oracle(dev, deepfm, qwen, qwen32, out_dir: str) -> dict:
    """The parent's one-process steps on the same weights and batches:
    (t1) DeepFM with the lookup rounded to bf16, (t2) the cut LM's
    train_4k cell in bf16 and (t2f) in float32, and the int8 step (the
    averaged gradient quantized, its residual kept, then clip and AdamW),
    each state written under ``out_dir`` for the ranks to read their
    slices of."""
    import torch

    from repro_torch.configs.base import init_train_state, make_train_cell
    from repro_torch.training import grad_compression as gc
    from repro_torch.training.optimizer import (OptimizerConfig,
                                                adamw_init, adamw_update,
                                                clip_by_global_norm)
    from repro_torch.training.tree import flatten, unflatten

    inp = t_inputs(dev, deepfm, qwen, qwen32)
    out = {}
    t0 = time.perf_counter()
    abs_sums: dict = {"armed": True}
    cell = make_train_cell(T1_ARCH, "train_batch",
                           loss_fn=deepfm_oracle_loss(deepfm.cfg, abs_sums),
                           optimizer="adamw")
    for part, params, batch in (
            ("t1", inp["deepfm"], inp["deepfm_batch"]),
            ("t2", inp["qwen"], inp["qwen_batch"]),
            ("t2f", inp["qwen32"], inp["qwen_batch"])):
        if part != "t1":
            cell = (qwen if part == "t2" else qwen32).build_cell(
                "train_4k", dev)
        state = init_train_state(cell, params())
        # the state after the first step, which the ranks hold theirs
        # against, and every step's loss
        _, m = cell.fn(state, batch)
        losses = [float(m["loss"])]
        t_save_tree(os.path.join(out_dir, part), state)
        if part == "t1":
            # the terms' sums in gradient units: clipped as the gradient
            clip = min(1.0, OptimizerConfig().grad_clip
                       / max(float(m["grad_norm"]), 1e-9))
            t_save_tree(os.path.join(out_dir, "t1abs"), {
                k: abs_sums.pop(k).mul_(clip)
                for k in ("table", "linear_table")})
            abs_sums["armed"] = False
        losses += [float(cell.fn(state, batch)[1]["loss"])
                   for _ in range(T_STEPS - 1)]
        t_oracle_done(out_dir, part, {"losses": losses})
        out[part] = losses
        del state
    # the int8 step: one-process gradient, compressed as the trainer's
    # dp_mode="shard_map" compresses the averaged one
    params = inp["qwen"]()
    named = flatten(params)
    live = [p.detach().requires_grad_(True) for _, p in named]
    loss = qwen._contrastive_loss()(unflatten(params, live),
                                    inp["qwen_batch"])
    grads = torch.autograd.grad(loss, live)
    deq, ef, quantum = [], [], {}
    for (path, _), g in zip(named, grads):
        g = g.float()
        q, scale = gc.quantize_int8(g)
        deq.append(gc.dequantize_int8(q, scale))
        ef.append(g - deq[-1])
        quantum[path] = float(scale)
    opt = OptimizerConfig(name="adamw", learning_rate=T_LR)
    grads, _ = clip_by_global_norm(unflatten(params, deq), opt.grad_clip)
    adam = adamw_init(opt, params)
    adamw_update(opt, grads, adam, params, torch.zeros((), dtype=torch.int32))
    out["int8"] = float(loss.detach())
    t_save_tree(os.path.join(out_dir, "int8"), {
        "params": params, "ef": unflatten(params, ef), "opt": adam})
    t_oracle_done(out_dir, "int8", {"loss": out["int8"],
                                    "quantum": quantum})
    del params, grads, adam, deq, ef, live
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def t_oracle_done(out_dir: str, part: str, info: dict) -> None:
    """Mark one oracle part written (atomically: the ranks poll)."""
    tmp = os.path.join(out_dir, f"{part}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(info, f)
    os.replace(tmp, os.path.join(out_dir, f"{part}.json"))


def k4t_plain(grad, local, v: int):
    """K4T's plain version at ids whose padding (-1, another shard's ids)
    is moved past the V rows, where the plain version drops it.  The same
    bits as the plain version on ``local`` for finite gradients: padding
    adds ``g * 0``, a signed zero, to row 0's float32 sum, which starts at
    +0.0 and so keeps its bits; the plain version would make one pass per
    padding entry on row 0 (half the ids here)."""
    import torch
    if not bool(torch.isfinite(grad).all()):
        fail("(t) K4T held on a non-finite gradient")
    from repro_torch.kernels import ref
    return ref.embedding_bag_backward_ref(
        grad, torch.where(local < 0, v, local), v, None)


def t_digest(t) -> str:
    import hashlib

    import torch
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()


def t_host_copy(state) -> dict:
    """A state's leaves (path -> tensor) copied to host memory: the first
    run's, held against the second's without a second copy on the card."""
    from repro_torch.training.tree import flatten
    return {p: t.detach().cpu() for p, t in flatten(state) if p != "step"}


def t_bitwise(name: str, a: dict, b: dict) -> None:
    """Two states' leaves (path -> tensor) bitwise equal."""
    import torch
    for path, t in a.items():
        u = b[path].detach().cpu()
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        if not torch.equal(raw, u.contiguous().reshape(-1).view(torch.uint8)):
            fail(f"{name}: {path} differs between two runs")


def t_against_oracle(tag: str, state: dict, specs: dict, oracle_dir: str,
                     mesh, dev, dtype: str, skip: dict | None = None,
                     abs_dir: str | None = None) -> dict:
    """Every updated leaf of this rank after one AdamW step against its
    slice of the oracle's after the same step, under T_TOL[dtype] (see
    there): entry by entry in float32 (``abs_dir``: the oracle's sums of
    |terms| for the leaves it has them for), leaf by leaf in bf16.
    ``skip`` (parameter path -> bool mask) marks entries whose gradients
    differ by design (an int8 quantum's edge): their moments are not held
    and their parameters count as unclear.  Checks every leaf before it
    fails.  Returns the worst ratios seen (moments: error over allowance,
    the three worst leaves by it; parameters: error past rounding in
    units of lr, by class) and the classes' counts."""
    import torch

    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.tree import flatten
    tol, cfg = T_TOL[dtype], OptimizerConfig()
    entrywise = "moment" in tol
    round_eps = (tol["ulps"] * torch.finfo(getattr(torch, dtype)).eps
                 + 4 * torch.finfo(torch.float32).eps)
    flat_specs = dict(flatten(specs))
    local = dict(flatten(state))
    sums = {}
    if abs_dir is not None:
        with open(os.path.join(abs_dir, "dtypes.json")) as f:
            sums = json.load(f)
    worst = {"mu": 0.0, "nu": 0.0, "param_zero": 0.0, "param_clear": 0.0,
             "param_unclear": 0.0}
    counts = {"entries": 0, "zero": 0, "clear": 0, "unclear": 0}
    by_leaf, bad, unclear_by_leaf = [], [], []

    def oracle_slice(d, path, t, spec):
        want = t_load_slice(d, path, spec, mesh.coords, dict(mesh.shape),
                            dev)
        if want.shape != t.shape or want.dtype != t.dtype:
            fail(f"{tag} {path}: {tuple(t.shape)} {t.dtype} against the "
                 f"oracle's slice {tuple(want.shape)} {want.dtype}")
        return want.reshape(-1)

    for path, t in local.items():
        if not path.startswith("params/"):
            continue
        leaf = path[len("params/"):]
        spec = flat_specs[path]
        mu, nu = local[f"opt/mu/{leaf}"], local[f"opt/nu/{leaf}"]
        mu_w = oracle_slice(oracle_dir, f"opt/mu/{leaf}", mu, spec)
        nu_w = oracle_slice(oracle_dir, f"opt/nu/{leaf}", nu, spec)
        p_w = oracle_slice(oracle_dir, path, t, spec)
        terms = (oracle_slice(abs_dir, leaf, mu, spec) if leaf in sums
                 else None)
        mu, nu, p = mu.reshape(-1), nu.reshape(-1), t.reshape(-1)
        off = skip.get(leaf) if skip else None
        off = None if off is None else off.reshape(-1)
        g_big = t_floor_scale(leaf, mu_w, t.shape) / (1 - cfg.b1)
        t_big = (float(terms.max()) if terms is not None and terms.numel()
                 else 0.0)
        leaf_bad, leaf_worst = {}, 0.0
        # unclear entries, and of them those whose oracle / own gradient
        # is exactly 0
        leaf_unclear = [0, 0, 0]
        if not entrywise:
            keep = (slice(None) if off is None else ~off)
            for k, a, w in (("mu", mu, mu_w), ("nu", nu, nu_w)):
                a, w = a[keep].double(), w[keep].double()
                e = float((a - w).norm()) / max(float(w.norm()), 1e-30)
                worst[k] = max(worst[k], e / tol["norm"])
                leaf_worst = max(leaf_worst, e / tol["norm"])
                if e > tol["norm"]:
                    leaf_bad[k] = round(e, 4)
        # in float64 pieces: a table shard is 10^8 entries
        for lo in range(0, p.numel(), T_CHUNK):
            hi = min(p.numel(), lo + T_CHUNK)
            held = (torch.ones(hi - lo, dtype=torch.bool, device=dev)
                    if off is None else ~off[lo:hi])
            # the oracle's gradient and its allowance tg
            g = mu_w[lo:hi].double().abs() / (1 - cfg.b1)
            big = g_big if isinstance(g_big, float) else g_big[lo:hi]
            zero = (mu_w[lo:hi] == 0) & (mu[lo:hi] == 0) & held
            if entrywise:
                base = g if terms is None else terms[lo:hi].double()
                tg = tol["moment"] * (base + T_FLOOR * (
                    big if terms is None else t_big))
                lim_mu = (1 - cfg.b1) * tg
                lim_nu = ((1 - cfg.b2) * tg * (2 * g + tg)
                          + 2 ** -20 * nu_w[lo:hi].double().abs())
                for k, a, w, lim in (("mu", mu, mu_w, lim_mu),
                                     ("nu", nu, nu_w, lim_nu)):
                    e = (a[lo:hi].double() - w[lo:hi].double()).abs()
                    over = (e > lim) & held
                    r = torch.where(held & (lim > 0), e / lim,
                                    torch.where(over, float("inf"), 0.0))
                    if r.numel():
                        worst[k] = max(worst[k], float(r.max()))
                        leaf_worst = max(leaf_worst, float(r.max()))
                    if bool(over.any()):
                        leaf_bad[k] = leaf_bad.get(k, 0) + int(over.sum())
                        if k == "mu":
                            # the worst entry: its ratio, gradient, base
                            # of the allowance, error in gradient units
                            i = int(r.argmax())
                            leaf_bad["worst"] = [
                                round(float(r[i]), 3), float(g[i]),
                                float(base[i]),
                                float(e[i]) / (1 - cfg.b1)]
                # clear: tg cannot flip the sign, and the directions
                # g / (|g| + eps) differ by at most
                # eps tg / ((g - tg + eps) (g + eps)) <= T_STEP_ATOL
                clear = ((g > tg) & (cfg.eps * tg <= T_STEP_ATOL * (
                    g - tg + cfg.eps) * (g + cfg.eps)) & held & ~zero)
            else:
                clear = torch.zeros_like(zero)
            unclear = ~(zero | clear)
            w = p_w[lo:hi].double()
            diff = (p[lo:hi].double() - w).abs() - round_eps * (
                w.abs() + T_LR)
            for k, m, lim in (("param_zero", zero, 0.0),
                              ("param_clear", clear, T_STEP_ATOL * T_LR),
                              ("param_unclear", unclear, 2 * T_LR)):
                if bool(m.any()):
                    worst[k] = max(worst[k], float(diff[m].max()) / T_LR)
                    n = int((diff[m] > lim).sum())
                    if n:
                        leaf_bad[k] = leaf_bad.get(k, 0) + n
            counts["entries"] += hi - lo
            counts["zero"] += int(zero.sum())
            counts["clear"] += int(clear.sum())
            counts["unclear"] += int(unclear.sum())
            leaf_unclear[0] += int(unclear.sum())
            leaf_unclear[1] += int((unclear & (mu_w[lo:hi] == 0)).sum())
            leaf_unclear[2] += int((unclear & (mu[lo:hi] == 0)).sum())
        by_leaf.append((round(leaf_worst, 4), leaf))
        unclear_by_leaf.append((leaf_unclear[0] / max(1, p.numel()), leaf,
                                *leaf_unclear))
        if leaf_bad:
            bad.append(f"{leaf} {leaf_bad}")
        del mu_w, nu_w, p_w, terms
    nonzero = counts["entries"] - counts["zero"]
    share = counts["unclear"] / max(1, nonzero)
    out = {**worst, "moment_leaves": sorted(by_leaf, reverse=True)[:3],
           "unclear_share": share, **counts,
           "unclear_leaves": sorted(unclear_by_leaf, reverse=True)[:4]}
    if bad or (entrywise and share > tol["unclear"]):
        fail(f"{tag}: off the oracle beyond T_TOL[{dtype!r}] (by leaf and "
             f"check) {bad[:12]}; unclear share {share:.3g} (at most "
             f"{tol.get('unclear')}); worst {json.dumps(out)}")
    return out


def t_floor_scale(leaf: str, mu_w, shape):
    """The scale T_FLOOR takes a share of for the entries of an oracle
    first moment ``mu_w`` (flat; ``shape`` the leaf's local shape): its
    largest entry, or the largest of each block whose gradient sums its
    own terms, over its entries: an embedding's rows (a token's
    occurrences) and an MoE's expert weights (``we_*``, (L, E, ...): the
    tokens routed to each expert).  Their rounding scales with their own
    terms, and a rare token's row, or an expert few tokens chose, sits
    far below the leaf's largest."""
    if not mu_w.numel():
        return 0.0
    name = leaf.rsplit("/", 1)[-1]
    lead = (1 if name == "embed" else
            2 if name.startswith("we_") and len(shape) >= 3 else 0)
    if not lead:
        return float(mu_w.abs().max())
    n = shape[0] * (shape[1] if lead == 2 else 1)
    blocks = mu_w.abs().reshape(n, -1)
    return blocks.amax(1, keepdim=True).expand_as(blocks).reshape(-1).double()


def t_losses(tag: str, steps: list, want: list, dtype: str) -> None:
    """Each step's loss beside the oracle's (recorded in ``steps``), held
    within the tolerance over T_TOL's ``loss_steps`` first steps."""
    tol = T_TOL[dtype]
    for s, (got, w) in enumerate(zip(steps, want)):
        got["oracle_loss"] = w
        if s < tol["loss_steps"] and \
                abs(got["loss"] - w) > tol["loss"] * abs(w):
            fail(f"{tag} step {s} loss {got['loss']} against the oracle's "
                 f"{w}")


def t_local_shapes(tag: str, state: dict, specs: dict, full_shapes: dict,
                   mesh) -> None:
    """Every rank's leaf shapes are the rules' slices of the full ones."""
    from repro_torch.sharding.partitioning import local_shape
    from repro_torch.training.tree import flatten
    flat_specs = dict(flatten(specs))
    for path, t in flatten(state):
        if path == "step":
            continue
        want = local_shape(full_shapes[path], flat_specs[path], mesh)
        if tuple(t.shape) != want:
            fail(f"{tag} {path}: local shape {tuple(t.shape)}, the rules "
                 f"give {want} of {full_shapes[path]}")


def t_wait_oracle(tmp: str, part: str) -> dict:
    """The parent's oracle ``part`` once it is written."""
    path = os.path.join(tmp, "oracle", f"{part}.json")
    deadline = time.monotonic() + T_JOIN_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            fail(f"(t) the parent's oracle did not finish in {T_JOIN_S} s")
        time.sleep(0.2)
    with open(path) as f:
        return json.load(f)


def t_steps(dev, cell, state, batch, after_first=None,
            n: int | None = None) -> tuple:
    """``n`` (default T_STEPS) steps: each one's loss, grad norm, ms (the
    card synchronised around it) and collective bytes and calls on this
    rank; ``after_first(state)`` runs between the first and the second."""
    import torch

    from repro_torch.sharding import collectives
    out = []
    for i in range(T_STEPS if n is None else n):
        if i == 1 and after_first is not None:
            after_first(state)
        collectives.reset_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = cell.fn(state, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.append({"ms": (time.perf_counter() - t0) * 1e3,
                    "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    **collectives.counts()})
    return state, out


def t1_rank(dev, mesh, inp, deepfm, tmp: str) -> dict:
    """(t1) on this rank: the psum lookup's rows against the bf16 rounding
    of a one-process lookup (bitwise), two runs of T_STEPS steps (launches
    counted on the first), bitwise equal; local shapes by the rules; every
    updated leaf against the parent's oracle; K4 and K4T held against
    their plain versions at this rank's row-shard shapes."""
    import torch

    from repro_torch.configs.base import init_train_state
    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import ops, ref
    from repro_torch.models import recsys
    from repro_torch.sharding.layout import batch_shard, batch_specs
    from repro_torch.training.tree import flatten

    cell = deepfm.build_cell("train_batch", dev, mesh)
    lay = cell.layout
    if lay.keep != ("table", "linear_table"):
        fail(f"(t1) the meshed step keeps {lay.keep} sharded")
    batch = inp["deepfm_batch"]
    local_batch = batch_shard(batch, batch_specs(
        batch, lay.batch_axes, mesh, lay.rules), mesh)
    idx = local_batch["sparse_idx"]
    full = inp["deepfm"]()
    state = init_train_state(cell, full)
    table = state["params"]["table"]
    local = recsys.local_ids(idx, table.shape[0], mesh)
    with torch.no_grad():
        rows = recsys.embedding_lookup(table, idx, "psum", mesh)
    want = full["table"][idx].to(torch.bfloat16).float()
    if not torch.equal(bits(rows), bits(want)):
        fail("(t1) the psum lookup's rows differ from the bf16 rounding of "
             "the one-process lookup")
    full_shapes = {p: tuple(t.shape) for p, t in flatten(
        {"params": full, "opt": {"mu": full, "nu": full}})}
    del full, rows, want
    specs = {"params": lay.param_specs, "opt": lay.opt_specs}
    cuda = dev.type == "cuda"
    ops.reset_launch_counts()
    state, steps = t_steps(dev, cell, state, batch)
    launches = ops.launch_counts()
    per = 2 * T_STEPS if cuda else 0
    expected = {"fused_score_topk": 0, "topk_update": 0,
                "embedding_bag": per, "embedding_bag_backward": per}
    if launches != expected:
        fail(f"(t1) rank {mesh.rank}: launches {launches}, expected "
             f"{expected}")
    t_local_shapes("(t1)", {"params": state["params"], "opt": state["opt"]},
                   specs, full_shapes, mesh)
    first = t_host_copy(state)
    del state
    gaps = {}

    def against(state):
        # the second run's state after its first step, against the
        # oracle's after the same step
        t_wait_oracle(tmp, "t1")
        gaps.update(t_against_oracle(
            "(t1)", {"params": state["params"], "opt": state["opt"]}, specs,
            os.path.join(tmp, "oracle", "t1"), mesh, dev, "float32",
            abs_dir=os.path.join(tmp, "oracle", "t1abs")))

    state = init_train_state(cell, inp["deepfm"]())
    state, again = t_steps(dev, cell, state, batch, against)
    if [s["loss"] for s in again] != [s["loss"] for s in steps]:
        fail("(t1) two runs' losses differ")
    t_bitwise("(t1)", first, {p: t for p, t in flatten(state)
                              if p != "step"})
    del first
    t_losses("(t1)", steps, t_wait_oracle(tmp, "t1")["losses"], "float32")
    # K4 and K4T at this rank's shapes: the shard's rows, bags of one,
    # other shards' ids -1; bitwise against the plain versions
    held = []
    g = torch.Generator(device=dev).manual_seed(SEED + mesh.rank)
    keys = ops.BagKeys(local)
    for name in ("table", "linear_table"):
        t = state["params"][name]
        got = torch.empty((local.shape[0], t.shape[1]), device=dev)
        bag.embedding_bag_(got, t, local, None)
        bag_compare(f"(t1) rank {mesh.rank} {name}", got,
                    ref.embedding_bag_ref(t, local, None))
        grad = torch.randn(got.shape, generator=g, device=dev)
        dt = torch.empty_like(t)
        bag.embedding_bag_backward_(dt, grad, local, None, keys=keys)
        bag_compare(f"(t1) rank {mesh.rank} {name}", dt,
                    k4t_plain(grad, local, t.shape[0]), kernel="K4T")
        held.append([name, list(local.shape), list(t.shape)])
        del got, grad, dt
    return {"steps": steps, "launches": launches, "gaps": gaps,
            "held": held, "foreign": int((local < 0).sum()),
            "ids": int(local.numel())}


def t2_rank(dev, mesh, inp, qwen, qwen32, tmp: str) -> dict:
    """(t2) and (t3) on this rank: two runs of the cut LM's train_4k cell
    on the mesh (bitwise equal; against the oracle), the run's state saved
    on (2, 2) and restored onto (4, 1), then one dp_mode="shard_map" int8
    trainer step, twice (bitwise; against the oracle's int8 step), then
    (t2f): one run of the cell in float32 against its float32 oracle,
    where every loss is held and the bf16 run's roundings are gone."""
    import torch

    from repro_torch.configs.base import init_train_state
    from repro_torch.core.config import RetrievalTrainingArguments
    from repro_torch.models import transformer
    from repro_torch.models.encoder import DefaultEncoder
    from repro_torch.models.retriever import BiEncoderRetriever
    from repro_torch.training.trainer import RetrievalTrainer
    from repro_torch.training.tree import flatten

    clock = {"start": time.perf_counter()}
    dtype = str(qwen.cfg.dtype).replace("torch.", "")
    cell = qwen.build_cell("train_4k", dev, mesh)
    lay = cell.layout
    batch = inp["qwen_batch"]
    specs = {"params": lay.param_specs, "opt": lay.opt_specs}
    shapes = transformer.param_shapes(qwen.cfg)
    full_shapes = {p: tuple(s) for p, s in flatten(
        {"params": shapes, "opt": {"mu": shapes, "nu": shapes}})}
    state = init_train_state(cell, inp["qwen"]())
    state, steps = t_steps(dev, cell, state, batch)
    t_local_shapes("(t2)", {"params": state["params"], "opt": state["opt"]},
                   specs, full_shapes, mesh)
    first = t_host_copy(state)
    del state
    gaps = {}

    def against(state):
        t_wait_oracle(tmp, "t2")
        gaps.update(t_against_oracle(
            "(t2)", {"params": state["params"], "opt": state["opt"]}, specs,
            os.path.join(tmp, "oracle", "t2"), mesh, dev, dtype))

    state = init_train_state(cell, inp["qwen"]())
    state, again = t_steps(dev, cell, state, batch, against)
    if [s["loss"] for s in again] != [s["loss"] for s in steps]:
        fail("(t2) two runs' losses differ")
    t_bitwise("(t2)", first, {p: t for p, t in flatten(state)
                              if p != "step"})
    del first
    t_losses("(t2)", steps, t_wait_oracle(tmp, "t2")["losses"], dtype)
    clock["runs"] = time.perf_counter()
    t3 = t3_rank(dev, mesh, qwen, state, specs, tmp)
    clock["t3"] = time.perf_counter()
    del state
    # the int8 step
    args = RetrievalTrainingArguments(
        output_dir=os.path.join(tmp, f"run-{mesh.rank}"),
        learning_rate=T_LR, warmup_steps=0, max_steps=0, optimizer="adamw",
        grad_compression="int8", async_checkpoint=False)
    int8 = []
    for _ in range(2):
        trainer = RetrievalTrainer(BiEncoderRetriever(DefaultEncoder(
            qwen.cfg)), args, mesh=mesh, dp_mode="shard_map", device=dev)
        st = trainer.init_state(inp["qwen"]())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        st, m = trainer._step(st, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        int8.append(({p: t for p, t in flatten(st) if p not in (
            "step", "rng")}, float(m["loss"]),
            (time.perf_counter() - t0) * 1e3, trainer.specs))
    (a, loss, ms, tspecs), (b, loss2, _, _) = int8
    clock["int8"] = time.perf_counter()
    t_bitwise("(t2) int8", a, b)
    oracle = t_wait_oracle(tmp, "int8")
    if loss != loss2 or abs(loss - oracle["loss"]) > \
            T_TOL[dtype]["loss"] * abs(oracle["loss"]):
        fail(f"(t2) int8 losses {loss}, {loss2} against the oracle's "
             f"{oracle['loss']}")
    full_shapes.update({"ef/" + p: s for p, s in flatten(shapes)})
    flat_specs = dict(flatten(tspecs))
    t_local_shapes("(t2) int8", a, {p: flat_specs[p] for p in a},
                   full_shapes, mesh)
    # the residuals: a gradient on a quantum's edge rounds the other way
    # there, one quantum apart
    ef_gap, edge, on_edge = 0.0, 0, {}
    for path, t in a.items():
        if not path.startswith("ef/"):
            continue
        want = t_load_slice(os.path.join(tmp, "oracle", "int8"), path,
                            flat_specs[path], mesh.coords, dict(mesh.shape),
                            dev)
        diff = (t - want).abs()
        q = oracle["quantum"][path[len("ef/"):]]
        on_edge[path[len("ef/"):]] = diff > 0.5 * q
        edge += int(on_edge[path[len("ef/"):]].sum())
        if float(diff.max()) > q * 1.01 + 1e-6:
            fail(f"(t2) int8 {path}: residual off the oracle's by "
                 f"{float(diff.max()):.3g}, more than its quantum {q:.3g}")
        ef_gap = max(ef_gap, float(diff.max()) / q)
    pgaps = t_against_oracle("(t2) int8", a, flat_specs,
                             os.path.join(tmp, "oracle", "int8"), mesh, dev,
                             dtype, on_edge)
    del a, b, int8
    clock["checks"] = time.perf_counter()
    cell = qwen32.build_cell("train_4k", dev, mesh)
    specs = {"params": cell.layout.param_specs, "opt": cell.layout.opt_specs}
    gaps32 = {}

    def against32(state):
        t_wait_oracle(tmp, "t2f")
        gaps32.update(t_against_oracle(
            "(t2f)", {"params": state["params"], "opt": state["opt"]},
            specs, os.path.join(tmp, "oracle", "t2f"), mesh, dev,
            "float32"))

    state = init_train_state(cell, inp["qwen32"]())
    state, steps32 = t_steps(dev, cell, state, batch, against32)
    del state
    t_losses("(t2f)", steps32, t_wait_oracle(tmp, "t2f")["losses"],
             "float32")
    clock["f32"] = time.perf_counter()
    marks = list(clock.items())
    return {"steps": steps, "gaps": gaps, "t3": t3,
            "f32": {"steps": steps32, "gaps": gaps32},
            "int8": {"loss": loss, "ms": ms, "ef_quanta": ef_gap,
                     "edge_entries": edge, "gaps": pgaps},
            "seconds": {b[0]: round(b[1] - a[1], 2)
                        for a, b in zip(marks, marks[1:])}}


def t3_rank(dev, mesh, qwen, state, specs, tmp: str) -> dict:
    """(t3) on this rank: digests of its (2, 2) slices, the state saved
    through ``CheckpointManager.save(shardings=...)`` (rank 0 writes the
    gathered leaves), restored onto a (4, 1) mesh of the same group, and
    the digests of the restored slices."""
    import torch

    from repro_torch.configs.base import make_layout
    from repro_torch.models import transformer
    from repro_torch.sharding import make_mesh
    from repro_torch.sharding.partitioning import P, local_shape
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.tree import flatten, tree_map

    specs = dict(specs, step=P())
    dig22 = {p: t_digest(t) for p, t in flatten(state)}
    mgr = ckpt.CheckpointManager(os.path.join(tmp, "ckpt"), save_every=1,
                                 keep=1, async_save=False)
    t0 = time.perf_counter()
    mgr.save(T_STEPS, state, shardings=(mesh, specs))
    save_s = time.perf_counter() - t0
    mesh41 = make_mesh((4, 1), T_AXES)
    shapes = transformer.param_shapes(qwen.cfg)
    lay = make_layout(mesh41, qwen.axis_rules(), shapes,
                      qwen.param_logical_axes(), None, "adamw")
    specs41 = {"step": P(), "params": lay.param_specs,
               "opt": lay.opt_specs}
    full = {"step": (), "params": shapes,
            "opt": {"mu": shapes, "nu": shapes}}
    template = tree_map(lambda s, sp: torch.empty(
        local_shape(tuple(s), sp, mesh41), device=dev), full, specs41)
    t0 = time.perf_counter()
    restored, step = mgr.restore_latest(template, (mesh41, specs41))
    restore_s = time.perf_counter() - t0
    if step != T_STEPS:
        fail(f"(t3) restored step {step}")
    return {"dig22": dig22, "dig41": {p: t_digest(t) for p, t in
                                      flatten(restored)},
            "coords41": dict(mesh41.coords), "save_s": save_s,
            "restore_s": restore_s}


def t_rank(rank: int, tmp: str) -> int:
    """One (t) rank process: join the gloo group, bind the (2, 2) mesh,
    run (t1), (t2) and (t3), write what the parent checks."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.launch.distributed import init_distributed
    from repro_torch.sharding import make_mesh

    began = time.perf_counter()
    with open(os.path.join(tmp, "t.json")) as f:
        spec = json.load(f)
    dev = resolve_device(spec["device"])
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.load_library()
    # the parent's sizes (a rehearsal patches them there)
    globals().update(spec["globals"])
    if init_distributed(init_method=f"file://{tmp}/rdzv",
                        world_size=T_WORLD, rank=rank) != (rank, T_WORLD):
        fail("(t) init_distributed")
    try:
        mesh = make_mesh(T_SHAPE, T_AXES)
        deepfm, qwen, qwen32 = t_archs(spec["reduced"])
        inp = t_inputs(dev, deepfm, qwen, qwen32)
        t0 = time.perf_counter()
        out = {"rank": rank, "coords": dict(mesh.coords),
               "start_s": t0 - began,
               "t1": t1_rank(dev, mesh, inp, deepfm, tmp)}
        out["t1_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            out["t1_peak_gib"] = gib(torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
        # bitwise runs: the LM's embedding backward adds into rows
        torch.use_deterministic_algorithms(True)
        try:
            out["t2"] = t2_rank(dev, mesh, inp, qwen, qwen32, tmp)
        finally:
            torch.use_deterministic_algorithms(False)
        out["t2_s"] = time.perf_counter() - t0 - out["t1_s"]
        if dev.type == "cuda":
            out["t2_peak_gib"] = gib(torch.cuda.max_memory_allocated(dev))
        with open(os.path.join(tmp, f"t-{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def t_slices_digests(full: dict, specs: dict, coords: dict,
                     sizes: dict) -> dict:
    """Digests of one rank's slices of a full state (path -> tensor)."""
    return {path: t_digest(t[t_index(specs[path], t.shape, coords, sizes)])
            for path, t in full.items()}


def phase_mesh(dev, card: str) -> tuple[dict, dict]:
    """(t) the device mesh: T_WORLD rank processes (this script with
    ``--t-rank``) over a gloo group on the one card, a bound (2, 2) mesh.
    The parent computes the one-process oracles while they run and
    restores (t3)'s checkpoint onto itself while they take their int8
    steps, then checks each rank's report and times K4 / K4T at rank (0,
    0)'s row-shard shapes.  Returns (each rank's (t1) launches by path,
    the kernel timings)."""
    import torch

    paths: dict = {}
    if dev.type == "cuda":
        # the card's cached blocks go back to the driver: the ranks are
        # other processes
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    deepfm, qwen, qwen32 = t_archs(T_REDUCED)
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "t.json"), "w") as f:
            json.dump({"device": str(dev), "reduced": T_REDUCED,
                       "globals": {"T2_LEN": T2_LEN, "T2_BATCH": T2_BATCH,
                                   "T2_LAYERS": T2_LAYERS,
                                   "T_STEPS": T_STEPS}}, f)
        logs = [os.path.join(tmp, f"t-{r}.log") for r in range(T_WORLD)]
        t0 = time.perf_counter()
        procs = []
        try:
            for r in range(T_WORLD):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__),
                         "--t-rank", str(r), tmp], stdout=log,
                        stderr=subprocess.STDOUT))
            oracle = t_oracle(dev, deepfm, qwen, qwen32,
                              os.path.join(tmp, "oracle"))
            # while the ranks run their int8 steps: (t3)'s whole restore
            whole = t3_whole(tmp, qwen, procs)
            wait_all(procs, T_JOIN_S)
            waited = time.perf_counter() - t0
            bad = []
            for r, proc in enumerate(procs):
                if proc.returncode != 0:
                    with open(logs[r]) as f:
                        tail = f.read()[-3000:]
                    bad.append(f"(t) rank {r} " + (
                        f"still running after {waited:.1f} s (limit "
                        f"{T_JOIN_S} s), killed" if proc.returncode is None
                        else f"exited {proc.returncode}") + f":\n{tail}")
            if bad:
                fail("\n".join(bad))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(T_WORLD):
            with open(os.path.join(tmp, f"t-{r}.json")) as f:
                ranks.append(json.load(f))
        print(f"[t] (t) {T_WORLD} rank processes on {card}, a gloo group, "
              f"mesh {dict(zip(T_AXES, T_SHAPE))}: {wall:.1f} s wall with "
              f"their start; the parent's oracles {oracle['seconds']:.1f} s "
              "beside them")
        for out in ranks:
            r = out["rank"]
            t1 = out["t1"]
            paths[f"(t1) DeepFM train_batch rank {r}"] = t1["launches"]
            print(f"[e] (t1) DeepFM train_batch rank {r}: launches "
                  f"{json.dumps(t1['launches'])} (as predicted: K4 and K4T "
                  f"twice a step)")
            for tag, steps in (("(t1) DeepFM train_batch", t1["steps"]),
                               ("(t2) qwen2-0.5b train_4k", out["t2"][
                                   "steps"]),
                               ("(t2f) qwen2-0.5b train_4k float32",
                                out["t2"]["f32"]["steps"])):
                for s, st in enumerate(steps):
                    print(f"[t] {tag} rank {r} {out['coords']} step {s} on "
                          f"{card}: {st['ms']:.3f} ms, loss "
                          f"{st['loss']:.6f} (oracle "
                          f"{st['oracle_loss']:.6f}), grad norm "
                          f"{st['grad_norm']:.6f}, collective bytes out of "
                          f"this rank {json.dumps(st['wire_bytes'])}, calls "
                          f"{json.dumps(st['calls'])}")
            print(f"[t] (t1) rank {r}: {t1['foreign']:,} of {t1['ids']:,} "
                  f"ids another shard's (-1); K4 / K4T bitwise equal to "
                  f"their plain versions at {t1['held']}; gaps to the "
                  f"oracle {json.dumps(t1['gaps'])}; peak "
                  f"{out.get('t1_peak_gib', 0):.2f} GiB")
            t2 = out["t2"]
            print(f"[t] (t2) rank {r}: gaps to the oracle "
                  f"{json.dumps(t2['gaps'])}; (t2f) float32 "
                  f"{json.dumps(t2['f32']['gaps'])}; int8 shard_map step "
                  f"{t2['int8']['ms']:.3f} ms, loss {t2['int8']['loss']:.6f}"
                  f" (oracle {oracle['int8']:.6f}), residuals within "
                  f"{t2['int8']['ef_quanta']:.3f} quantum of the oracle's "
                  f"({t2['int8']['edge_entries']} entries on a quantum's "
                  f"edge), params {json.dumps(t2['int8']['gaps'])}; peak "
                  f"{out.get('t2_peak_gib', 0):.2f} GiB; (t1) "
                  f"{out['t1_s']:.1f} s, (t2) + (t3) {out['t2_s']:.1f} s "
                  f"{json.dumps(t2['seconds'])}, the rank's start "
                  f"{out['start_s']:.1f} s")
        lm = T_TOL[str(qwen.cfg.dtype).replace("torch.", "")]
        print(f"[t] (t1) oracle losses {oracle['t1']}, (t2) "
              f"{oracle['t2']}, (t2f) {oracle['t2f']}; every rank within "
              f"{T_TOL['float32']['loss']} of (t1)'s and (t2f)'s "
              f"{T_TOL['float32']['loss_steps']} and {lm['loss']} of (t2)'s "
              f"first {lm['loss_steps']}, two runs bitwise on every rank")
        if not whole:
            fail("(t3) rank 0 wrote no checkpoint")
        for out in ranks:
            t3 = out["t2"]["t3"]
            r = out["rank"]
            if t3["coords41"] != {"data": r, "model": 0}:
                fail(f"(t3) rank {r} sits at {t3['coords41']} on (4, 1)")
            for shape, key in ((T_SHAPE, "dig22"), ((4, 1), "dig41")):
                want = whole["digests"][shape][r]
                if want != t3[key]:
                    bad = [p for p in want if want[p] != t3[key].get(p)]
                    fail(f"(t3) rank {r} on {shape}: leaves {bad[:5]} "
                         f"differ from the whole restore")
        print(f"[t] (t3) on {card}: the (2, 2) state saved through "
              f"CheckpointManager.save(shardings=...) "
              f"({max(o['t2']['t3']['save_s'] for o in ranks):.2f} s), "
              f"restored onto (4, 1) in the same group "
              f"({max(o['t2']['t3']['restore_s'] for o in ranks):.2f} s) "
              f"and onto this process ({whole['seconds']:.2f} s): all "
              f"{len(whole['digests'][T_SHAPE][0])} leaves bitwise "
              "(SHA-256) on every rank, both layouts")
        timings = t_kernel_timings(dev, deepfm) if dev.type == "cuda" else {}
    return paths, timings


def t3_whole(tmp: str, qwen, procs) -> dict:
    """(t3) in this process: once rank 0 has written the (2, 2) state,
    restore it whole (onto one process) and take the digests of each
    rank's slices under (2, 2) and (4, 1), rank r at the row-major
    coordinates of r.  Returns them (empty if a rank stopped first)."""
    import torch

    from repro_torch.configs.base import make_layout
    from repro_torch.models import transformer
    from repro_torch.sharding import make_mesh
    from repro_torch.sharding.partitioning import P
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.tree import flatten, tree_map

    deadline = time.monotonic() + T_JOIN_S
    path = None
    while path is None:
        path = ckpt.latest_checkpoint(os.path.join(tmp, "ckpt"))
        if path is None and (time.monotonic() > deadline or any(
                proc.poll() is not None for proc in procs)):
            return {}
        time.sleep(0.2)
    t0 = time.perf_counter()
    shapes = transformer.param_shapes(qwen.cfg)
    full = {"step": (), "params": shapes,
            "opt": {"mu": shapes, "nu": shapes}}
    template = tree_map(lambda s: torch.empty(tuple(s)), full)
    whole = dict(flatten(ckpt.restore_checkpoint(path, template)))
    seconds = time.perf_counter() - t0
    digests = {}
    for shape in (T_SHAPE, (4, 1)):
        # no process group here: a shape-only mesh resolves the rules
        lay = make_layout(make_mesh(shape, T_AXES), qwen.axis_rules(),
                          shapes, qwen.param_logical_axes(), None, "adamw")
        specs = dict(flatten({"step": P(), "params": lay.param_specs,
                              "opt": lay.opt_specs}))
        sizes = dict(zip(T_AXES, shape))
        digests[shape] = [t_slices_digests(
            whole, specs, {"data": r // shape[1], "model": r % shape[1]},
            sizes) for r in range(T_WORLD)]
    return {"digests": digests, "seconds": seconds}


def t_kernel_timings(dev, deepfm) -> dict:
    """K4 and K4T at ranks (0, 0)'s and (0, 1)'s (t1) shapes — the row
    shard of the tables each holds, the first data row's ids as bags of
    one, other shards' ids -1 — held bitwise against their plain
    versions, then timed against them, one library call and the bound."""
    import numpy as np
    import torch

    from repro_torch.models import recsys

    params = recsys.init_params(
        deepfm.cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    batch = deepfm.smoke_inputs("train_batch", np.random.default_rng(SEED),
                                dev)
    v = params["table"].shape[0] // T_SHAPE[1]
    idx = batch["sparse_idx"][:batch["sparse_idx"].shape[0] // T_SHAPE[0]]
    k4, k4t = [], []
    for shard in range(T_SHAPE[1]):
        lo = shard * v
        local = torch.where((idx >= lo) & (idx < lo + v), idx - lo,
                            -1).reshape(-1, 1).to(torch.int32)
        for name in ("table", "linear_table"):
            a, b = t_shard_timings(dev, name, shard,
                                   params[name][lo:lo + v].contiguous(),
                                   local)
            k4.append(a)
            k4t.append(b)
    for kind, rows_ in (("embedding_bag", k4), ("embedding_bag_backward",
                                                k4t)):
        for t in rows_:
            print(f"[t] {kind} at {t['shape']}: bitwise equal to the plain "
                  f"version; kernel {t['ms']:.4f} ms"
                  + (f" (on the step's kept sort {t['shared_sort_ms']:.4f})"
                     if "shared_sort_ms" in t else "")
                  + f", plain {t['plain_ms']:.4f} ms, library "
                  f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']})")
    return {"embedding_bag": k4, "embedding_bag_backward": k4t}


def t_shard_timings(dev, name: str, shard: int, table, local) -> tuple:
    """(K4's, K4T's) timing at one row shard of ``name`` and its (N, 1)
    local ids: the kernel (K4T also on a kept sort, as the step's
    ``BagKeys``), the plain version, one library call over the same
    function (``F.embedding_bag``, the foreign ids at weight 0, and its
    backward) and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as bag
    from repro_torch.kernels import ops, ref, topk
    from repro_torch.launch.roofline import bound_ms

    (n, _), (v, d) = local.shape, table.shape
    ok = (local >= 0).float()
    nonpad = int(ok.sum())
    label = (f"(t1) row shard {shard} of {name} V={v} D={d}, {n:,} bags of "
             f"one ({n - nonpad:,} foreign ids -1)")
    lib_idx = local.clamp(min=0).long()
    sms = topk.sm_count(dev)

    def nothing():
        pass

    out = torch.empty((n, d), device=dev)
    bag.embedding_bag_(out, table, local, None)
    bag_compare(label, out, ref.embedding_bag_ref(table, local, None))
    cost = bag.bag_cost(n, 1, d, 4, False,
                        int(torch.unique(local[local >= 0]).numel()))
    bound, by = bound_ms(cost)
    k4 = {"shape": label, "plan": list(bag.bag_plan(n, 1, d, 4, sms)),
          "ms": median_ms(lambda: bag.embedding_bag_(out, table, local,
                                                     None), nothing),
          "plain_ms": median_ms(lambda: ref.embedding_bag_ref(
              table, local, None), nothing, n=5),
          "library_ms": median_ms(lambda: F.embedding_bag(
              lib_idx, table, mode="sum", per_sample_weights=ok), nothing),
          "bound_ms": bound, "bound_bytes": cost[1], "bound_by": by}
    keys = ops.BagKeys(local)
    keys.sorted()
    grad = torch.randn((n, d), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    dt = torch.empty_like(table)
    bag.embedding_bag_backward_(dt, grad, local, None, keys=keys)
    bag_compare(label, dt, k4t_plain(grad, local, v), kernel="K4T")
    lib_table = torch.zeros_like(table, requires_grad=True)
    lib_out = F.embedding_bag(lib_idx, lib_table, mode="sum",
                              per_sample_weights=ok)
    cost = bag.bag_backward_cost(n, 1, v, d, 4, False, nonpad)
    bound, by = bound_ms(cost)
    k4t = {"shape": label, "plan": list(bag.backward_plan(v, d, 4, sms)),
           "ms": median_ms(lambda: bag.embedding_bag_backward_(
               dt, grad, local, None), nothing, n=T_SLOW_N),
           "shared_sort_ms": median_ms(lambda: bag.embedding_bag_backward_(
               dt, grad, local, None, keys=keys), nothing, n=T_SLOW_N),
           "plain_ms": median_ms(lambda: k4t_plain(grad, local, v),
                                 nothing, n=5),
           "library_ms": median_ms(lambda: torch.autograd.grad(
               lib_out, lib_table, grad, retain_graph=True), nothing,
               n=T_SLOW_N),
           "bound_ms": bound, "bound_bytes": cost[1], "bound_by": by}
    del lib_out, lib_table, grad, dt, out
    torch.cuda.empty_cache()
    return k4, k4t


# -- (u) the LM cells on a mesh: four rank processes on the one card -----------

# U_WORLD rank processes (this script with ``--u-rank``) over a gloo group
# on the one card, as (t), each case held against a one-process oracle the
# parent runs on the same card while they run:
#   (u1) qwen2-0.5b long_500k at published width and depth, B 1 x 524,288,
#        on (2, 2) and (1, 4);
#   (u2) qwen2-0.5b decode_32k, its batch of 128 cut to 16, both meshes;
#   (u3) granite-moe-3b-a800m decode_32k at 2 of 32 layers, B 16, (2, 2);
#   (u4) qwen2-0.5b prefill_32k, 32 x 32,768 cut to U4_BATCH x U4_LEN;
#   (u5) granite train_4k at U5_LAYERS layers, U5_BATCH x U5_LEN tokens,
#        T_STEPS AdamW steps twice, then a float32 twin (as (t2) / (t2f)).
# A decode case is (tag, arch, shape, batch, layers or None for all, its
# meshes, a float32 twin at U_TWIN_LAYERS layers); U_STEPS steps from
# ``len = S - U_STEPS``.
U_WORLD, U_AXES = 4, ("data", "model")
U_JOIN_S = 600
U_STEPS = 4
U_DECODE = (("u1", "qwen2-0.5b", "long_500k", 1, None, ((2, 2), (1, 4)),
             True),
            ("u2", "qwen2-0.5b", "decode_32k", 16, None, ((2, 2), (1, 4)),
             True),
            ("u3", "granite-moe-3b-a800m", "decode_32k", 16, 2, ((2, 2),),
             False))
U_TWIN_LAYERS = 2
# cuts of (u)'s own steps, each a gathered set of weights over gloo (1.5 to
# 3.7 s for qwen2-0.5b, by host): the float32 twins take U_TWIN_STEPS
# steps, and the second run of a bf16 cell, held bitwise against the
# first, its first U_AGAIN_STEPS
U_TWIN_STEPS, U_AGAIN_STEPS = 1, 1
U4_ARCH, U4_BATCH, U4_LEN = "qwen2-0.5b", 2, 8192
# (u5)'s rows of 2,048 tokens, not train_4k's 4,096: a cut of its compute
# (four ranks and the oracle share the card), not of its bytes
U5_ARCH, U5_LAYERS, U5_BATCH, U5_LEN = "granite-moe-3b-a800m", 2, 4, 2048
# (u5)'s query chunks: granite's own 4096 puts a (2, 24, 4096, 4096)
# float32 score block (3 GiB) on each of the four ranks and the oracle at
# once; a chunk sees every key, so the function is the same
U5_CHUNK = 1024
# the float32 twin's steps (a cut: T_STEPS would add ~11 s a step)
U5F_STEPS = 1
# float32 (the twins): every logit within U_F32_TOL x max(1, max |oracle|)
U_F32_TOL = 1e-5
U_REDUCED = False           # the reduced archs (a CPU rehearsal)


def u_bf16_bound(n_layers: int) -> float:
    """A bf16 cell's relative 2-norm gap to the oracle, per row of logits
    (or per embedding).  The meshed and one-process paths compute the same
    products and differ only in the order of float32 sums (the float32
    twins show it within U_F32_TOL); where an order flips the bf16
    rounding of the residual stream (once a layer, and the final norm) the
    entry moves one unit, 2^-8 of itself, on either side; flips in
    unrelated directions add in the 2-norm over the L + 1 roundings."""
    import math
    return 2 * 2 ** -8 * math.sqrt(n_layers + 1)


def u_lm_arch(name: str, kind: str, shape: str, batch: int, seq: int,
              layers: int | None = None, f32: bool = False):
    """An LMArch of ``name`` (reduced under U_REDUCED) with one shape of
    ``batch`` x ``seq`` tokens, cut to ``layers`` layers and in float32
    where asked; AdamW."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_arch import LMArch

    arch = get_arch(name)
    cfg = arch.reduced().cfg if U_REDUCED else arch.cfg
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return LMArch(cfg, "adamw", shapes={shape: dict(
        kind=kind, seq_len=seq, global_batch=batch)})


def u_decode_archs(case) -> list:
    """(key, arch) of a decode case: the cell in its dtype, then its float32
    twin at U_TWIN_LAYERS layers where it has one."""
    from repro_torch.configs import get_arch
    tag, name, shape, batch, layers, _, twin = case
    arch = get_arch(name)
    seq = (arch.reduced() if U_REDUCED else arch).shapes[shape]["seq_len"]
    out = [(tag, u_lm_arch(name, "serve", shape, batch, seq, layers))]
    if twin:
        out.append((tag + "f", u_lm_arch(name, "serve", shape, batch, seq,
                                         U_TWIN_LAYERS, f32=True)))
    return out


def u_mid(mesh_shape) -> str:
    return "x".join(map(str, mesh_shape))


def u_steps(key: str, run: int = 0) -> int:
    """Steps of a decode run: U_STEPS, a float32 twin's U_TWIN_STEPS, a
    second run's U_AGAIN_STEPS."""
    return (U_TWIN_STEPS if key.endswith("f") else
            U_STEPS if run == 0 else U_AGAIN_STEPS)


def u_rows(spec, mesh) -> tuple[int, int]:
    """(this rank's index, their count) along the axes that split a
    cache's rows (``spec``'s batch dimension)."""
    from repro_torch.sharding.partitioning import spec_axes
    axes = spec_axes(tuple(spec)[1])
    return (mesh.shard_index(axes) if axes else 0), mesh.axis_size(axes)


def u_gen(dev, offset: int = 0):
    import torch
    return torch.Generator(device=dev).manual_seed(SEED + offset)


def u_fill_cache(cache: dict, shape: tuple, spec, mesh, dev) -> None:
    """K and V of every layer drawn from N(0, 1) on the card (layer i's K
    from seed SEED + 2i, its V from SEED + 2i + 1, a whole (B, S, K, hd)
    layer in float32 at a time), then this rank's slice of it under
    ``spec`` (the whole layer without one), in the cache's dtype."""
    import torch

    from repro_torch.sharding.layout import local_slice
    for i in range(shape[0]):
        for j, name in enumerate(("k", "v")):
            layer = torch.randn(shape[1:], generator=u_gen(dev, 2 * i + j),
                                device=dev)
            if spec is not None:
                layer = local_slice(layer, tuple(spec)[1:], mesh)
            cache[name][i].copy_(layer)
            del layer


def u_tokens(arch, shape: str, dev):
    """U_STEPS rows of the batch's tokens, seeded."""
    import torch
    spec = arch.shapes[shape]
    return torch.randint(3, arch.cfg.vocab_size,
                         (U_STEPS, spec["global_batch"]),
                         generator=u_gen(dev, 1000), device=dev).int()


def u_param_gathers(cfg, layout, mesh, count) -> None:
    """``count(op, bytes)`` of every parameter leaf's gather, a sharded
    dimension at a time (``sharding.layout.gather_leaf``)."""
    from repro_torch.models import transformer
    from repro_torch.sharding.partitioning import local_shape, spec_axes
    from repro_torch.training.tree import flatten
    elt = 2 if str(cfg.dtype).endswith("bfloat16") else 4
    shapes = dict(flatten(transformer.param_shapes(cfg)))
    for path, spec in flatten(layout.param_specs):
        numel = 1
        for d in local_shape(shapes[path], spec, mesh):
            numel *= d
        for entry in spec:
            n = mesh.axis_size(spec_axes(entry))
            if n > 1:
                count("all_gather", numel * elt, n)
                numel *= n


def u_counter():
    calls = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}
    wire = dict(calls)

    def count(op, nbytes, n):
        calls[op] += 1
        wire[op] += nbytes * (n - 1)
    return {"wire_bytes": wire, "calls": calls}, count


def u_decode_counts(arch, shape: str, layout, mesh) -> dict:
    """A meshed decode step's collectives out of one rank, from its layout
    (``transformer.decode_step`` on a mesh): the parameters gathered; per
    layer the softmax's (max, sum) gather and the float32 partials'
    all-reduce where the sequence is split, the attention output's gather
    in the cache dtype where the KV heads are; the float32 logits' gather
    where the rows are."""
    from repro_torch.sharding.partitioning import spec_axes
    cfg = arch.cfg
    out, count = u_counter()
    u_param_gathers(cfg, layout, mesh, count)
    spec = tuple(layout.cache_specs["k"])
    rows, seq, heads = (mesh.axis_size(spec_axes(e)) for e in spec[1:4])
    b = arch.shapes[shape]["global_batch"] // rows
    h = cfg.n_heads // heads
    elt = 2 if str(cfg.dtype).endswith("bfloat16") else 4
    for _ in range(cfg.n_layers):
        if seq > 1:
            count("all_gather", 2 * b * h * 4, seq)
            count("all_reduce", b * h * cfg.head_dim * 4, seq)
        if heads > 1:
            count("all_gather", b * h * cfg.head_dim * elt, heads)
    if rows > 1:
        count("all_gather", b * cfg.vocab_size * 4, rows)
    return out


def u_encode_counts(arch, shape: str, layout, mesh) -> dict:
    """The meshed encode: the parameters gathered, the float32 embeddings'
    rows gathered over the data axes."""
    from repro_torch.sharding.partitioning import data_parallelism
    out, count = u_counter()
    u_param_gathers(arch.cfg, layout, mesh, count)
    n = data_parallelism(mesh)
    if n > 1:
        b = arch.shapes[shape]["global_batch"] // n
        count("all_gather", b * arch.cfg.d_model * 4, n)
    return out


def u_train_counts(arch, layout, mesh) -> dict:
    """A meshed train_4k step: the parameters gathered; the queries' and
    passages' float32 embeddings gathered over the data axes; each MoE
    layer's (2, E) statistics averaged once (outside its checkpoint); each
    gradient (model dtype) and the loss averaged over the data axes."""
    from repro_torch.models import transformer
    from repro_torch.sharding.partitioning import data_parallelism
    from repro_torch.training.tree import flatten
    cfg = arch.cfg
    out, count = u_counter()
    u_param_gathers(cfg, layout, mesh, count)
    n = data_parallelism(mesh)
    b = arch.shapes["train_4k"]["global_batch"] // n
    elt = 2 if str(cfg.dtype).endswith("bfloat16") else 4
    for _ in range(2):
        count("all_gather", b * cfg.d_model * 4, n)
    for _ in range(cfg.n_moe_layers):
        count("all_reduce", 2 * cfg.n_experts * 4, n)
    for _, shape in flatten(transformer.param_shapes(cfg)):
        numel = 1
        for d in shape:
            numel *= d
        count("all_reduce", numel * elt, n)
    count("all_reduce", 4, n)
    return out


def u_sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def u_peak(dev, reset: bool = False) -> float:
    import torch
    if dev.type != "cuda":
        return 0.0
    if reset:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        return 0.0
    return gib(torch.cuda.max_memory_allocated(dev))


def u_save(d: str, name: str, t) -> None:
    """A float32 result as ``d/name.npy``."""
    import numpy as np
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, name + ".npy"),
            t.detach().float().cpu().numpy().astype(np.float32))


def u_decode_rank(dev, meshes: dict, case, tmp: str) -> dict:
    """A decode case on this rank, on each of its meshes: the cell's
    ``smoke_inputs`` block filled from the seeded draws, ``len = S -
    U_STEPS``, ``u_steps`` steps, twice (the second run's logits bitwise
    the first's; the float32 twin once); every step's ms (the card
    synchronised around it) and collectives, held against the layout's
    prediction; rank 0 writes the first run's logits."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.sharding import collectives
    from repro_torch.training.tree import leaves
    shape = case[2]
    out = {}
    for key, arch in u_decode_archs(case):
        cfg = arch.cfg
        b, s = arch.shapes[shape]["global_batch"], arch.shapes[shape][
            "seq_len"]
        kv = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
        tokens = u_tokens(arch, shape, dev)
        for ms in case[5]:
            mesh = meshes[ms]
            cell = arch.build_cell(shape, dev, mesh)
            spec = cell.layout.cache_specs["k"]
            full = transformer.init_params(cfg, u_gen(dev), dev)
            local = cell.local_params(full)
            del full
            u_peak(dev, reset=True)
            want = u_decode_counts(arch, shape, cell.layout, mesh)
            runs = []
            # the float32 twin, a witness of the order of sums, runs once
            for run in range(1 if key.endswith("f") else 2):
                block, _ = cell.smoke_inputs(u_gen(dev), dev)
                u_fill_cache(block, kv, spec, mesh, dev)
                block["len"].fill_(s - U_STEPS)
                steps, digests, routes = [], [], []
                for i in range(u_steps(key, run)):
                    collectives.reset_counts()
                    u_sync(dev)
                    t0 = time.perf_counter()
                    with ExpertLog() as experts:
                        logits, block = cell.fn(local, block, tokens[i])
                    u_sync(dev)
                    routes.append([c.tolist() for c in experts.choices])
                    got = collectives.counts()
                    steps.append({"ms": (time.perf_counter() - t0) * 1e3,
                                  **got})
                    if got != want:
                        fail(f"({key}) {ms} step {i}: collectives {got}, "
                             f"the layout predicts {want}")
                    print(f"[u] rank {mesh.rank}: ({key}) {u_mid(ms)} run "
                          f"{run} step {i} {steps[-1]['ms']:.1f} ms",
                          flush=True)
                    digests.append(t_digest(logits))
                    if run == 0 and mesh.rank == 0:
                        u_save(os.path.join(tmp, "u", f"{key}-{u_mid(ms)}"),
                               f"step{i}", logits)
                runs.append((digests, steps, routes))
                del block
            if runs[0][0][:len(runs[-1][0])] != runs[-1][0]:
                fail(f"({key}) {ms}: two runs differ on rank {mesh.rank}")
            block_bytes = 2 * _numel_bytes(kv, cfg.dtype, spec, mesh)
            param_bytes = sum(t.numel() * t.element_size()
                              for t in leaves(local))
            rows = u_rows(spec, mesh)
            # each run's first step warms the card's caches (a float32
            # twin has only that one)
            warm = [s_["ms"] for r in runs for s_ in r[1][1:]]
            out[f"{key} {u_mid(ms)}"] = {
                "spec": str(tuple(spec)), "digests": runs[0][0],
                "routes": runs[0][2], "row0": rows[0] * b // rows[1],
                "ms": statistics.median(warm or [runs[0][1][0]["ms"]]),
                "first_ms": [r[1][0]["ms"] for r in runs],
                "wire_bytes": want["wire_bytes"], "calls": want["calls"],
                "peak_gib": u_peak(dev), "block_gib": gib(block_bytes),
                "local_params_gib": gib(param_bytes)}
            del cell, local
            u_peak(dev, reset=True)
    return out


def _numel_bytes(shape, dtype, spec, mesh) -> int:
    import torch

    from repro_torch.sharding.partitioning import local_shape
    n = 1
    for d in local_shape(shape, spec, mesh):
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def u4_arch():
    return u_lm_arch(U4_ARCH, "encode", "prefill_32k", U4_BATCH, U4_LEN)


def u5_archs():
    return [(tag, u_lm_arch(U5_ARCH, "train", "train_4k", U5_BATCH, U5_LEN,
                            U5_LAYERS, f32).variant(attn_chunk=U5_CHUNK))
            for tag, f32 in (("u5", False), ("u5f", True))]


def u4_rank(dev, mesh, tmp: str) -> dict:
    """(u4) on this rank: the meshed prefill twice (bitwise), rank 0's
    embeddings written; ms and collectives of each run."""
    from repro_torch.models import transformer
    from repro_torch.sharding import collectives
    arch = u4_arch()
    batch = arch.smoke_inputs("prefill_32k", u_gen(dev, 2000), dev)
    cell = arch.build_cell("prefill_32k", dev, mesh)
    full = transformer.init_params(arch.cfg, u_gen(dev), dev)
    local = cell.local_params(full)
    del full
    u_peak(dev, reset=True)
    want = u_encode_counts(arch, "prefill_32k", cell.layout, mesh)
    runs = []
    for run in range(2):
        collectives.reset_counts()
        u_sync(dev)
        t0 = time.perf_counter()
        emb = cell.fn(local, batch)
        u_sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        if collectives.counts() != want:
            fail(f"(u4) run {run}: collectives {collectives.counts()}, the "
                 f"layout predicts {want}")
        runs.append((t_digest(emb), ms))
        if run == 0 and mesh.rank == 0:
            u_save(os.path.join(tmp, "u", "u4"), "emb", emb)
    if runs[0][0] != runs[1][0]:
        fail(f"(u4) two runs differ on rank {mesh.rank}")
    return {"digest": runs[0][0], "ms": [r[1] for r in runs],
            "wire_bytes": want["wire_bytes"], "calls": want["calls"],
            "peak_gib": u_peak(dev)}


class RouteStats:
    """Each ``transformer._route`` call's aux statistics, (2, E) float32:
    the share of positions whose first choice is each expert and each
    expert's mean probability, over the call's rows (recorded by wrapping
    it here, in the script; the call returns what it would have)."""

    def __enter__(self):
        from repro_torch.models import transformer
        self.stats = []
        route = self.inner = transformer._route

        def logged(cfg, h, router, local_stats=False):
            out = route(cfg, h, router, True)
            self.stats.append(out[4].detach().float())
            return out if local_stats else out[:4] + (
                transformer._switch_aux(cfg, out[4]),)

        transformer._route = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer._route = self.inner


def u5_aux(tag: str, cfg, aux: float, stats: list, oracle: dict, n: int,
           dtype: str) -> dict:
    """The whole batch's aux that the meshed ``forward_hidden`` returned,
    and each MoE layer's aux statistics, against the oracle's.  The
    statistics: the mean probabilities within T_TOL's loss tolerance of
    their largest; the first choices (shares of ``n`` positions) equal but
    for a few tokens whose first choice a float32 sum order tipped at a
    near-tie (at most one in a thousand, at least one).  A moved first
    choice moves one position's density from one expert to another, so
    the aux by at most E x (1 / n) x the largest mean probability: the
    returned aux is held within the tolerance plus that much for each
    counted flip, and the aux with the oracle's first-choice shares and
    these mean probabilities within the tolerance (a diagnostic of where
    a gap comes from)."""
    import torch
    tol = T_TOL[dtype]["loss"]
    flips, p_gap, rebuilt, p_max = 0, 0.0, 0.0, 0.0
    for got, want in zip(stats, oracle["stats"]):
        want = torch.tensor(want, dtype=torch.float64)
        got = got.double().cpu()
        flips += round(float((got[0] - want[0]).abs().sum()) * n / 2)
        p_gap = max(p_gap, float((got[1] - want[1]).abs().max()
                                 / want[1].abs().max()))
        p_max = max(p_max, float(want[1].max()))
        rebuilt += cfg.n_experts * float((want[0] * got[1]).sum())
    aux_gap = abs(rebuilt - oracle["aux"]) / abs(oracle["aux"])
    direct_gap = abs(aux - oracle["aux"])
    direct_allowed = (tol * abs(oracle["aux"])
                      + cfg.n_experts * flips / n * p_max)
    if (len(stats) != len(oracle["stats"]) or p_gap > tol or aux_gap > tol
            or direct_gap > direct_allowed
            or flips > max(1, len(stats) * n // 1000)):
        fail(f"({tag}) aux off the oracle's: the returned aux {aux!r} "
             f"against {oracle['aux']!r} (gap {direct_gap:.3g}, allowed "
             f"{direct_allowed:.3g}); mean probabilities {p_gap:.3g}, the "
             f"aux at the oracle's first choices {aux_gap:.3g} (tolerance "
             f"{tol}); {flips} first choices moved over {len(stats)} "
             f"layers of {n} positions")
    return {"flips": flips, "p_gap": p_gap, "aux_gap": aux_gap,
            "direct_gap": direct_gap, "direct_allowed": direct_allowed}


def u5_rank(dev, mesh, tmp: str) -> dict:
    """(u5) on this rank: the cut granite's train_4k cell on the mesh, the
    whole-batch aux that ``forward_hidden`` returns on this rank's rows
    held against the oracle's (``u5_aux``),
    T_STEPS steps twice (bitwise; the second run's state after one step
    against the oracle's under T_TOL), then U5F_STEPS of the float32 twin
    (its state after them held likewise); each step's collectives against
    the layout's."""
    import torch

    from repro_torch.configs.base import init_train_state
    from repro_torch.models import transformer
    from repro_torch.sharding import collectives
    from repro_torch.sharding.layout import batch_shard, batch_specs
    from repro_torch.sharding.partitioning import data_axes
    from repro_torch.training.tree import flatten

    out = {}
    for tag, arch in u5_archs():
        dtype = str(arch.cfg.dtype).replace("torch.", "")
        cell = arch.build_cell("train_4k", dev, mesh)
        lay = cell.layout
        batch = arch.smoke_inputs("train_4k", u_gen(dev, 3000), dev)
        specs = {"params": lay.param_specs, "opt": lay.opt_specs}
        local = batch_shard(batch, batch_specs(batch, lay.batch_axes, mesh,
                                               lay.rules), mesh)
        full = transformer.init_params(arch.cfg, u_gen(dev), dev)
        with torch.no_grad(), RouteStats() as log:
            aux = float(transformer.forward_hidden(
                arch.cfg, full, local["passage"]["tokens"],
                local["passage"]["mask"], mesh)[1])
        # the whole batch's statistics, as forward_hidden averaged them
        stats = [collectives.all_reduce(st, mesh, data_axes(mesh), "mean")
                 for st in log.stats]
        oracle = t_wait_oracle(tmp, tag)
        aux_check = u5_aux(tag, arch.cfg, aux, stats, oracle,
                           U5_BATCH * U5_LEN, dtype)
        del full
        want = u_train_counts(arch, lay, mesh)
        gaps: dict = {}

        def against(state, tag=tag, dtype=dtype, specs=specs):
            gaps.update(t_against_oracle(
                f"({tag})", {"params": state["params"],
                             "opt": state["opt"]}, specs,
                os.path.join(tmp, "oracle", tag), mesh, dev, dtype))

        def run(after_first=None):
            state = init_train_state(cell, transformer.init_params(
                arch.cfg, u_gen(dev), dev))
            return t_steps(dev, cell, state, batch, after_first)

        u_peak(dev, reset=True)
        if tag == "u5":
            # two runs, the second's state after one step held
            state, steps = run()
            first = t_host_copy(state)
            del state
            state, again = run(against)
            if [s["loss"] for s in again] != [s["loss"] for s in steps]:
                fail(f"({tag}) two runs' losses differ")
            t_bitwise(f"({tag})", first, {p: t for p, t in flatten(state)
                                          if p != "step"})
            del first
            steps += again
        else:
            state = init_train_state(cell, transformer.init_params(
                arch.cfg, u_gen(dev), dev))
            state, steps = t_steps(dev, cell, state, batch, n=U5F_STEPS)
            against(state)
        del state
        for i, st in enumerate(steps):
            got = {"wire_bytes": st["wire_bytes"], "calls": st["calls"]}
            if got != want:
                fail(f"({tag}) step {i}: collectives {got}, the layout "
                     f"predicts {want}")
        t_losses(f"({tag})", steps, oracle["losses"], dtype)
        out[tag] = {"aux": aux, "oracle_aux": oracle["aux"], **aux_check,
                    "steps": steps, "gaps": gaps, "peak_gib": u_peak(dev)}
        u_peak(dev, reset=True)
    return out


def u_rank(rank: int, tmp: str) -> int:
    """One (u) rank process: join the gloo group, bind the (2, 2) and
    (1, 4) meshes, run (u1)-(u5), write what the parent checks."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.launch.distributed import init_distributed
    from repro_torch.sharding import make_mesh

    began = time.perf_counter()
    with open(os.path.join(tmp, "u.json")) as f:
        spec = json.load(f)
    dev = resolve_device(spec["device"])
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.load_library()
    # the parent's sizes (a rehearsal patches them there)
    glob = dict(spec["globals"])
    glob["U_DECODE"] = tuple(tuple(c[:5]) + (tuple(map(tuple, c[5])), c[6])
                             for c in glob["U_DECODE"])
    globals().update(glob)
    if init_distributed(init_method=f"file://{tmp}/rdzv",
                        world_size=U_WORLD, rank=rank) != (rank, U_WORLD):
        fail("(u) init_distributed")
    try:
        meshes = {m: make_mesh(m, U_AXES) for m in ((2, 2), (1, 4))}
        ops.reset_launch_counts()
        out = {"rank": rank, "start_s": time.perf_counter() - began,
               "decode": {}, "seconds": {}}
        for case in U_DECODE:
            t0 = time.perf_counter()
            out["decode"].update(u_decode_rank(dev, meshes, case, tmp))
            out["seconds"][case[0]] = time.perf_counter() - t0
            print(f"[u] rank {rank}: ({case[0]}) {out['seconds'][case[0]]:.1f}"
                  " s", flush=True)
        t0 = time.perf_counter()
        out["u4"] = u4_rank(dev, meshes[(2, 2)], tmp)
        out["seconds"]["u4"] = time.perf_counter() - t0
        print(f"[u] rank {rank}: (u4) {out['seconds']['u4']:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        # bitwise runs: the embedding's backward adds into rows
        torch.use_deterministic_algorithms(True)
        try:
            out["u5"] = u5_rank(dev, meshes[(2, 2)], tmp)
        finally:
            torch.use_deterministic_algorithms(False)
        out["seconds"]["u5"] = time.perf_counter() - t0
        out["launches"] = ops.launch_counts()
        with open(os.path.join(tmp, f"u-{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def u_oracle(dev, tmp: str) -> dict:
    """The parent's one-process runs on the same seeded weights, caches and
    tokens: each decode case's logits (the cell in its dtype and its
    float32 twin), (u4)'s embeddings, (u5)'s state after its first step,
    its losses and its whole-batch aux; seconds of each."""
    import torch

    from repro_torch.configs.base import init_train_state
    from repro_torch.models import transformer

    seconds = {}
    for case in U_DECODE:
        t0 = time.perf_counter()
        shape = case[2]
        for key, arch in u_decode_archs(case):
            cfg = arch.cfg
            b, s = (arch.shapes[shape]["global_batch"],
                    arch.shapes[shape]["seq_len"])
            params = transformer.init_params(cfg, u_gen(dev), dev)
            cache = transformer.init_cache(cfg, b, s, dev)
            u_fill_cache(cache, tuple(cache["k"].shape), None, None, dev)
            cache["len"].fill_(s - U_STEPS)
            tokens = u_tokens(arch, shape, dev)
            cell = arch.build_cell(shape, dev)
            routes = []
            for i in range(u_steps(key)):
                with ExpertLog() as experts:
                    logits, cache = cell.fn(params, cache, tokens[i])
                routes.append([c.tolist() for c in experts.choices])
                u_save(os.path.join(tmp, "u", f"{key}-oracle"), f"step{i}",
                       logits)
            with open(os.path.join(tmp, "u", f"{key}-oracle",
                                   "routes.json"), "w") as f:
                json.dump(routes, f)
            del params, cache, logits
            u_peak(dev, reset=True)
        seconds[case[0]] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arch = u4_arch()
    batch = arch.smoke_inputs("prefill_32k", u_gen(dev, 2000), dev)
    params = transformer.init_params(arch.cfg, u_gen(dev), dev)
    u_save(os.path.join(tmp, "u", "u4-oracle"), "emb",
           arch.build_cell("prefill_32k", dev).fn(params, batch))
    del params
    seconds["u4"] = time.perf_counter() - t0
    for tag, arch in u5_archs():
        t0 = time.perf_counter()
        cell = arch.build_cell("train_4k", dev)
        batch = arch.smoke_inputs("train_4k", u_gen(dev, 3000), dev)
        params = transformer.init_params(arch.cfg, u_gen(dev), dev)
        with torch.no_grad(), RouteStats() as log:
            aux = float(transformer.forward_hidden(
                arch.cfg, params, batch["passage"]["tokens"],
                batch["passage"]["mask"])[1])
        stats = [st.tolist() for st in log.stats]
        state = init_train_state(cell, params)
        losses = [float(cell.fn(state, batch)[1]["loss"])]
        t_save_tree(os.path.join(tmp, "oracle", tag), state)
        losses += [float(cell.fn(state, batch)[1]["loss"]) for _ in range(
            (T_STEPS if tag == "u5" else U5F_STEPS) - 1)]
        t_oracle_done(os.path.join(tmp, "oracle"), tag,
                      {"losses": losses, "aux": aux, "stats": stats})
        del state, params
        u_peak(dev, reset=True)
        seconds[tag] = time.perf_counter() - t0
    return seconds


def u_held_rows(tmp: str, key: str, ranks: list, name: str,
                b: int) -> list:
    """Per step, the rows whose experts (as sets, at every MoE layer of
    every step so far) are the oracle's: a bf16 rounding can tip a router
    near a tie, and such a row's token then takes other experts, which is
    no rounding of the oracle's (phase (q2) holds its rows likewise).  A
    dense cell holds every row."""
    import numpy as np
    with open(os.path.join(tmp, "u", f"{key}-oracle", "routes.json")) as f:
        want = json.load(f)
    got = [[[None] * b for _ in layers] for layers in want]
    for out in ranks:
        d = out["decode"][name]
        for i, layers in enumerate(d["routes"]):
            for j, rows in enumerate(layers):
                for r, choice in enumerate(rows):
                    got[i][j][d["row0"] + r] = choice
    held, same = [], np.ones(b, bool)
    for i, layers in enumerate(want):
        for j, rows in enumerate(layers):
            same &= np.array([set(got[i][j][r]) == set(rows[r])
                              for r in range(b)], bool)
        held.append(same.copy())
    return held


def u_gap(got, want, f32: bool, n_layers: int) -> tuple[float, float]:
    """(gap, limit): float32, the largest entry's gap against U_F32_TOL x
    max(1, max |oracle|); bf16, the largest row's relative 2-norm gap
    against ``u_bf16_bound``."""
    import numpy as np
    if f32:
        return (float(np.abs(got - want).max()),
                U_F32_TOL * max(1.0, float(np.abs(want).max())))
    d = got.astype(np.float64) - want
    rows = np.linalg.norm(d, axis=-1) / np.maximum(
        np.linalg.norm(want.astype(np.float64), axis=-1), 1e-30)
    return float(rows.max()), u_bf16_bound(n_layers)


def phase_lm_mesh(dev, card: str) -> dict:
    """(u) the LM cells on a mesh: U_WORLD rank processes (this script
    with ``--u-rank``) over a gloo group on the one card, bound (2, 2) and
    (1, 4) meshes.  The parent runs the one-process oracles while they
    run, then holds each rank's results against them.  Returns each
    rank's kernel launches over its whole (u) run (none: no kernel of the
    repo is on these paths)."""
    import numpy as np
    import torch

    paths: dict = {}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "u.json"), "w") as f:
            json.dump({"device": str(dev), "globals": {
                "U_DECODE": U_DECODE, "U_STEPS": U_STEPS,
                "U_TWIN_STEPS": U_TWIN_STEPS, "U_AGAIN_STEPS": U_AGAIN_STEPS,
                "U_TWIN_LAYERS": U_TWIN_LAYERS, "U_REDUCED": U_REDUCED,
                "U4_BATCH": U4_BATCH, "U4_LEN": U4_LEN,
                "U5_LAYERS": U5_LAYERS, "U5_BATCH": U5_BATCH,
                "U5_LEN": U5_LEN, "U5F_STEPS": U5F_STEPS,
                "T_STEPS": T_STEPS}}, f)
        logs = [os.path.join(tmp, f"u-{r}.log") for r in range(U_WORLD)]
        t0 = time.perf_counter()
        procs = []
        try:
            for r in range(U_WORLD):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__),
                         "--u-rank", str(r), tmp], stdout=log,
                        stderr=subprocess.STDOUT))
            oracle = u_oracle(dev, tmp)
            wait_all(procs, U_JOIN_S)
            waited = time.perf_counter() - t0
            bad = []
            for r, proc in enumerate(procs):
                if proc.returncode != 0:
                    with open(logs[r]) as f:
                        tail = f.read()[-3000:]
                    bad.append(f"(u) rank {r} " + (
                        f"still running after {waited:.1f} s (limit "
                        f"{U_JOIN_S} s), killed" if proc.returncode is None
                        else f"exited {proc.returncode}") + f":\n{tail}")
            if bad:
                fail("\n".join(bad))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=60)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(U_WORLD):
            with open(os.path.join(tmp, f"u-{r}.json")) as f:
                ranks.append(json.load(f))
        print(f"[u] (u) {U_WORLD} rank processes on {card}, a gloo group, "
              f"meshes (2, 2) and (1, 4): {wall:.1f} s wall with their "
              f"start; the parent's oracles beside them "
              f"{json.dumps({k: round(v, 1) for k, v in oracle.items()})} s")
        for out in ranks:
            paths[f"(u) LM mesh rank {out['rank']}"] = out["launches"]
            if any(out["launches"].values()):
                fail(f"(u) rank {out['rank']} launched "
                     f"{out['launches']}: no kernel is on these paths")
        print(f"[e] (u) every rank: launches {json.dumps(ranks[0]['launches'])}"
              " (as predicted: no kernel of the repo on the LM mesh paths)")
        for case in U_DECODE:
            for key, arch in u_decode_archs(case):
                f32 = key.endswith("f")
                for ms in case[5]:
                    name = f"{key} {u_mid(ms)}"
                    want_dig = ranks[0]["decode"][name]["digests"]
                    for out in ranks[1:]:
                        if out["decode"][name]["digests"] != want_dig:
                            fail(f"({name}) rank {out['rank']}'s logits "
                                 "differ from rank 0's")
                    gaps = []
                    held = u_held_rows(tmp, key, ranks, name,
                                       arch.shapes[case[2]]["global_batch"])
                    for i in range(u_steps(key)):
                        got = np.load(os.path.join(
                            tmp, "u", f"{key}-{u_mid(ms)}", f"step{i}.npy"))
                        want = np.load(os.path.join(tmp, "u",
                                                    f"{key}-oracle",
                                                    f"step{i}.npy"))
                        if 2 * held[i].sum() < len(held[i]):
                            fail(f"({name}) step {i}: {int(held[i].sum())} of "
                                 f"{len(held[i])} rows route as the oracle's")
                        gap, lim = u_gap(got[held[i]], want[held[i]], f32,
                                         arch.cfg.n_layers)
                        if not np.isfinite(got).all() or gap > lim:
                            fail(f"({name}) step {i}: logits off the "
                                 f"oracle's by {gap:.3g} (limit {lim:.3g})")
                        gaps.append(gap)
                    d = ranks[0]["decode"][name]
                    params_gib = gib(arch.cfg.param_count() * (
                        2 if str(arch.cfg.dtype).endswith("bfloat16")
                        else 4))
                    print(f"[u] ({name}) {arch.name} {case[2]} "
                          f"{'float32' if f32 else str(arch.cfg.dtype)[6:]}"
                          f", {arch.cfg.n_layers} layers, B "
                          f"{arch.shapes[case[2]]['global_batch']} x "
                          f"{arch.shapes[case[2]]['seq_len']:,}, cache "
                          f"{d['spec']} on {card}: step ms by rank "
                          + ", ".join(f"{o['decode'][name]['ms']:.3f}"
                                      for o in ranks)
                          + " (medians past each run's first step, a "
                          "twin's one step; first "
                          + ", ".join(f"{o['decode'][name]['first_ms'][0]:.1f}"
                                      for o in ranks) + ")"
                          + f"; collective bytes out of a rank a step "
                          f"{json.dumps(d['wire_bytes'])}, calls "
                          f"{json.dumps(d['calls'])} (as the layout "
                          f"predicts); peak GiB by rank "
                          + ", ".join(f"{o['decode'][name]['peak_gib']:.2f}"
                                      for o in ranks)
                          + f" (reckoned {d['block_gib'] + d['local_params_gib'] + params_gib:.2f}: "
                          f"block {d['block_gib']:.2f} + slices "
                          f"{d['local_params_gib']:.2f} + gathered "
                          f"{params_gib:.2f}); gap to the oracle by step "
                          + ", ".join(f"{g:.3g}" for g in gaps)
                          + f" (limit {lim:.3g})"
                          + ("; rows held by step (an MoE row whose experts "
                             "differ from the oracle's at any layer so far "
                             "is not) " + ", ".join(
                                 str(int(h.sum())) for h in held)
                             if arch.cfg.moe else "")
                          + ("" if f32 else "; two runs bitwise on every "
                             "rank"))
        want_dig = ranks[0]["u4"]["digest"]
        if any(o["u4"]["digest"] != want_dig for o in ranks):
            fail("(u4) the ranks' embeddings differ")
        arch = u4_arch()
        got = np.load(os.path.join(tmp, "u", "u4", "emb.npy"))
        want = np.load(os.path.join(tmp, "u", "u4-oracle", "emb.npy"))
        gap, lim = u_gap(got, want, False, arch.cfg.n_layers)
        if not np.isfinite(got).all() or gap > lim:
            fail(f"(u4) embeddings off the oracle's by {gap:.3g} (limit "
                 f"{lim:.3g})")
        u4 = ranks[0]["u4"]
        print(f"[u] (u4) {arch.name} prefill_32k {U4_BATCH} x {U4_LEN:,} "
              f"on (2, 2) on {card}: ms by rank "
              + ", ".join(f"{o['u4']['ms'][0]:.1f} / {o['u4']['ms'][1]:.1f}"
                          for o in ranks)
              + f"; collective bytes {json.dumps(u4['wire_bytes'])}, calls "
              f"{json.dumps(u4['calls'])} (as predicted); peak GiB by rank "
              + ", ".join(f"{o['u4']['peak_gib']:.2f}" for o in ranks)
              + f"; relative gap to the oracle {gap:.3g} (limit {lim:.3g});"
              " two runs bitwise")
        for tag, arch in u5_archs():
            for out in ranks:
                u5 = out["u5"][tag]
                st = u5["steps"]
                print(f"[u] ({tag}) {arch.name} train_4k "
                      f"{arch.cfg.n_layers} layers, {U5_BATCH} x {U5_LEN:,}, "
                      f"{str(arch.cfg.dtype)[6:]}, rank {out['rank']} on "
                      f"{card}: step ms "
                      + ", ".join(f"{s_['ms']:.3f}" for s_ in st)
                      + (f" (two runs of {T_STEPS})" if tag == "u5" else "")
                      + "; losses " + ", ".join(f"{s_['loss']:.6f}"
                                                for s_ in st)
                      + " (oracle " + ", ".join(
                          f"{s_['oracle_loss']:.6f}" for s_ in st
                          if "oracle_loss" in s_)
                      + f"); collective bytes a step "
                      f"{json.dumps(st[0]['wire_bytes'])}, calls "
                      f"{json.dumps(st[0]['calls'])} (as the layout "
                      f"predicts); aux {u5['aux']!r} (the oracle's "
                      f"{u5['oracle_aux']!r}, gap {u5['direct_gap']:.3g} "
                      f"of {u5['direct_allowed']:.3g} allowed; first "
                      f"choices moved "
                      f"{u5['flips']}, mean probabilities off by "
                      f"{u5['p_gap']:.3g}, the aux at the oracle's first "
                      f"choices by {u5['aux_gap']:.3g}); gaps "
                      f"to the oracle {json.dumps(u5['gaps'])}; peak "
                      f"{u5['peak_gib']:.2f} GiB")
        for out in ranks:
            print(f"[u] rank {out['rank']}: seconds "
                  f"{json.dumps({k: round(v, 1) for k, v in out['seconds'].items()})}"
                  f", its start {out['start_s']:.1f} s")
    return paths



def main() -> int:
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    # cuBLAS's setting for deterministic products, read when phases (l2)
    # and (m2) turn deterministic algorithms on; set before the first
    # product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda:0")            # also switches TF32 off
    card = card_line()
    print(f"[a] card: {card}")
    print(f"[a] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.load_library()
    print(f"[a] kernels built and loaded in {time.perf_counter() - t0:.2f} "
          f"s: {_build.library_path().name}")
    for line in _build.library_path().with_suffix(".log").read_text(
            ).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[a] ptxas: {line.strip()}")

    seconds = {"(a) build": time.perf_counter() - t0}

    def timed(label, fn, *args):
        """``fn(*args)``, its wall seconds kept under ``label``."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t
        print(f"[a] {label}: {seconds[label]:.1f} s")
        return out

    kernels = timed("(b) K1 and K2", phase_kernels, dev)
    kernels["embedding_bag"] = timed("(b) K4", phase_bag, dev)
    kernels["embedding_bag_backward"] = timed("(b) K4T", phase_bag_backward,
                                              dev)

    trove = timed("(c) trove-base", build_trove, dev)
    paths, runs = timed("(c) evaluate", phase_main_path, dev, card, trove)
    paths.update(timed("(d) serving", phase_serving, dev, card, trove))
    paths.update(timed("(g) cache", phase_cache, dev, card, trove,
                       kernels["fused_score_topk"]["timings"][0]["ms"]))
    paths.update(timed("(h) workers", phase_workers, dev, card, trove,
                       runs[("fused", "kernel")]))
    paths.update(timed("(i) faults", phase_faults, dev, card, trove))
    paths.update(timed("(j) data", phase_data, dev, card, trove))
    ivf_paths, ivf_timings = timed("(k) IVF", phase_ivf, dev, card, trove)
    paths.update(ivf_paths)
    kernels["fused_score_topk"]["timings"] += ivf_timings
    paths.update(timed("(l) training", phase_training, dev, card))
    paths.update(timed("(f) recsys", phase_recsys, dev, card))
    paths.update(timed("(m) recsys training", phase_recsys_training, dev,
                       card))
    lm_paths, lm_timings = timed("(n) LM encoders", phase_lm_encoders, dev,
                                 card)
    paths.update(lm_paths)
    kernels["fused_score_topk"]["timings"] += lm_timings
    paths.update(timed("(o) LM training", phase_lm_training, dev, card))
    moe_paths, moe_timings = timed("(p) MoE", phase_moe, dev, card)
    paths.update(moe_paths)
    kernels["fused_score_topk"]["timings"] += moe_timings
    gnn_paths, gnn_timings = timed("(r) GNN", phase_gnn, dev, card)
    paths.update(gnn_paths)
    for name, rows in gnn_timings.items():
        kernels[name]["timings"] += rows
    paths.update(timed("(s) tools", phase_tools, dev, card))
    mesh_paths, mesh_timings = timed("(t) mesh", phase_mesh, dev, card)
    paths.update(mesh_paths)
    for name, rows in mesh_timings.items():
        kernels[name]["timings"] += rows
    paths.update(timed("(u) LM mesh", phase_lm_mesh, dev, card))

    def profile():
        for t, call, reset, names in PROFILED:
            t["stage_ms"] = stage_ms(call, reset, names)
            print(f"[b] {names} at {t['shape']}: device ms per kernel "
                  f"{t['stage_ms']}")
        for trace in STEP_TRACES:
            trace()

    timed("profiles", profile)
    # (q) ran inside the (n) and (p) turns: its seconds are counted apart
    for label, q in DECODE_SECONDS.items():
        seconds[label] -= q
    seconds["(q) decode"] = sum(DECODE_SECONDS.values())
    print(f"[a] (q) decode: {seconds['(q) decode']:.1f} s, inside "
          f"{json.dumps(DECODE_SECONDS)} and taken out of them")
    print(f"[a] seconds by phase: {json.dumps(seconds)}")
    for name, info in kernels.items():
        info["launches_by_path"] = {p: c[name] for p, c in paths.items()}
        info["launches"] = sum(info["launches_by_path"].values())
        if info["launches"] < 1:
            fail(f"kernel {name} was not launched on the main path")

    leaked = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.") or m == "repro"
              or m.startswith("repro.")]
    if leaked:
        fail(f"imported the reference stack: {leaked[:5]}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--h4-rank"]:
        sys.exit(h4_rank(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--t-rank"]:
        sys.exit(t_rank(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--u-rank"]:
        sys.exit(u_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
