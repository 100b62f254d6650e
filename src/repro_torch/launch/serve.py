"""Retrieval serving driver: prepare a device-resident corpus once, then
answer concurrent query requests through the continuous-batching
:class:`~repro_torch.core.serving.ServeFrontend` (micro-batch coalescing,
admission control, per-request demux).

  python -m repro_torch.launch.serve --smoke --device cpu
  python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke --device cpu
  python -m repro_torch.launch.serve --data-dir DIR --topk 10

The port of ``repro.launch.serve``, with the port's backend names
(``--score-impl numpy | torch | fused``, default ``fused``) and
``--device`` (``cuda`` by default; without a card it raises unless
``--device cpu`` is given).  ``--arch`` names the encoder: trove-base
(the default), qwen2-0.5b, stablelm-3b, gemma-7b, or the MoE stacks
granite-moe-3b-a800m and llama4-maverick-400b-a17b (``--smoke``: its
``reduced()`` form in float32).  Another family's arch (the GNN, the
recsys rankers) raises a ValueError before any work: the launchers
drive LM encoders only, as the reference's do.  llama4-maverick at full
width raises naming its ROADMAP item (its weights need a mesh across
cards, item 10).  The weights are seeded, or with
``--ckpt-dir DIR`` the ``params`` of the latest checkpoint in ``DIR`` (a
trainer's ``OUTPUT_DIR/checkpoints``, written by either package).
The embedding cache is kept per encoder, under
``DATA_DIR/emb_cache/ARCH[-smoke][-step_N-DIGEST]`` (:func:`cache_dir`;
the digest is the restored checkpoint's manifest's), so an encoder never
reads another's rows (the reference keeps one ``DATA_DIR/emb_cache`` for
every encoder).
Modes:

  * ``--workers 0`` (default): the ``torch.distributed`` world when a
    process group is initialised (call
    :func:`repro_torch.launch.distributed.init_distributed` first; each
    process then scores a fair-sharded corpus slice and the ranks merge
    through ``ProcessAllGather``), else one worker;
  * ``--workers 1``: one worker, even inside a process group;
  * ``--workers N``: N workers in this process (``SimulatedCluster``);
  * ``--index-impl ivf --nclusters K --nprobe P``: the corpus behind an
    IVF index of K clusters (built on the device at startup, persisted
    beside the embedding cache and reloaded on the next start), each
    micro-batch scanning the union of its queries' P nearest clusters;
  * ``--mutate``: serve the embedding cache's live set while a writer
    thread adds, re-embeds and deletes documents and runs one online
    compaction; each micro-batch pins the newest committed generation
    (under ``--index-impl ivf`` a new generation rebuilds the index);
  * ``--workers N --resilient``: the simulated cluster's gather is the
    fault-tolerant one — a dead, stalled or dropped worker's shard is
    rescored by a survivor within ``--round-deadline-s`` — and
    ``--chaos crash | stall | drop`` injects that fault into worker 1 at
    the first steady-state round, then prints a ``chaos:`` line.

Measurement: corpus encoding and the encoder's first calls happen in an
explicit warm pass over every power-of-two micro-batch rung, reported
apart, before the request loop, so the request latencies are steady
state.  Requests wrap around the query set so every request carries
exactly ``--batch`` queries, and ``--concurrency C`` submits from C
threads so the frontend coalesces.  ``main`` returns the stats dict
(per-request latencies, p50 / p99, QPS, frontend counters).

With more than one ``torch.distributed`` process, ``--concurrency``
must be 1: coalescing depends on timing, so two ranks could form
different micro-batches and all-gather states of different query sets,
and the reduce thread's gather of round r would run beside the
dispatcher's observation exchange of round r + 1, two collectives on
one group from two threads in an order the ranks need not share.  For
the same reason ``--deadline-ms`` is refused there: each rank would
expire queued requests on its own clock, so one rank could skip a
request that another dispatches into the all-gather alone.  And
``--resilient`` is refused there: the resilient gather is in-process
(a dead rank's shard is rescored by a sibling thread), and across
processes nothing tells a dead rank from a slow collective.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import threading
import time


def _not_ported(flag: str, item: int, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} needs {what}, which the port does not have yet "
        f"(ROADMAP queue 1 item {item})")


ARCH_HELP = ("trove-base, qwen2-0.5b, stablelm-3b, gemma-7b, "
             "granite-moe-3b-a800m or llama4-maverick-400b-a17b (the "
             "last only with --smoke: at full width it needs more than "
             "one card)")
# the device memory of one card, for the weights alone
CARD_BYTES = 80e9


def lm_config(arch: str, smoke: bool):
    """The encoder config ``--arch`` names: an LM arch of
    ``repro_torch.configs`` (``smoke``: its ``reduced()`` form, float32).
    Any other family raises a ValueError (the reference's launchers drive
    LM encoders only: ``repro/launch/train.py:57`` asserts
    ``arch.family == "lm"``), and a config whose weights alone exceed one
    card's 80 GB (llama4-maverick at full width, 739 GiB in bf16) names
    ROADMAP queue 1 item 10, before anything is allocated."""
    from repro_torch.configs import get_arch
    found = get_arch(arch)
    if found.family != "lm":
        raise ValueError(
            f"--arch {arch} is a {found.family} arch: the launchers drive "
            f"LM encoders only, as the reference's do "
            f"(repro/launch/train.py:57 asserts arch.family == 'lm')")
    cfg = (found.reduced() if smoke else found).cfg
    n_bytes = cfg.param_count() * cfg.dtype.itemsize
    if n_bytes > CARD_BYTES:
        raise _not_ported(f"--arch {arch}", 10,
                          f"a device mesh across cards (its "
                          f"{cfg.param_count():,} parameters are "
                          f"{n_bytes / 2 ** 30:.0f} GiB in {cfg.dtype}, "
                          f"past one card's 80 GB)")
    return cfg


def cache_dir(root: str, arch: str, smoke: bool,
              checkpoint: str | None = None) -> str:
    """The embedding cache of one encoder under ``root``:
    ``root/emb_cache/ARCH``, with ``-smoke`` for the reduced form and,
    for weights restored from a checkpoint, its step directory's name
    and the first 12 hex digits of the SHA-256 of its ``manifest.json``
    (``-step_00000020-3f9c0a1b2d4e``).  The manifest holds the save's
    time, so two runs restored at one step get two directories; the same
    checkpoint, wherever it lies, keeps one.  The rows and the on-disk
    format are the cache's own; only the directory is per encoder."""
    key = arch + ("-smoke" if smoke else "")
    if checkpoint:
        with open(os.path.join(checkpoint, "manifest.json"), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
        key += f"-{os.path.basename(os.path.normpath(checkpoint))}-{digest}"
    return os.path.join(root, "emb_cache", key)


def main(argv=None):
    import numpy as np
    import torch

    from repro_torch.core.collator import RetrievalCollator
    from repro_torch.core.config import DataArguments, EvaluationArguments
    from repro_torch.core.embedding_cache import EmbeddingCache
    from repro_torch.core.evaluator import RetrievalEvaluator
    from repro_torch.core.serving import ServeFrontend, ServeOverloadError
    from repro_torch.data.synthetic import make_retrieval_dataset
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.device import resolve_device
    from repro_torch.models.encoder import DefaultEncoder
    from repro_torch.models.retriever import BiEncoderRetriever

    # the frontend's defaults live in EvaluationArguments only
    defaults = EvaluationArguments()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="trove-base",
                    help=ARCH_HELP)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch cut to 2 x 64 (its reduced() form) in "
                         "float32")
    ap.add_argument("--data-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "trove_data"))
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the latest step_* checkpoint "
                         "in this directory (a trainer's "
                         "OUTPUT_DIR/checkpoints)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--n-requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8,
                    help="queries per request (requests wrap around the "
                         "query set so every request has exactly this many)")
    ap.add_argument("--concurrency", type=int, default=1,
                    help="concurrent submitter threads (the frontend "
                         "coalesces their requests into micro-batches)")
    ap.add_argument("--workers", type=int, default=0,
                    help="0 = the torch.distributed world (one worker "
                         "without a process group); 1 = force one "
                         "worker; N > 1 = N workers in this process "
                         "(SimulatedCluster)")
    ap.add_argument("--score-impl", default="fused",
                    choices=("numpy", "torch", "fused"))
    ap.add_argument("--index-impl", default="flat",
                    choices=("flat", "ivf"),
                    help="flat = exhaustive scan (recall oracle); ivf = "
                         "cluster-pruned search (repro_torch.index)")
    ap.add_argument("--nclusters", type=int, default=64,
                    help="IVF coarse-quantizer cluster count")
    ap.add_argument("--nprobe", type=int, default=8,
                    help="clusters scanned per query batch (nprobe == "
                         "nclusters scans every row)")
    ap.add_argument("--max-batch", type=int,
                    default=defaults.serve_max_batch,
                    help="micro-batch flush size (coalesced queries)")
    ap.add_argument("--max-wait-ms", type=float,
                    default=defaults.serve_max_wait_ms,
                    help="micro-batch flush deadline after first request")
    ap.add_argument("--max-queue", type=int,
                    default=defaults.serve_max_queue,
                    help="admission-control bound on pending requests")
    ap.add_argument("--resilient", action="store_true",
                    help="fault-tolerant cluster (workers > 1): a dead "
                         "or silent worker's shard is reassigned to "
                         "survivors instead of aborting the round")
    ap.add_argument("--chaos", default=None,
                    choices=("crash", "stall", "drop"),
                    help="inject one fault of this kind into worker 1 "
                         "at the first steady-state round (requires "
                         "--resilient and --workers > 1)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request latency bound: queued past it -> "
                         "degraded empty result; dispatched -> bounds "
                         "shard-recovery time")
    ap.add_argument("--round-deadline-s", type=float, default=5.0,
                    help="how long a round waits for a silent worker "
                         "before reassigning its shard (resilient only)")
    ap.add_argument("--mutate", action="store_true",
                    help="live-corpus mode: serve the embedding cache's "
                         "generation-versioned live set while a writer "
                         "thread adds/updates/deletes documents and runs "
                         "one online compaction — each micro-batch pins "
                         "the newest committed generation; in-flight "
                         "requests finish on their pinned snapshot")
    args = ap.parse_args(argv)
    if args.chaos and not (args.resilient and args.workers > 1):
        ap.error("--chaos requires --resilient and --workers > 1")

    cfg = lm_config(args.arch, args.smoke)
    dist = torch.distributed
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if args.workers == 0 and world > 1 and args.concurrency > 1:
        raise ValueError(
            f"--concurrency {args.concurrency} with {world} "
            f"torch.distributed processes: each rank coalesces on its own "
            f"timing, so ranks could all-gather different micro-batches, "
            f"and round r's gather (reduce thread) would overlap round "
            f"r + 1's observation exchange (dispatcher) on one group; "
            f"use --concurrency 1")
    if args.workers == 0 and world > 1 and args.deadline_ms is not None:
        raise ValueError(
            f"--deadline-ms with {world} torch.distributed processes: "
            f"each rank expires queued requests on its own clock, so one "
            f"rank could resolve a request degraded-empty while another "
            f"dispatches it and enters the all-gather alone, and the "
            f"ranks' collectives and sharder rounds would no longer pair "
            f"up; leave --deadline-ms unset")
    if args.workers == 0 and world > 1 and args.resilient:
        raise ValueError(
            f"--resilient with {world} torch.distributed processes: the "
            f"resilient gather is in-process (a sibling thread rescores a "
            f"dead rank's shard), while across processes a dead rank "
            f"cannot be told from a slow collective and the survivors' "
            f"all-gather would wait on it; use --workers N for a "
            f"resilient cluster in one process")

    device = resolve_device(args.device)
    if not os.path.exists(os.path.join(args.data_dir, "queries.jsonl")):
        make_retrieval_dataset(args.data_dir, n_queries=64, n_docs=512,
                               n_topics=32)
    queries, corpus = {}, {}
    for line in open(os.path.join(args.data_dir, "queries.jsonl")):
        rec = json.loads(line)
        queries[rec["_id"]] = rec["text"]
    for line in open(os.path.join(args.data_dir, "corpus.jsonl")):
        rec = json.loads(line)
        corpus[rec["_id"]] = rec["text"]

    retriever = BiEncoderRetriever(DefaultEncoder(cfg))
    collator = RetrievalCollator(DataArguments(vocab_size=cfg.vocab_size),
                                 HashTokenizer(cfg.vocab_size))
    params = retriever.init_params(
        torch.Generator(device=device).manual_seed(0), device=device)
    restored = None
    if args.ckpt_dir:
        # the latest checkpoint's params, in the reference's layout
        # (written by either package's trainer)
        from repro_torch.training.checkpoint import (latest_checkpoint,
                                                     restore_checkpoint)
        path = latest_checkpoint(args.ckpt_dir)
        if path:
            state = restore_checkpoint(
                path, {"step": torch.zeros((), dtype=torch.int32),
                       "params": params, "opt": {},
                       "rng": np.zeros(2, np.uint32)})
            params = state["params"]
            restored = path
            print(f"restored {path}")
    eval_args = EvaluationArguments(topk=args.topk,
                                    score_impl=args.score_impl,
                                    index_impl=args.index_impl,
                                    ivf_nclusters=args.nclusters,
                                    ivf_nprobe=args.nprobe,
                                    serve_max_batch=args.max_batch,
                                    serve_max_wait_ms=args.max_wait_ms,
                                    serve_max_queue=args.max_queue,
                                    round_deadline_s=args.round_deadline_s)
    cache = EmbeddingCache(
        cache_dir(args.data_dir, args.arch, args.smoke, restored),
        dim=cfg.d_model)

    # one micro-batch is one sharded round, and the warm pass below makes
    # one round per rung, so the first steady-state round is known ahead
    # of time: that is where the chaos fault strikes
    n_warm_rounds, b = 1, 1
    while b < args.max_batch:
        n_warm_rounds += 1
        b *= 2
    injector = None
    if args.chaos:
        from repro_torch.core.faults import Fault, FaultInjector
        injector = FaultInjector([Fault(
            kind=args.chaos, worker=1, round=n_warm_rounds,
            phase="gather" if args.chaos == "drop" else "load",
            stall_s=2 * args.round_deadline_s)])

    # -- frontend construction (the expensive pass: corpus encode / cache
    # warm-up and driver setup happen here, once) ----------------------------
    t_prep = time.monotonic()
    if args.workers > 1:
        # W driver instances in this process with a deterministic
        # in-memory all-gather: the code path of W processes
        from repro_torch.launch.distributed import SimulatedCluster
        cluster = SimulatedCluster(args.workers, resilient=args.resilient)
        evs = [RetrievalEvaluator(eval_args, retriever, collator, params,
                                  device=device, process_index=rank,
                                  process_count=args.workers,
                                  gather=cluster.gather,
                                  sharder=cluster.sharder,
                                  fault_injector=injector)
               for rank in range(args.workers)]
        frontend = ServeFrontend.from_cluster(
            evs, cluster, corpus, [cache] * args.workers,
            live=args.mutate)
        mut_ev = evs[0]
        label = (f"{args.workers} simulated workers"
                 + (" (resilient)" if args.resilient else ""))
    elif args.workers == 1:
        # forced single worker, even inside a process group
        ev = RetrievalEvaluator(eval_args, retriever, collator, params,
                                device=device, process_index=0,
                                process_count=1)
        frontend = ServeFrontend.from_evaluator(ev, corpus, cache,
                                                live=args.mutate)
        mut_ev = ev
        label = "1 worker (forced)"
    else:
        # the torch.distributed world (or one process): the evaluator
        # picks the rank, the world size and ProcessAllGather itself
        ev = RetrievalEvaluator(eval_args, retriever, collator, params,
                                device=device)
        frontend = ServeFrontend.from_evaluator(ev, corpus, cache,
                                                live=args.mutate)
        mut_ev = ev
        label = f"{ev.process_count} process(es)"
    prep_s = time.monotonic() - t_prep

    # requests wrap around the query set: every request carries exactly
    # --batch queries
    q_ids = list(queries)
    requests = [[queries[q_ids[(i * args.batch + j) % len(q_ids)]]
                 for j in range(args.batch)]
                for i in range(args.n_requests)]

    # -- explicit warm pass (not timed): every power-of-two rung a
    # coalesced micro-batch can pad to (<= max_batch), so the encoder's
    # shapes and the superchunk autotune (keyed on the query count) are
    # all seen before the request loop --------------------------------------
    t_warm = time.monotonic()
    all_texts = [queries[q] for q in q_ids]
    warm_widths, b = [], 1
    while b < args.max_batch:
        warm_widths.append(b)
        b *= 2
    warm_widths.append(args.max_batch)
    for w in warm_widths:
        frontend.search([all_texts[j % len(all_texts)] for j in range(w)])
    warm_s = time.monotonic() - t_warm
    print(f"prepared corpus ({len(corpus)} docs, cache {len(cache)} rows) "
          f"in {prep_s:.2f}s; warm pass {warm_s * 1e3:.1f} ms on {label}")

    # -- steady-state request loop ------------------------------------------
    latencies = [0.0] * args.n_requests

    def submit_one(i: int) -> None:
        t0 = time.monotonic()
        while True:
            try:
                fut = frontend.submit(requests[i],
                                      deadline_ms=args.deadline_ms)
                break
            except ServeOverloadError:
                time.sleep(0.001)      # accepted-or-retried, never dropped
        ids, scores = fut.result()
        assert ids.shape == (args.batch, args.topk), ids.shape
        latencies[i] = time.monotonic() - t0

    # -- live-corpus writer (--mutate): adds, updates, deletes and one
    # online compaction run beside the request loop; serving swaps
    # generations between micro-batches, never mid-request -----------------
    mut_thread = None
    mut_stats = {"adds": 0, "updates": 0, "deletes": 0, "compactions": 0}
    gen_start = cache.generation_key
    stop_mut = threading.Event()
    if args.mutate:
        doc_ids = list(corpus)

        def _mutate_loop() -> None:
            i = 0
            # at least two iterations, so every run makes an add, an
            # update, a delete and the online compaction even when the
            # request loop finishes first
            while i < 2 or not stop_mut.is_set():
                new_id = f"live-doc-{i}"
                emb = mut_ev._encode_texts(
                    [f"live document {i} arriving mid serve"], False)
                cache.cache_records([new_id], emb)
                mut_stats["adds"] += 1
                upd = doc_ids[i % len(doc_ids)]
                emb = mut_ev._encode_texts([corpus[upd] + f" revised {i}"],
                                           False)
                cache.cache_records([upd], emb)
                mut_stats["updates"] += 1
                if i % 2 == 1:
                    cache.delete_records([f"live-doc-{i - 1}"])
                    mut_stats["deletes"] += 1
                if i == 1:
                    # online compaction: pinned readers keep serving the
                    # retired epoch's files until their rounds drain
                    cache.compact()
                    mut_stats["compactions"] += 1
                i += 1
                stop_mut.wait(0.002)

        mut_thread = threading.Thread(target=_mutate_loop,
                                      name="serve-mutate", daemon=True)
        mut_thread.start()

    t_loop = time.monotonic()
    try:
        if args.concurrency > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(args.concurrency,
                                    thread_name_prefix="serve-client") as pool:
                list(pool.map(submit_one, range(args.n_requests)))
        else:
            for i in range(args.n_requests):
                submit_one(i)
        loop_s = time.monotonic() - t_loop
    finally:
        if mut_thread is not None:
            stop_mut.set()
            mut_thread.join()
        frontend.close()

    for i, lat in enumerate(latencies):
        print(f"request {i}: {args.batch} queries -> top-{args.topk} "
              f"in {lat * 1e3:.1f} ms on {label}")
    lat_ms = np.sort(np.asarray(latencies)) * 1e3
    p50 = float(np.percentile(lat_ms, 50))
    p99 = float(np.percentile(lat_ms, 99))
    qps = args.n_requests * args.batch / loop_s if loop_s > 0 else 0.0
    fs = frontend.stats
    print(f"steady state: p50 {p50:.1f} ms  p99 {p99:.1f} ms  "
          f"{qps:.1f} queries/s  ({fs['batches']} micro-batches, "
          f"largest {fs['max_batch_seen']} queries)")
    if args.chaos:
        # every accepted request resolved (submit_one asserts each
        # result's shape), and the fault really fired
        assert injector.fired, "chaos fault never fired"
        injected = ", ".join(f"{f.kind}@r{f.round}" for f in injector.faults)
        print(f"chaos: injected [{injected}] -> {len(injector.fired)} "
              f"fired, {args.n_requests}/{args.n_requests} requests "
              f"resolved, {fs['degraded']} degraded, {fs['expired']} "
              f"expired")
    if args.mutate:
        gen_end = cache.generation_key
        # the writer really ran: generations advanced and every request
        # above still resolved with full-shape results (submit_one
        # asserts), so serving went on through mutation and compaction
        assert gen_end != gen_start, (gen_start, gen_end)
        assert mut_stats["adds"] > 0, mut_stats
        print(f"mutation: {mut_stats['adds']} adds, "
              f"{mut_stats['updates']} updates, "
              f"{mut_stats['deletes']} deletes, "
              f"{mut_stats['compactions']} compaction(s); generation "
              f"{gen_start} -> {gen_end}, {cache.n_live} live rows, "
              f"{args.n_requests}/{args.n_requests} requests resolved")
    print("serving done")
    return {"label": label, "warm_s": warm_s, "prep_s": prep_s,
            "latencies_ms": [float(x) * 1e3 for x in latencies],
            "p50_ms": p50, "p99_ms": p99, "qps": qps,
            "frontend": dict(fs), "mutation": dict(mut_stats),
            "generation": list(cache.generation_key)}


if __name__ == "__main__":
    main()
