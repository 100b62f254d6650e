"""Multi-dataset retrieval eval suite (paper §3.2 + §3.5 combined).

Evaluates one retriever over N datasets — per-dataset metrics AND a
combined pass where every query set is scored against the lazily
concatenated union of all corpora (``ConcatView``): the union is never
built on disk or in RAM.  Writes nDCG/MRR/recall tables (JSON +
markdown) into ``--out-dir``.

  # two synthetic datasets, trove-base cut to 2 x 64, on the CPU
  python -m repro_torch.launch.evalsuite --smoke --device cpu \\
      --out-dir results

  # the same through qwen2-0.5b's reduced form
  python -m repro_torch.launch.evalsuite --arch qwen2-0.5b --smoke \\
      --device cpu --out-dir results

  # your own BEIR-style dataset dirs (queries.jsonl, corpus.jsonl,
  # qrels/train.tsv each), 4 simulated workers, on the card
  python -m repro_torch.launch.evalsuite --data-dirs /d/fiqa,/d/scifact \\
      --workers 4 --out-dir results

The port of ``repro.launch.evalsuite``, with the port's backend names
(``--score-impl numpy | torch | fused``, default ``fused``) and
``--device`` (``cuda`` by default; without a card it raises unless
``--device cpu`` is given).  The encoder is ``--arch``: trove-base (the
default), qwen2-0.5b, stablelm-3b, gemma-7b, or the MoE stacks
granite-moe-3b-a800m and llama4-maverick-400b-a17b (``--smoke``: its
``reduced()`` form in float32), with seeded random weights; another
family's arch raises a ValueError (the launchers drive LM encoders only,
as the reference's do), and llama4-maverick at full width names ROADMAP
queue 1 item 10.  The shared embedding cache
is the encoder's own, ``DATA_ROOT/emb_cache/ARCH[-smoke]``
(``launch.serve.cache_dir``).  Each scenario runs
through ``RetrievalEvaluator`` -> ``ShardedSearchDriver``, so
``--workers N`` runs N workers in this process (``SimulatedCluster``)
and every pass, the combined one included, is sharded across them.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time


def build_scenarios(data_dirs, cache_root: str) -> dict[str, dict]:
    """BEIR-style dataset dirs -> named (queries, corpus, qrels) views.

    Each dataset loads through :class:`MaterializedQRel` (mmap tables,
    grouped qrels), so queries/corpus are lazy ``TableView``s and qrels
    come hash-keyed from the grouped arrays — no full-dataset dicts.
    """
    from repro_torch.core.config import MaterializedQRelConfig
    from repro_torch.core.materialized_qrel import MaterializedQRel

    scenarios: dict[str, dict] = {}
    for d in data_dirs:
        name = os.path.basename(os.path.normpath(d))
        m = MaterializedQRel(MaterializedQRelConfig(
            qrel_path=os.path.join(d, "qrels", "train.tsv"),
            query_path=os.path.join(d, "queries.jsonl"),
            corpus_path=os.path.join(d, "corpus.jsonl")), cache_root)
        scenarios[name] = {"queries": m.queries_view(),
                           "corpus": m.corpus_view(),
                           "qrels": m.qrels_dict()}
    return scenarios


def make_synthetic_suite(root: str, n_datasets: int = 2,
                         n_queries: int = 16, n_docs: int = 96,
                         n_topics: int = 8) -> list[str]:
    """N synthetic datasets with disjoint id spaces (``d{i}-`` prefixes).
    A dataset directory that already holds ``queries.jsonl`` is reused
    as it is."""
    from repro_torch.data.synthetic import make_retrieval_dataset

    dirs = []
    for i in range(n_datasets):
        d = os.path.join(root, f"d{i}")
        if not os.path.exists(os.path.join(d, "queries.jsonl")):
            make_retrieval_dataset(
                d, n_queries=n_queries, n_docs=n_docs, n_topics=n_topics,
                seed=100 + i, id_prefix=f"d{i}-")
        dirs.append(d)
    return dirs


def main(argv=None):
    import torch

    from repro_torch.core.collator import RetrievalCollator
    from repro_torch.core.config import DataArguments, EvaluationArguments
    from repro_torch.core.embedding_cache import EmbeddingCache
    from repro_torch.core.evaluator import (RetrievalEvaluator,
                                            format_metrics_table)
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import ARCH_HELP, cache_dir, lm_config
    from repro_torch.models.encoder import DefaultEncoder
    from repro_torch.models.retriever import BiEncoderRetriever

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="trove-base",
                    help=ARCH_HELP)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch cut to 2 x 64 (its reduced() form) in "
                         "float32 (fast CI path)")
    ap.add_argument("--data-dirs", default=None,
                    help="comma-separated BEIR-style dataset dirs; default: "
                         "generate --datasets synthetic ones under "
                         "--data-root")
    ap.add_argument("--data-root",
                    default=os.path.join(tempfile.gettempdir(),
                                         "trove_evalsuite"))
    ap.add_argument("--datasets", type=int, default=2)
    ap.add_argument("--n-queries", type=int, default=16)
    ap.add_argument("--n-docs", type=int, default=96)
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--suite-name", default="evalsuite")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--workers", type=int, default=1,
                    help="N > 1 = N sharded workers in this process "
                         "(SimulatedCluster)")
    ap.add_argument("--score-impl", default="fused",
                    choices=("numpy", "torch", "fused"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--no-cache", action="store_true",
                    help="skip the shared embedding cache (online regime)")
    args = ap.parse_args(argv)

    cfg = lm_config(args.arch, args.smoke)
    device = resolve_device(args.device)
    if args.data_dirs:
        data_dirs = args.data_dirs.split(",")
    else:
        data_dirs = make_synthetic_suite(
            args.data_root, args.datasets, n_queries=args.n_queries,
            n_docs=args.n_docs)
    scenarios = build_scenarios(
        data_dirs, os.path.join(args.data_root, "cache"))

    retriever = BiEncoderRetriever(DefaultEncoder(cfg))
    collator = RetrievalCollator(DataArguments(vocab_size=cfg.vocab_size),
                                 HashTokenizer(cfg.vocab_size))
    params = retriever.init_params(
        torch.Generator(device=device).manual_seed(0), device=device)
    eval_args = EvaluationArguments(topk=args.topk,
                                    score_impl=args.score_impl)
    cache = (None if args.no_cache else EmbeddingCache(
        cache_dir(args.data_root, args.arch, args.smoke), dim=cfg.d_model))

    t0 = time.monotonic()
    if args.workers > 1:
        from repro_torch.launch.distributed import SimulatedCluster
        cluster = SimulatedCluster(args.workers)
        evs = [RetrievalEvaluator(eval_args, retriever, collator, params,
                                  device=device, process_index=rank,
                                  process_count=args.workers,
                                  gather=cluster.gather,
                                  sharder=cluster.sharder)
               for rank in range(args.workers)]
        results = cluster.run(lambda rank: evs[rank].evaluate_suite(
            scenarios, cache=cache, out_dir=args.out_dir,
            suite_name=args.suite_name))[0]
        label = f"{args.workers} simulated workers"
    else:
        ev = RetrievalEvaluator(eval_args, retriever, collator, params,
                                device=device)
        results = ev.evaluate_suite(scenarios, cache=cache,
                                    out_dir=args.out_dir,
                                    suite_name=args.suite_name)
        label = f"{ev.process_count} process(es)"
    dt = time.monotonic() - t0

    print(format_metrics_table(results), end="")
    sizes = ", ".join(f"{n}: {len(sc['qrels'])}q/"
                      f"{len(sc['corpus'])}d"
                      for n, sc in scenarios.items())
    print(f"evalsuite: {len(scenarios)} datasets ({sizes}) on {label} "
          f"({device}) in {dt:.1f}s -> "
          f"{os.path.join(args.out_dir, args.suite_name)}.{{json,md}}")
    return results


if __name__ == "__main__":
    main()
