#!/usr/bin/env python3
"""Time the serving frontend of one checkout on one NVIDIA GPU, at the
shape of ``chip_smoke.py`` phase (d1).

    python3 scripts/serve_latency.py [--src CHECKOUT/src] [--repeats N]

``--src`` (default: this checkout's ``src``) is the directory that holds
the ``repro_torch`` package to time, so two trees can be compared in one
run on one card: an unpacked ``git archive`` of another commit, then this
one (run them parent, change, change, parent).  The shape: trove-base at
full width (12 x 768, bfloat16) with random weights from seed 0, the
synthetic dataset of 256 queries and 8192 documents, a
``ServeFrontend.from_evaluator`` over the device-resident corpus with
k = 100, chunks of 32 rows and S = 64 on (fused, kernel).  After a warm
pass over every power-of-two micro-batch rung up to 32, each repeat times
8 serial requests of 32 queries (host clock, submit to result) and then
64 single-query requests from 8 client threads (per-request p50 / p99 and
queries per second over the wall time of the 64).  Prints the card's name
and power limit, then one JSON line:
``{"src": ..., "card": ..., "repeats": [{"serial_median_ms": ...,
"single_p50_ms": ..., "single_p99_ms": ..., "single_qps": ...}, ...]}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 0
N_QUERIES, N_DOCS, N_TOPICS = 256, 8192, 64
K, C, S = 100, 32, 64
SERIAL, SINGLE, THREADS, MAX_BATCH = 8, 64, 8, 32
RESULT_S = 300


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(here, "src"))
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    src = os.path.abspath(args.src)
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"serve_latency.py: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_latency.py: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs import trove_base
    from repro_torch.core.collator import RetrievalCollator
    from repro_torch.core.config import DataArguments, EvaluationArguments
    from repro_torch.core.evaluator import RetrievalEvaluator
    from repro_torch.core.serving import ServeFrontend
    from repro_torch.data.synthetic import make_retrieval_dataset
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.device import resolve_device
    from repro_torch.models.encoder import DefaultEncoder
    from repro_torch.models.retriever import BiEncoderRetriever

    dev = resolve_device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    cfg = trove_base.get_config()
    retriever = BiEncoderRetriever(DefaultEncoder(cfg))
    params = retriever.init_params(
        torch.Generator(device=dev).manual_seed(SEED), device=dev)
    collator = RetrievalCollator(DataArguments(vocab_size=cfg.vocab_size),
                                 HashTokenizer(cfg.vocab_size))
    with tempfile.TemporaryDirectory() as tmp:
        queries, corpus, _ = make_retrieval_dataset(
            tmp, n_queries=N_QUERIES, n_docs=N_DOCS, n_topics=N_TOPICS,
            seed=SEED)
    texts = list(queries.values())
    ev = RetrievalEvaluator(
        EvaluationArguments(topk=K, encode_batch_size=C,
                            query_batch_size=N_QUERIES, superchunk_size=S,
                            score_impl="fused", heap_impl="kernel"),
        retriever, collator, params, device=dev)
    fe = ServeFrontend.from_evaluator(ev, corpus, max_batch=MAX_BATCH)
    repeats = []
    try:
        rung = 1
        while rung <= MAX_BATCH:
            fe.search(texts[:rung], timeout=RESULT_S)
            rung *= 2
        for _ in range(args.repeats):
            serial_ms = []
            for r in range(SERIAL):
                t0 = time.perf_counter()
                fe.search(texts[32 * r: 32 * (r + 1)], timeout=RESULT_S)
                serial_ms.append((time.perf_counter() - t0) * 1e3)
            single_ms = [0.0] * SINGLE

            def client(i):
                t0 = time.perf_counter()
                fe.submit(texts[i]).result(timeout=RESULT_S)
                single_ms[i] = (time.perf_counter() - t0) * 1e3

            t0 = time.perf_counter()
            with ThreadPoolExecutor(THREADS) as pool:
                list(pool.map(client, range(SINGLE)))
            wall = time.perf_counter() - t0
            repeats.append({
                "serial_median_ms": statistics.median(serial_ms),
                "single_p50_ms": float(np.percentile(single_ms, 50)),
                "single_p99_ms": float(np.percentile(single_ms, 99)),
                "single_qps": SINGLE / wall})
    finally:
        fe.close()
    print(json.dumps({"src": src, "card": card, "repeats": repeats}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
