#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, each printing its own lines:
  (a) the card (``nvidia-smi`` name and power limit), torch / CUDA
      versions, and the build of the CUDA kernels from the sources in the
      checkout;
  (b) each kernel against its plain PyTorch version on the card, at the
      main-path shapes and at edge shapes: bitwise on integer-valued
      inputs, within TOL on random unit vectors; then each kernel's time,
      its plain version's, one library call's for the same function, and
      its bound;
  (c) trove-base at full width (12 x 768, bf16, seeded random weights) on
      a synthetic dataset through ``RetrievalEvaluator.evaluate`` /
      ``search`` / ``mine_hard_negatives`` with the backend pairs
      (fused, kernel), (torch, kernel) and (torch, torch);
  (d) serving: ``prepare_corpus(device_resident=True)``, then
      ``search_texts`` requests, each timed, the first held against an
      exact float64 top-k;
  (e) launches per path: the counts are set to 0 just before each
      evaluate / search / mine_hard_negatives call of (c) and the serving
      requests of (d), and read just after; each kernel of that path must
      have launched exactly as often as the driver's own stats say (one
      K1 launch per superchunk call, one K2 launch per scored chunk), and
      a kernel off the path not at all.
The second-to-last line is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero without that line.  It imports nothing of JAX and nothing
of the reference package ``repro``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# Score tolerance for float inputs: unit vectors in float32, summed in a
# different order by the kernel and by cuBLAS (each dot product of
# d = 768 terms carries ~1e-7 of rounding; 1e-5 leaves two decades).
TOL = 1e-5
# Main-path shapes: a query batch, trove-base's width, the default depth,
# a superchunk of 64 chunks of encode_batch_size = 32 rows (K1), and a
# K2 chunk of 4096 scores.
Q, D, K, S, C, C2 = 256, 768, 100, 64, 32, 4096
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# and device memory bandwidth.
F32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12


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
    otherwise find the state already full and do less work)."""
    import torch
    for _ in range(3):
        reset()
        fn()
    times = []
    for _ in range(n):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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

    def k1_case(name, q, tile, offs, nvs, k, exact):
        """Two in-place launches on one state (empty, then full)."""
        v, i = ops.empty_state(q.shape[0], k, dev)
        err = 0.0
        for rep in range(2):
            want = ref.fused_score_topk_ref(v, i, q, tile, offs, nvs)
            topk.fused_score_topk_(v, i, q, tile, offs, nvs)
            torch.cuda.synchronize()
            err = max(err, compare(f"K1 {name} #{rep}", (v, i), want,
                                   exact))
            tile = tile.flip(0)
        print(f"[b] K1 {name}: Q={q.shape[0]} S={tile.shape[0]} "
              f"C={tile.shape[1]} d={tile.shape[2]} k={k} "
              f"{'bitwise' if exact else f'max_abs_err={err:.3g}'} ok")
        return err

    def k2_case(name, scores, cids, k, exact):
        v, i = ops.empty_state(scores.shape[0], k, dev)
        err = 0.0
        for rep in range(2):
            want = ref.topk_update_ref(v, i, scores, cids)
            topk.topk_update_(v, i, scores, cids)
            torch.cuda.synchronize()
            err = max(err, compare(f"K2 {name} #{rep}", (v, i), want,
                                   exact))
            cids = cids + scores.shape[1]
            scores = scores.flip(1).contiguous()
        print(f"[b] K2 {name}: Q={scores.shape[0]} C={scores.shape[1]} "
              f"k={k} {'bitwise' if exact else f'max_abs_err={err:.3g}'} "
              f"ok")
        return err

    def steps(s, c, n_valid=None):
        offs = torch.arange(s, dtype=torch.int32, device=dev) * c + 11
        nvs = torch.tensor([c] * s if n_valid is None else n_valid,
                           dtype=torch.int32, device=dev)
        return offs, nvs

    # main-path shapes
    k1_case("main int", ints(Q, D), ints(S, C, D), *steps(S, C), K, True)
    k1_err = k1_case("main float", unit(Q, D), unit(S, C, D), *steps(S, C),
                     K, False)
    k2_case("main int", ints(Q, C2, lo=-4, hi=5),
            torch.arange(C2, dtype=torch.int32, device=dev), K, True)
    k2_err = k2_case("main float", unit(Q, C2),
                     torch.arange(C2, dtype=torch.int32, device=dev), K,
                     False)
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
    sc = ints(13, 300, lo=-3, hi=4)
    sc[torch.rand(13, 300, generator=g, device=dev) < 0.2] = float("nan")
    sc[torch.rand(13, 300, generator=g, device=dev) < 0.2] = float("-inf")
    k2_case("nan/-inf", sc, torch.arange(300, dtype=torch.int32,
                                         device=dev), K, True)
    k2_case("k=256 > C", ints(7, 50),
            torch.arange(50, dtype=torch.int32, device=dev), 256, True)
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

    # timings at the main-path shapes (unit vectors, an empty state reset
    # before each launch, as the first superchunk of a search finds it)
    q, tile = unit(Q, D), unit(S, C, D)
    offs, nvs = steps(S, C)
    scores = unit(Q, C2)
    cids = torch.arange(C2, dtype=torch.int32, device=dev)
    v, i = ops.empty_state(Q, K, dev)
    v0, i0 = v.clone(), i.clone()

    def reset():
        v.copy_(v0)
        i.copy_(i0)

    docs2d = tile.reshape(S * C, D)
    k1 = {
        "ms": median_ms(lambda: topk.fused_score_topk_(
            v, i, q, tile, offs, nvs), reset),
        "plain_ms": median_ms(lambda: ref.fused_score_topk_ref(
            v, i, q, tile, offs, nvs), reset),
        "library_ms": median_ms(lambda: torch.topk(q @ docs2d.T, K),
                                reset),
    }
    k2 = {
        "ms": median_ms(lambda: topk.topk_update_(v, i, scores, cids),
                        reset),
        "plain_ms": median_ms(lambda: ref.topk_update_ref(
            v, i, scores, cids), reset),
        "library_ms": median_ms(lambda: torch.topk(
            torch.cat([v, scores], 1), K), reset),
    }
    # K1 at the serving shape of phase (d): one request of 32 queries and
    # a superchunk of 8 chunks (Q / 4 = 8 blocks on the card)
    nq, ns = min(32, Q), min(8, S)
    sv, si = ops.empty_state(nq, K, dev)
    serve_ms = median_ms(lambda: topk.fused_score_topk_(
        sv, si, q[:nq].contiguous(), tile[:ns].contiguous(), offs[:ns],
        nvs[:ns]), lambda: (sv.fill_(float("-inf")), si.fill_(-1)))
    print(f"[b] fused_score_topk at the serving shape (Q={nq}, S={ns}, "
          f"C={C}): {serve_ms:.4f} ms")
    # bound: the larger of bytes over the memory rate and float32
    # operations over the float32 rate; each input read once, each output
    # written once (the state is read and written)
    state_bytes = 2 * Q * K * 8
    k1_bytes = 4 * (Q * D + S * C * D + 2 * S) + state_bytes
    k1_ops = 2 * Q * int(nvs.sum()) * D
    k2_bytes = 4 * (Q * C2 + C2) + state_bytes
    k2_ops = Q * C2                   # one comparison per score
    out = {}
    for name, info, nbytes, nops, err, replaces in (
            ("fused_score_topk", k1, k1_bytes, k1_ops, k1_err,
             "src/repro/kernels/topk.py:130"),
            ("topk_update", k2, k2_bytes, k2_ops, k2_err,
             "src/repro/kernels/topk.py:67")):
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = nops / F32_FLOPS * 1e3
        out[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": info["ms"], "plain_ms": info["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": info["library_ms"]}
        print(f"[b] {name} at the main-path shapes: kernel "
              f"{info['ms']:.4f} ms, plain {info['plain_ms']:.4f} ms, "
              f"library {info['library_ms']:.4f} ms, bound "
              f"{out[name]['bound_ms']:.4f} ms ({out[name]['bound_by']})")
    return out


# -- (c) + (d) the main path --------------------------------------------------


def on_path(paths: dict, path: str, kernel: str | None, fn, want):
    """Drive one main path with every launch count set to 0 just before
    it and read just after it.  ``kernel`` (if any) must have launched;
    ``want(out)`` gives each kernel's expected launches from the driver's
    own stats of that run (one K1 launch per superchunk call, one K2
    launch per scored chunk, 0 off the path)."""
    from repro_torch.kernels import topk
    topk.reset_launch_counts()
    out = fn()
    got = dict(topk.LAUNCHES)
    expected = want(out)
    if got != expected or (kernel is not None and got[kernel] < 1):
        fail(f"{path}: kernel launches {got}, expected {expected}")
    paths[path] = got
    print(f"[e] {path}: launches {json.dumps(got)} (as the driver's "
          f"calls predict)")
    return out


def phase_main_path(dev, card: str) -> dict:
    """(c) and (d); returns each path's launch counts."""
    import numpy as np
    import torch

    from repro_torch.configs import trove_base
    from repro_torch.core.collator import RetrievalCollator
    from repro_torch.core.config import DataArguments, EvaluationArguments
    from repro_torch.core.evaluator import RetrievalEvaluator
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

    paths: dict = {}
    runs = {}
    for score, heap in (("fused", "kernel"), ("torch", "kernel"),
                        ("torch", "torch")):
        args = EvaluationArguments(
            topk=K, encode_batch_size=C, query_batch_size=Q,
            superchunk_size=S, score_impl=score, heap_impl=heap,
            metrics=("ndcg@10", "mrr@10", "recall@100"))
        ev = RetrievalEvaluator(args, retriever, collator, params,
                                device=dev)
        kernel = ("fused_score_topk" if score == "fused" else
                  "topk_update" if heap == "kernel" else None)

        def want(_, score=score, heap=heap, ev=ev):
            st = ev.last_search_stats
            if st["executor"] != "superchunk":
                fail(f"({score}, {heap}) ran {st['executor']}")
            return {"fused_score_topk": (st["dispatch_rounds"]
                                         if score == "fused" else 0),
                    "topk_update": (st["chunks"] if (score, heap) == (
                        "torch", "kernel") else 0)}

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

    # (torch, kernel) and (torch, torch) share their scores: bitwise
    a, b = runs[("torch", "kernel")], runs[("torch", "torch")]
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        fail("(torch, kernel) != (torch, torch) bitwise")
    # fused sums in another order than cuBLAS: within TOL
    f, t = runs[("fused", "kernel")], runs[("torch", "torch")]
    err = float(np.abs(f[1] - t[1]).max())
    tv = torch.from_numpy(t[1])
    sep = separated(tv).numpy()
    if err > TOL or not np.array_equal(f[0][sep], t[0][sep]):
        fail(f"fused vs torch: max abs score error {err} (tol {TOL}) or "
             f"ids differ beyond the tolerance")
    print(f"[c] (torch, kernel) == (torch, torch) bitwise; fused vs torch "
          f"max abs score error {err:.3g} (tol {TOL}), ids equal on "
          f"{sep.mean():.3f} of slots separated by more than tol")

    # (d) serving: prepare once, one warm-up request (it runs the
    # superchunk autotune, whose launches on synthetic data are not the
    # path's), then requests of 32 queries
    args = EvaluationArguments(topk=K, encode_batch_size=C,
                               query_batch_size=Q)
    ev = RetrievalEvaluator(args, retriever, collator, params, device=dev)
    t0 = time.perf_counter()
    prepared = ev.prepare_corpus(corpus, device_resident=True)
    torch.cuda.synchronize()
    print(f"[d] prepare_corpus(device_resident=True): "
          f"{time.perf_counter() - t0:.3f} s for {len(prepared)} docs")
    corpus_embs = prepared.load_chunk(0, len(prepared))
    if corpus_embs.device != dev:
        fail(f"prepared corpus on {corpus_embs.device}, not {dev}")
    texts = list(queries.values())
    t0 = time.perf_counter()
    ev.search_texts(texts[:32], prepared)
    print(f"[d] warm-up request (superchunk autotune included): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms, S="
          f"{ev.last_search_stats['superchunk_size']}")
    latencies, search_ms, rounds = [], [], []

    def serve():
        for r in range(8):
            req = texts[32 * r: 32 * (r + 1)]
            t0 = time.perf_counter()
            out = ev.search_texts(req, prepared)
            latencies.append((time.perf_counter() - t0) * 1e3)
            # the driver's round: partition, stream, kernels, finalize
            # (the rest of the request is query encoding and id mapping)
            search_ms.append(ev.last_search_stats["seconds"] * 1e3)
            rounds.append(ev.last_search_stats["dispatch_rounds"])
            if r == 0:
                first = (req, out)
        return first

    req, (ids, vals) = on_path(
        paths, "serve: 8 x search_texts (fused, kernel)",
        "fused_score_topk", serve,
        lambda _: {"fused_score_topk": sum(rounds), "topk_update": 0})
    # request 0 against an exact float64 top-k over the same embeddings
    q_emb = ev.encode_pipeline.encode(
        params, req, collator.max_len_for(True),
        fmt=retriever.format_query, device=True,
        batch_size=args.query_batch_size)
    exact = q_emb.double() @ corpus_embs.double().T
    wv, wpos = torch.sort(exact, dim=1, descending=True, stable=True)
    wv = wv[:, :K].float()
    want_ids = prepared.positions_to_ids(wpos[:, :K].cpu().numpy())
    err = float((torch.from_numpy(vals) - wv.cpu()).abs().max())
    sep = separated(wv.cpu()).numpy()
    if err > TOL or not np.array_equal(ids[sep], want_ids[sep]):
        fail(f"search_texts vs exact top-k: error {err}")
    print(f"[d] request 0 vs exact float64 top-k: max abs error {err:.3g}, "
          f"ids equal where separated by more than {TOL}")
    st = ev.last_search_stats
    print(f"[d] search_texts latency ms per request of 32 queries on "
          f"{card}: {json.dumps([round(x, 3) for x in latencies])} "
          f"({st['executor']}, S={st['superchunk_size']} autotuned, "
          f"{rounds[0]} calls per request)")
    print(f"[d] of which the search round (stream + kernels + finalize), "
          f"ms: {json.dumps([round(x, 3) for x in search_ms])}")
    return paths


def main() -> int:
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
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

    kernels = phase_kernels(dev)

    paths = phase_main_path(dev, card)
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
    sys.exit(main())
