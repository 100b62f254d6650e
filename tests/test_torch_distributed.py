"""W > 1 worker processes over ``torch.distributed`` (gloo), on the CPU.

Two and four real processes, each started with ``sys.executable`` and
joined by ``init_distributed(init_method="file://...")`` in a fresh
temporary directory (no port, nothing shared between test workers), run
``RetrievalEvaluator`` with the rank and world size it reads from the
process group and the default ``ProcessAllGather``, on ``device="cpu"``.
Over a warm cache (fixed embeddings) every rank returns, for every
score_impl x heap_impl pair, a result bitwise equal to the port's
in-process W = 1 search and to a ``SimulatedCluster`` of the same W; the
ranks' sharder replicas commit every round through
``exchange_observations``, so they cut the corpus identically.  Every
wait on a child has a timeout; a child that fails or times out fails the
test and the rest are killed.
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import DataArguments, EvaluationArguments
from repro_torch.core.embedding_cache import EmbeddingCache
from repro_torch.core.evaluator import RetrievalEvaluator
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.launch.distributed import SimulatedCluster, init_distributed
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever

pytestmark = pytest.mark.distributed

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 32
PAIRS = [(s, h) for s in ("numpy", "torch", "fused")
         for h in ("python", "torch", "kernel")]
CFG_FIELDS = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "activation", "norm",
              "qkv_bias", "rope_theta", "pooling")
JOIN_S = 120

# One rank: join the group, search the warm cache for every pair with
# one sharder replica, mine hard negatives, write results and stats.
_CHILD = r"""
import json, sys
import numpy as np
import torch

torch.set_num_threads(1)
from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import DataArguments, EvaluationArguments
from repro_torch.core.embedding_cache import EmbeddingCache
from repro_torch.core.evaluator import RetrievalEvaluator
from repro_torch.core.fair_sharding import FairSharder
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.launch.distributed import init_distributed
from repro_torch.models import transformer as tf
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever

work, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
assert init_distributed(init_method=f"file://{work}/rdzv-{world}",
                        world_size=world, rank=rank) == (rank, world)
spec = json.load(open(f"{work}/spec.json"))
cfg = tf.LMConfig(**spec["cfg"], dtype=torch.float32)
params = torch.load(f"{work}/params.pt")
retriever = BiEncoderRetriever(DefaultEncoder(cfg))
collator = RetrievalCollator(DataArguments(vocab_size=257), HashTokenizer(257))
cache = EmbeddingCache(spec["cache"], dim=spec["dim"])
sharder = FairSharder(world)
arrays, stats = {}, []
for score, heap in spec["pairs"]:
    ev = RetrievalEvaluator(
        EvaluationArguments(topk=10, encode_batch_size=20, score_impl=score,
                            heap_impl=heap), retriever, collator, params,
        device="cpu", sharder=sharder)
    assert (ev.process_index, ev.process_count) == (rank, world)
    assert type(ev.gather).__name__ == "ProcessAllGather"
    qh, ids, vals = ev.search(spec["queries"], spec["corpus"], cache=cache)
    # no reference to the group outlives destroy_process_group
    assert vars(ev.gather) == {}
    arrays[f"{score}-{heap}-ids"] = ids
    arrays[f"{score}-{heap}-vals"] = vals
    st = ev.last_search_stats
    stats.append({k: st[k] for k in ("lo", "hi", "round", "items")})
negs = ev.mine_hard_negatives(
    spec["queries"], spec["corpus"], spec["qrels"], depth=8,
    output_path=f"{work}/negs-{world}-{rank}.tsv", cache=cache)
np.savez(f"{work}/out-{world}-{rank}.npz", **arrays)
json.dump({"stats": stats, "n_negs": len(negs),
           "throughput": sharder.throughput.tolist()},
          open(f"{work}/out-{world}-{rank}.json", "w"))
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def setup(tiny_lm_cfg, tiny_params, retrieval_data, tmp_path_factory):
    """The inputs the children read, a warm cache, and the port's
    in-process W = 1 results over it."""
    work = tmp_path_factory.mktemp("gloo")
    fields = {f: getattr(tiny_lm_cfg, f) for f in CFG_FIELDS}
    cfg = tf.LMConfig(**fields, dtype=torch.float32)
    params = params_from_jax(jax.tree.map(np.asarray, tiny_params), cfg,
                             device="cpu")
    torch.save(params, work / "params.pt")
    retriever = BiEncoderRetriever(DefaultEncoder(cfg))
    collator = RetrievalCollator(DataArguments(vocab_size=257),
                                 HashTokenizer(257))
    cache = EmbeddingCache(str(work / "cache"), dim=DIM)

    def make(score, heap, **kw):
        return RetrievalEvaluator(
            EvaluationArguments(topk=10, encode_batch_size=20,
                                score_impl=score, heap_impl=heap),
            retriever, collator, params, device="cpu", **kw)

    queries, corpus = retrieval_data["queries"], retrieval_data["corpus"]
    make("numpy", "kernel").search(queries, corpus, cache=cache)  # warm it
    want = {pair: make(*pair).search(queries, corpus, cache=cache)
            for pair in PAIRS}
    spec = {"cfg": fields, "cache": str(work / "cache"), "dim": DIM,
            "pairs": PAIRS, "queries": queries, "corpus": corpus,
            "qrels": retrieval_data["qrels"]}
    (work / "spec.json").write_text(json.dumps(spec))
    return {"work": work, "make": make, "cache": cache, "want": want}


def _wait_all(procs, timeout: float) -> None:
    """Return once every process has exited, one has failed, or
    ``timeout`` seconds have passed."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [proc.poll() for proc in procs]
        if None not in codes or any(c not in (None, 0) for c in codes):
            return
        time.sleep(0.05)


def _run_ranks(work, world: int) -> list[dict]:
    """Start ``world`` ranks, each writing its own log, wait for them
    all within one timeout, and return each rank's results; a failed or
    timed-out rank fails the test with its log's tail, and every rank
    still running is killed."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    logs = [work / f"rank-{world}-{rank}.log" for rank in range(world)]
    procs = []
    try:
        for rank in range(world):
            with open(logs[rank], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _CHILD, str(work), str(rank),
                     str(world)], cwd=str(work), env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        t0 = time.monotonic()
        _wait_all(procs, JOIN_S)
        waited = time.monotonic() - t0
        bad = [f"rank {rank} of {world} "
               + (f"still running after {waited:.1f} s (limit {JOIN_S} s), "
                  "killed" if proc.returncode is None
                  else f"exited {proc.returncode}")
               + f":\n{logs[rank].read_text()[-3000:]}"
               for rank, proc in enumerate(procs) if proc.returncode != 0]
        if bad:
            pytest.fail("\n".join(bad))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=JOIN_S)
    return [{"arrays": dict(np.load(work / f"out-{world}-{rank}.npz")),
             **json.loads((work / f"out-{world}-{rank}.json").read_text())}
            for rank in range(world)]


@pytest.mark.parametrize("world", (2, 4))
def test_gloo_ranks_match_w1_and_simulated_cluster(setup, retrieval_data,
                                                   world):
    ranks = _run_ranks(setup["work"], world)
    queries, corpus = retrieval_data["queries"], retrieval_data["corpus"]
    for pair in PAIRS:
        _, want_ids, want_vals = setup["want"][pair]
        cluster = SimulatedCluster(world)
        evs = [setup["make"](*pair, process_index=rank,
                             process_count=world, gather=cluster.gather,
                             sharder=cluster.sharder)
               for rank in range(world)]
        sim = cluster.run(lambda rank: evs[rank].search(
            queries, corpus, cache=setup["cache"]))
        key = "-".join(pair)
        for rank, got in enumerate(ranks):
            ids, vals = got["arrays"][f"{key}-ids"], got["arrays"][
                f"{key}-vals"]
            assert ids.dtype == want_ids.dtype
            assert vals.dtype == want_vals.dtype
            np.testing.assert_array_equal(ids, want_ids)
            np.testing.assert_array_equal(vals, want_vals)
            np.testing.assert_array_equal(ids, sim[rank][1])
            np.testing.assert_array_equal(vals, sim[rank][2])
    n_docs = len(corpus)
    for i, pair in enumerate(PAIRS):
        st = [got["stats"][i] for got in ranks]
        assert [s["round"] for s in st] == [i] * world
        # identical cuts on every replica: rank r's shard ends where
        # rank r + 1's begins, and together they cover the corpus
        assert st[0]["lo"] == 0 and st[-1]["hi"] == n_docs
        assert [s["lo"] for s in st[1:]] == [s["hi"] for s in st[:-1]]
        assert sum(s["items"] for s in st) == n_docs
    # every replica committed every round: the same throughput EMA
    assert all(got["throughput"] == ranks[0]["throughput"]
               for got in ranks)
    assert ranks[0]["throughput"] != [1.0] * world
    # mine_hard_negatives wrote once, from rank 0
    work = setup["work"]
    assert (work / f"negs-{world}-0.tsv").exists()
    assert not any((work / f"negs-{world}-{r}.tsv").exists()
                   for r in range(1, world))
    lines = (work / f"negs-{world}-0.tsv").read_text().splitlines()
    assert len(lines) == ranks[0]["n_negs"] > 0
    assert len({got["n_negs"] for got in ranks}) == 1


def test_init_distributed_without_a_launch():
    """No process group requested: a no-op returning (0, 1), and an
    evaluator defaults to one worker with no gather."""
    assert init_distributed() == (0, 1)
    assert init_distributed(world_size=1, rank=0) == (0, 1)
    assert not torch.distributed.is_initialized()
