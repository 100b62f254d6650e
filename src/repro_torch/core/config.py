"""Configuration objects of the port (paper §3.1).

The port's own ``DataArguments`` / ``ModelArguments`` /
``RetrievalTrainingArguments`` / ``EvaluationArguments`` /
``MaterializedQRelConfig``, and ``parse_cli`` to build them from
``--field value`` pairs.
``EvaluationArguments`` validates the port's backend names in
``__post_init__`` without importing anything: the
reference class imports the JAX heap and driver to validate, and its
names (``jax``, ``pallas``, ``pallas_fused``) are not the port's.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
from typing import Any, Callable, Sequence

# Scoring backends of ShardedSearchDriver: "numpy" = host q @ d.T
# baseline; "torch" = device matmul then the heap merge; "fused" = the
# fused score + top-k kernel (K1), the (Q, N) score matrix never exists.
SCORE_IMPLS = ("numpy", "torch", "fused")
# FastResultHeapq merges: "python" = heapq baseline; "torch" = the plain
# sort-based merge; "kernel" = the streaming top-k merge kernel (K2).
HEAP_IMPLS = ("python", "torch", "kernel")
# Search indexes: "flat" scans every row; "ivf" the probed clusters'.
INDEX_IMPLS = ("flat", "ivf")


@dataclasses.dataclass
class DataArguments:
    query_max_len: int = 32
    passage_max_len: int = 128
    group_size: int = 2                  # 1 positive + (group_size-1) negatives
    append_eos: bool = False
    vocab_size: int = 50304              # hashing-tokenizer vocab
    pad_to_multiple: int = 8


@dataclasses.dataclass
class ModelArguments:
    encoder_class: str = "lm"            # encoder registry alias
    temperature: float = 0.02
    loss: str = "infonce"                # loss registry alias or callable


@dataclasses.dataclass
class RetrievalTrainingArguments:
    """The reference's fields and defaults; ``output_dir`` is under the
    temporary directory."""

    output_dir: str = os.path.join(tempfile.gettempdir(), "trove_run")
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    warmup_steps: int = 10
    max_steps: int = 100
    per_device_batch_size: int = 8
    grad_accum_steps: int = 1
    optimizer: str = "adamw"             # adamw | adafactor
    grad_clip: float = 1.0
    checkpoint_every: int = 50
    keep_checkpoints: int = 2
    async_checkpoint: bool = True
    grad_compression: str = "none"       # none | bf16 | int8
    seed: int = 0
    log_every: int = 10
    aux_loss_weight: float = 0.01        # MoE load-balance loss


@dataclasses.dataclass
class EvaluationArguments:
    topk: int = 100
    encode_batch_size: int = 32
    query_batch_size: int = 256
    metrics: tuple[str, ...] = ("ndcg@10", "mrr@10", "recall@100")
    heap_impl: str = "kernel"            # kernel | torch | python
    score_impl: str = "fused"            # fused | torch | numpy
    # Double-buffered chunk pipeline: chunk i+1's load/encode overlaps
    # chunk i's scoring.  Same results either way.
    async_prefetch: bool = True
    # Superchunk executor (device score/heap backends): fold this many
    # streamed chunks into one call of kernels.ops.superchunk_update.
    # 0 = autotune from a warmup measurement; 1 = one call per chunk;
    # N > 1 = fixed.  Identical rankings either way.
    superchunk_size: int = 0
    # Cap on the stacked (S, C, d) superchunk tile per call.
    superchunk_max_mb: int = 64
    # Bucketed encode pipeline: ladder rung count; 0 = per-batch
    # pad-to-longest encoding.
    encode_buckets: int = 6
    tokenizer_workers: int = 2
    # Windows of text tokenized ahead of the device encode stage.
    encode_pipeline_depth: int = 2
    # Continuous-batching serve frontend defaults (core.serving): a
    # micro-batch flushes at serve_max_batch coalesced queries or after
    # serve_max_wait_ms from its first request, whichever first;
    # serve_max_queue bounds pending requests (admission control —
    # submissions beyond it fast-fail with ServeOverloadError).
    serve_max_batch: int = 32
    serve_max_wait_ms: float = 2.0
    serve_max_queue: int = 256
    # Search index (repro_torch.index).  "flat" = exhaustive scan over
    # every corpus row (the recall oracle); "ivf" = cluster-pruned
    # inverted-file search: a mini-batch k-means coarse quantizer over
    # ivf_nclusters clusters, and each query batch scans only the union
    # of its ivf_nprobe nearest clusters.  nprobe == nclusters scans
    # every row (through the same kernels, in cluster order).
    index_impl: str = "flat"             # flat | ivf
    ivf_nclusters: int = 64
    ivf_nprobe: int = 8
    # k-means budget: a fixed step count of contiguous mini-batch reads;
    # deterministic under ivf_seed (every worker builds the same index).
    ivf_train_steps: int = 40
    ivf_train_batch: int = 1024
    ivf_seed: int = 0
    # Fault tolerance (core.faults, resilient gathers only): how long a
    # round waits for a silent worker before reassigning its shard to a
    # survivor, how many rescore attempts an orphaned shard gets before
    # the round degrades to partial coverage, and the exponential-
    # backoff base between attempts.
    round_deadline_s: float = 30.0
    shard_retries: int = 2
    shard_retry_backoff_s: float = 0.05

    def __post_init__(self):
        if self.score_impl not in SCORE_IMPLS:
            raise ValueError(
                f"unknown score_impl {self.score_impl!r}; expected one "
                f"of {list(SCORE_IMPLS)}")
        if self.heap_impl not in HEAP_IMPLS:
            raise ValueError(
                f"unknown heap_impl {self.heap_impl!r}; expected one "
                f"of {list(HEAP_IMPLS)}")
        if self.index_impl not in INDEX_IMPLS:
            raise ValueError(
                f"unknown index_impl {self.index_impl!r}; expected one "
                f"of {list(INDEX_IMPLS)}")
        for name, floor in (("topk", 1), ("encode_batch_size", 1),
                            ("query_batch_size", 1),
                            ("superchunk_size", 0),
                            ("superchunk_max_mb", 1),
                            ("encode_buckets", 0),
                            ("tokenizer_workers", 0),
                            ("encode_pipeline_depth", 0),
                            ("serve_max_batch", 1),
                            ("serve_max_queue", 1),
                            ("ivf_nclusters", 1),
                            ("ivf_nprobe", 1),
                            ("ivf_train_steps", 1),
                            ("ivf_train_batch", 1)):
            if getattr(self, name) < floor:
                raise ValueError(
                    f"{name} must be >= {floor}, got {getattr(self, name)}")
        if self.serve_max_wait_ms < 0:
            raise ValueError(f"serve_max_wait_ms must be >= 0, got "
                             f"{self.serve_max_wait_ms}")
        if self.round_deadline_s <= 0:
            raise ValueError(f"round_deadline_s must be > 0, got "
                             f"{self.round_deadline_s}")
        if self.shard_retries < 0:
            raise ValueError(f"shard_retries must be >= 0, got "
                             f"{self.shard_retries}")
        if self.shard_retry_backoff_s < 0:
            raise ValueError(f"shard_retry_backoff_s must be >= 0, got "
                             f"{self.shard_retry_backoff_s}")


def parse_cli(*arg_classes, argv: Sequence[str] | None = None):
    """Minimal HfArgumentParser equivalent: ``--field value`` pairs (or
    ``--field=value``; a trailing ``--flag`` is "true").  Each of
    ``arg_classes`` takes the keys that name its fields, other keys are
    ignored; one instance per class, a tuple for several."""
    argv = list(sys.argv[1:] if argv is None else argv)
    kv: dict[str, str] = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("--"):
            if "=" in tok:
                k, v = tok[2:].split("=", 1)
                kv[k] = v
                i += 1
            else:
                kv[tok[2:]] = argv[i + 1] if i + 1 < len(argv) else "true"
                i += 2
        else:
            i += 1
    out = []
    for cls in arg_classes:
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: dict[str, Any] = {}
        for name, field in fields.items():
            if name not in kv:
                continue
            raw = kv[name]
            typ = field.type if isinstance(field.type, type) else type(
                field.default)
            if typ is bool:
                kwargs[name] = raw.lower() in ("1", "true", "yes")
            elif typ in (int, float):
                kwargs[name] = typ(raw)
            elif typ is tuple or isinstance(field.default, tuple):
                kwargs[name] = tuple(x.strip() for x in raw.split(","))
            else:
                kwargs[name] = raw
        out.append(cls(**kwargs))
    return tuple(out) if len(out) > 1 else out[0]


@dataclasses.dataclass
class MaterializedQRelConfig:
    """How one (query, corpus, qrel) source is loaded & processed on the fly.

    Mirrors the paper's options: score-window filtering, relabeling,
    per-query random subsetting of documents, query-id subsetting, and
    arbitrary user callbacks.  The fields and defaults of the
    reference's class, so one config names the same cache directories in
    either package.
    """

    qrel_path: str = ""
    query_path: str = ""
    corpus_path: str = ""
    # filtering / transformation (applied lazily, in this order)
    min_score: float | None = None
    max_score: float | None = None
    filter_fn: Callable[..., Any] | None = None     # (qid, did, score) -> bool
    new_label: float | None = None                  # relabel kept triplets
    transform_fn: Callable[..., Any] | None = None  # (score) -> score
    group_random_k: int | None = None               # sample k docs per query
    query_subset_from: str | None = None            # qrel file giving query ids
    loader: str | None = None                       # registered loader name
    seed: int = 0
