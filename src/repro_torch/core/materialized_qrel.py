"""MaterializedQRel: on-the-fly retrieval data management (paper §3.2).

Holds query, corpus and qrel records *by id only*; text is materialized
lazily, per instance, from memory-mapped tables.  Qrel triplets are
grouped by query id with a sort-based groupby (the Polars role in the
paper), filtered/relabeled per the config, and the grouped arrays are
cached to disk (fingerprinted, atomic) so subsequent runs are ~instant
(paper Table 4).

Resident memory = grouped qrel id arrays (mmap'd) + touched text pages —
the paper's 2.6x memory reduction mechanism (Table 1).

The port's own copy of the reference's ``core/materialized_qrel.py``.
Its tables and grouped-qrel arrays live under the same fingerprinted
directory names (``tables/<fp>``, ``groups/<fp>/{qids,offsets,dids,
scores}.npy``) as the reference's for the same files and config, so
either package reuses what the other built.  It imports numpy and no
torch module.
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

from repro_torch.core.config import MaterializedQRelConfig
from repro_torch.data.loaders import load_qrels, load_records
from repro_torch.data.table import (MMapTable, atomic_write_dir,
                                    config_fingerprint, file_fingerprint)
from repro_torch.data.views import TableView


def _fn_digest(fn) -> str | None:
    """Cache-key contribution of a user callback.

    ``__name__`` alone collides: every lambda is ``"<lambda>"``, so two
    different filters would silently share a cached grouped-qrel dir.
    Digest the bytecode plus everything that parameterizes it (consts,
    names, closure cell values) so behaviourally different callables get
    different keys, while re-defining the same lambda across runs keeps
    hitting the cache.
    """
    if fn is None:
        return None
    code = getattr(fn, "__code__", None)
    if code is None:                      # builtins / C callables
        return getattr(fn, "__name__", repr(fn))
    payload = code.co_code + repr(
        (code.co_consts, code.co_names, code.co_varnames)).encode()
    closure = getattr(fn, "__closure__", None)
    if closure:
        try:
            payload += repr([c.cell_contents for c in closure]).encode()
        except ValueError:                # empty cell
            payload += b"<empty-cell>"
    defaults = getattr(fn, "__defaults__", None)
    if defaults:
        payload += repr(defaults).encode()
    return hashlib.blake2b(payload, digest_size=8).hexdigest()


def _config_key(cfg: MaterializedQRelConfig) -> str:
    stable = (cfg.min_score, cfg.max_score, cfg.new_label,
              cfg.group_random_k, cfg.query_subset_from, cfg.seed,
              _fn_digest(cfg.filter_fn), _fn_digest(cfg.transform_fn))
    return config_fingerprint(stable)


class MaterializedQRel:
    def __init__(self, cfg: MaterializedQRelConfig,
                 cache_root: str | None = None):
        if cache_root is None:
            cache_root = os.path.join(tempfile.gettempdir(), "trove_cache")
        self.cfg = cfg
        self.cache_root = cache_root
        os.makedirs(cache_root, exist_ok=True)

        self.queries = self._table(cfg.query_path)
        self.corpus = self._table(cfg.corpus_path)
        self._load_groups()

    # -- tables ---------------------------------------------------------------
    def _table(self, path: str) -> MMapTable:
        fp = file_fingerprint(path)
        return MMapTable.build_cached(
            lambda: load_records(path), os.path.join(self.cache_root,
                                                     "tables"), fp)

    # -- qrel grouping ---------------------------------------------------------
    def _load_groups(self):
        fp = file_fingerprint(self.cfg.qrel_path, _config_key(self.cfg))
        gdir = os.path.join(self.cache_root, "groups", fp)
        if not os.path.exists(os.path.join(gdir, "qids.npy")):
            self._build_groups(gdir)
        self.group_qids = np.load(os.path.join(gdir, "qids.npy"),
                                  mmap_mode="r")
        self.group_offsets = np.load(os.path.join(gdir, "offsets.npy"),
                                     mmap_mode="r")
        self.group_dids = np.load(os.path.join(gdir, "dids.npy"),
                                  mmap_mode="r")
        self.group_scores = np.load(os.path.join(gdir, "scores.npy"),
                                    mmap_mode="r")

    def _build_groups(self, gdir: str):
        cfg = self.cfg
        qids, dids, scores = load_qrels(cfg.qrel_path, cfg.loader)

        keep = np.ones(len(qids), bool)
        if cfg.min_score is not None:
            keep &= scores >= cfg.min_score
        if cfg.max_score is not None:
            keep &= scores <= cfg.max_score
        if cfg.query_subset_from:
            sub_q, _, _ = load_qrels(cfg.query_subset_from)
            keep &= np.isin(qids, np.unique(sub_q))
        if cfg.filter_fn is not None:
            keep &= np.fromiter(
                (bool(cfg.filter_fn(q, d, s))
                 for q, d, s in zip(qids, dids, scores)),
                bool, len(qids))
        qids, dids, scores = qids[keep], dids[keep], scores[keep]

        if cfg.transform_fn is not None:
            scores = np.asarray(
                [cfg.transform_fn(s) for s in scores], np.float32)
        if cfg.new_label is not None:
            scores = np.full_like(scores, cfg.new_label)

        order = np.argsort(qids, kind="stable")
        qids, dids, scores = qids[order], dids[order], scores[order]
        uniq, starts = np.unique(qids, return_index=True)
        offsets = np.concatenate([starts, [len(qids)]]).astype(np.int64)

        with atomic_write_dir(gdir) as tmp:
            np.save(os.path.join(tmp, "qids.npy"), uniq)
            np.save(os.path.join(tmp, "offsets.npy"), offsets)
            np.save(os.path.join(tmp, "dids.npy"), dids)
            np.save(os.path.join(tmp, "scores.npy"),
                    scores.astype(np.float32))

    # -- access -----------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.group_qids)

    @property
    def query_id_hashes(self) -> np.ndarray:
        return np.asarray(self.group_qids)

    def group(self, qid_hash: int, rng: np.random.Generator | None = None):
        """(doc id hashes, labels) for one query — ids only, no text."""
        pos = int(np.searchsorted(self.group_qids, qid_hash))
        if pos >= len(self.group_qids) or self.group_qids[pos] != qid_hash:
            return (np.empty(0, np.int64), np.empty(0, np.float32))
        lo, hi = int(self.group_offsets[pos]), int(self.group_offsets[pos + 1])
        dids = np.asarray(self.group_dids[lo:hi])
        scores = np.asarray(self.group_scores[lo:hi])
        k = self.cfg.group_random_k
        if k is not None and len(dids) > k:
            rng = rng or np.random.default_rng(
                (self.cfg.seed * 0x9E3779B1 + qid_hash) & 0xFFFFFFFF)
            sel = rng.choice(len(dids), size=k, replace=False)
            dids, scores = dids[sel], scores[sel]
        return dids, scores

    # -- views -----------------------------------------------------------------
    def queries_view(self):
        """Lazy :class:`TableView` over the query table."""
        return TableView(self.queries)

    def corpus_view(self):
        """Lazy :class:`TableView` over the corpus table."""
        return TableView(self.corpus)

    def qrels_dict(self) -> dict[int, dict[int, float]]:
        """Grouped qrels as ``{qid_hash: {did_hash: score}}``.

        Hash-keyed, so it feeds ``RetrievalEvaluator.evaluate`` directly
        (``stable_id_hash`` is the identity on already-hashed int ids).
        Materializes id/score pairs only — no text.
        """
        out: dict[int, dict[int, float]] = {}
        for pos, qid in enumerate(np.asarray(self.group_qids)):
            lo = int(self.group_offsets[pos])
            hi = int(self.group_offsets[pos + 1])
            out[int(qid)] = {
                int(d): float(s)
                for d, s in zip(self.group_dids[lo:hi],
                                self.group_scores[lo:hi])}
        return out

    def query_text(self, qid_hash: int) -> str:
        return self.queries.get(qid_hash).get("text", "")

    def doc(self, did_hash: int) -> dict:
        return self.corpus.get(did_hash)

    def doc_text(self, did_hash: int) -> str:
        rec = self.doc(did_hash)
        title = rec.get("title", "")
        return f"{title} {rec.get('text', '')}".strip()
