"""User-facing dataset classes (paper §3.2.2): the evaluation half.

Datasets are composed of one or more :class:`MaterializedQRel` sources,
each with its own on-the-fly processing (filter/relabel/sample), combined
lazily — no pre-processed files, fully VCS-trackable via the configs.

The port's copy of the reference's ``core/datasets.py`` holds what
evaluation needs: :func:`_as_mqrels`, :func:`_sources_view` (the lazy
union of several sources' tables) and :class:`EncodingDataset` over the
port's :class:`~repro_torch.core.embedding_cache.EmbeddingCache`.  The
training datasets, ``BinaryDataset`` and ``MultiLevelDataset``, come
with the training slice (ROADMAP queue 1 item 7).  It imports numpy and
no torch module.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.config import MaterializedQRelConfig
from repro_torch.core.materialized_qrel import MaterializedQRel
from repro_torch.data.views import ConcatView, TableView


def _as_mqrels(cfgs, cache_root) -> list[MaterializedQRel]:
    if isinstance(cfgs, (MaterializedQRelConfig, MaterializedQRel)):
        cfgs = [cfgs]
    return [c if isinstance(c, MaterializedQRel)
            else MaterializedQRel(c, cache_root) for c in cfgs]


def _sources_view(sources: Sequence[MaterializedQRel], which: str):
    """Lazy concat view over the sources' query/corpus tables, deduped
    by table path (sources over the same file share one mmap table)."""
    seen: dict = {}
    for m in sources:
        table = getattr(m, which)
        seen.setdefault(table.path, table)
    views = [TableView(t) for t in seen.values()]
    return views[0] if len(views) == 1 else ConcatView(*views)


class EncodingDataset:
    """Items to encode at inference; embedding-cache aware (paper §3.2.2).

    ``dataset[i]`` returns the cached embedding when available, else text
    (from ``texts``, or the title-prefixed record ``table.get(id)``).
    """

    def __init__(self, ids: Sequence, texts: Sequence[str] | None = None,
                 table=None, cache=None, format_fn=None):
        self.ids = list(ids)
        self.texts = texts
        self.table = table
        self.cache = cache
        self.format_fn = format_fn or (lambda t: t)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i: int) -> dict:
        rid = self.ids[i]
        if self.cache is not None and rid in self.cache:
            return {"id": rid, "embedding": self.cache.get_one(rid)}
        if self.texts is not None:
            text = self.texts[i]
        else:
            rec = self.table.get(rid)
            text = f"{rec.get('title', '')} {rec.get('text', '')}".strip()
        return {"id": rid, "text": self.format_fn(text)}
