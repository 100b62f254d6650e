"""repro_torch: the PyTorch + CUDA port of the dense-retrieval toolkit.

The JAX package ``repro`` stays as the reference; this package sits
beside it, imports ``torch`` and never ``jax`` or anything of ``repro``,
and runs on an NVIDIA card unless the caller passes ``device="cpu"``.
Its hand-written kernels (``repro_torch.kernels``) are CUDA C++ for
Hopper, built from the sources in the checkout at first use.

Exports resolve lazily (PEP 562), so importing the package loads no
torch module it does not need.
"""

import importlib

_EXPORTS = {
    "RetrievalCollator": "repro_torch.core.collator",
    "DataArguments": "repro_torch.core.config",
    "EvaluationArguments": "repro_torch.core.config",
    "ModelArguments": "repro_torch.core.config",
    "MaterializedQRelConfig": "repro_torch.core.config",
    "RetrievalTrainingArguments": "repro_torch.core.config",
    "parse_cli": "repro_torch.core.config",
    "MaterializedQRel": "repro_torch.core.materialized_qrel",
    "EncodingDataset": "repro_torch.core.datasets",
    "BinaryDataset": "repro_torch.core.datasets",
    "MultiLevelDataset": "repro_torch.core.datasets",
    "RetrievalEvaluator": "repro_torch.core.evaluator",
    "EmbeddingCache": "repro_torch.core.embedding_cache",
    "compute_metrics": "repro_torch.core.metrics",
    "IRMetrics": "repro_torch.core.metrics",
    "FastResultHeapq": "repro_torch.core.result_heap",
    "FairSharder": "repro_torch.core.fair_sharding",
    "ShardedSearchDriver": "repro_torch.core.sharded_search",
    "SimulatedCluster": "repro_torch.launch.distributed",
    "HashTokenizer": "repro_torch.data.tokenizer",
    "MMapTable": "repro_torch.data.table",
    "register_loader": "repro_torch.data.loaders",
    "DatasetView": "repro_torch.data.views",
    "TableView": "repro_torch.data.views",
    "DictView": "repro_torch.data.views",
    "RecordsView": "repro_torch.data.views",
    "FilterView": "repro_torch.data.views",
    "MapView": "repro_torch.data.views",
    "SelectView": "repro_torch.data.views",
    "ConcatView": "repro_torch.data.views",
    "InterleaveView": "repro_torch.data.views",
    "DefaultEncoder": "repro_torch.models.encoder",
    "PretrainedEncoder": "repro_torch.models.encoder",
    "get_encoder": "repro_torch.models.encoder",
    "RetrievalLoss": "repro_torch.models.losses",
    "get_loss": "repro_torch.models.losses",
    "BiEncoderRetriever": "repro_torch.models.retriever",
    "GradedBiEncoderRetriever": "repro_torch.models.retriever",
    "PretrainedRetriever": "repro_torch.models.retriever",
    "RetrievalTrainer": "repro_torch.training.trainer",
    "params_from_jax": "repro_torch.models.convert",
    "recsys_params_from_jax": "repro_torch.models.convert",
    "RecSysArch": "repro_torch.configs.recsys_arch",
    "get_arch": "repro_torch.configs",
    "resolve_device": "repro_torch.device",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return __all__
