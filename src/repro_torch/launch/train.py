"""End-to-end training driver on one card.

    python -m repro_torch.launch.train --smoke --device cpu --output_dir DIR
    python -m repro_torch.launch.train --output_dir DIR --max_steps 20
    python -m repro_torch.launch.train --arch gemma-7b --optimizer adafactor

The port of ``repro.launch.train``: builds the synthetic-or-given
retrieval dataset through ``MaterializedQRel`` (``--data-dir``, written
by ``make_retrieval_dataset(256 queries, 2048 docs, 64 topics)`` when it
has no ``queries.jsonl``), a ``BiEncoderRetriever`` on the ``--arch``
backbone (trove-base, the default, qwen2-0.5b, stablelm-3b, gemma-7b,
granite-moe-3b-a800m, or llama4-maverick-400b-a17b with ``--smoke``),
and runs ``RetrievalTrainer`` (gradient accumulation, async checkpoints
under ``OUTPUT_DIR/checkpoints``, fault tolerance).  ``--smoke`` is the
arch's ``reduced()`` form, 2 x 64 in float32.  ``--device`` is ``cuda``
by default and raises without a card unless ``--device cpu`` is given.
Every other ``--field value`` goes through ``parse_cli`` to
``RetrievalTrainingArguments`` / ``ModelArguments`` / ``DataArguments``;
``--optimizer adafactor`` is the one that fits gemma-7b on one card
(AdamW's float32 moments alone are 63.6 GiB there).  The full-width
configs checkpoint each layer in the backward (``remat``).

An MoE backbone adds ``aux_loss_weight`` (0.01) x its load-balance
loss to the contrastive loss and logs it as ``moe_aux_loss``.  An
``--arch`` outside the LM encoders (the GNN, the recsys rankers) raises
a ValueError, as the reference's launcher drives LM encoders only.
llama4-maverick at full width raises (ROADMAP queue 1 item 10).

``--mesh pod`` (16 x 16) or ``--mesh multipod`` / ``--multi-pod`` (2 x
16 x 16) train on the production mesh (``launch.mesh``): run under a
process group of 256 / 512 ranks (``torchrun``'s environment; rank ``r``
takes card ``LOCAL_RANK``).  The backend is NCCL when every local rank
has a card of its own and gloo otherwise, and the launch prints which.
Without such a group the launcher raises the mesh's ValueError, naming
the world size it needs, before any work.  ``main`` returns the trainer
and its final state.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def production_mesh(multi_pod: bool, device: str):
    """Join the process group ``torchrun``'s environment describes and
    bind the production mesh to it; a ValueError naming the world size
    the mesh needs when there is no such group."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh, production_shape

    shape, _ = production_shape(multi_pod)
    need = 1
    for s in shape:
        need *= s
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized():
        if world != need:
            raise ValueError(
                f"a {shape} mesh needs {need} ranks; this launch has "
                f"{world} (run it under torchrun with {need} processes)")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        own_cards = (device != "cpu" and torch.cuda.is_available()
                     and torch.cuda.device_count() >= local_world)
        backend = "nccl" if own_cards else "gloo"
        if own_cards:
            torch.cuda.set_device(local)
        dist.init_process_group(backend, init_method="env://")
        print(f"rank {dist.get_rank()} of {dist.get_world_size()}: "
              f"backend {backend}")
    return make_production_mesh(multi_pod=multi_pod)


def main(argv=None):
    from repro_torch.core.collator import RetrievalCollator
    from repro_torch.core.config import (DataArguments, MaterializedQRelConfig,
                                         ModelArguments,
                                         RetrievalTrainingArguments,
                                         parse_cli)
    from repro_torch.core.datasets import BinaryDataset
    from repro_torch.core.metrics import IRMetrics
    from repro_torch.data.synthetic import make_retrieval_dataset
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import ARCH_HELP, lm_config
    from repro_torch.models.encoder import DefaultEncoder
    from repro_torch.models.retriever import BiEncoderRetriever
    from repro_torch.training.trainer import RetrievalTrainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="trove-base",
                    help=ARCH_HELP)
    ap.add_argument("--data-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "trove_data"))
    ap.add_argument("--smoke", action="store_true",
                    help="the arch cut to 2 x 64 (its reduced() form) in "
                         "float32")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="local",
                    choices=["local", "pod", "multipod"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args, rest = ap.parse_known_args(argv)

    cfg = lm_config(args.arch, args.smoke)
    mesh = None
    if args.multi_pod or args.mesh != "local":
        mesh = production_mesh(args.multi_pod or args.mesh == "multipod",
                               args.device)
    train_args, model_args, data_args = parse_cli(
        RetrievalTrainingArguments, ModelArguments, DataArguments,
        argv=rest)
    device = resolve_device(args.device)

    if not os.path.exists(os.path.join(args.data_dir, "queries.jsonl")):
        make_retrieval_dataset(args.data_dir, n_queries=256, n_docs=2048,
                               n_topics=64)

    tok = HashTokenizer(cfg.vocab_size)
    data_args.vocab_size = cfg.vocab_size
    retriever = BiEncoderRetriever.from_model_args(
        model_args, cfg, encoder=DefaultEncoder(cfg))
    collator = RetrievalCollator(data_args, tok)
    pos = MaterializedQRelConfig(
        min_score=1,
        qrel_path=os.path.join(args.data_dir, "qrels", "train.tsv"),
        query_path=os.path.join(args.data_dir, "queries.jsonl"),
        corpus_path=os.path.join(args.data_dir, "corpus.jsonl"))
    dataset = BinaryDataset(
        data_args, retriever.format_query, retriever.format_passage,
        pos, pos, cache_root=os.path.join(args.data_dir, "cache"))

    trainer = RetrievalTrainer(
        retriever, train_args, collator, dataset,
        dev_dataset=None, compute_metrics=IRMetrics(), mesh=mesh,
        device=device)
    state = trainer.train()
    for rec in trainer.logs:
        print(rec)
    print(f"done at step {int(state['step'])}; "
          f"checkpoints in {train_args.output_dir}/checkpoints")
    return trainer, state


if __name__ == "__main__":
    main()
