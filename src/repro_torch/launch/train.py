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
a ValueError, as the reference's launcher drives LM encoders only.  Not
ported yet, and raising: llama4-maverick at full width and ``--mesh pod
| multipod`` / ``--multi-pod`` (ROADMAP queue 1 item 10).  ``main``
returns the trainer and its final state.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def _not_ported(flag: str, item: int, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} needs {what}, which the port does not have yet "
        f"(ROADMAP queue 1 item {item})")


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
    if args.multi_pod or args.mesh != "local":
        raise _not_ported("--mesh pod / multipod and --multi-pod", 10,
                          "a device mesh across cards")
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
        dev_dataset=None, compute_metrics=IRMetrics(), device=device)
    state = trainer.train()
    for rec in trainer.logs:
        print(rec)
    print(f"done at step {int(state['step'])}; "
          f"checkpoints in {train_args.output_dir}/checkpoints")
    return trainer, state


if __name__ == "__main__":
    main()
