"""RetrievalCollator: tokenize + batch (paper §3.2.2).

The port of ``repro.core.collator``.  Outputs are numpy int32 arrays
(labels as the dataset gave them): the encoder or the trainer moves them
to its device.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.config import DataArguments
from repro_torch.data.tokenizer import HashTokenizer


class RetrievalCollator:
    def __init__(self, args: DataArguments, tokenizer: HashTokenizer,
                 append_eos: bool | None = None):
        self.args = args
        self.tokenizer = tokenizer
        self.append_eos = (args.append_eos if append_eos is None
                           else append_eos)

    def _encode(self, texts, max_len):
        return self.tokenizer.batch_encode(
            texts, max_len, self.append_eos, self.args.pad_to_multiple)

    def __call__(self, features: list[dict]) -> dict:
        """Training batch of dataset items: queries, then each item's
        passages in order, and ``labels`` stacked when items carry
        them."""
        queries = [f["query"] for f in features]
        passages = [p for f in features for p in f["passages"]]
        q_tok, q_mask = self._encode(queries, self.args.query_max_len)
        p_tok, p_mask = self._encode(passages, self.args.passage_max_len)
        batch = {
            "query": {"tokens": q_tok, "mask": q_mask},
            "passage": {"tokens": p_tok, "mask": p_mask},
        }
        if "labels" in features[0]:
            batch["labels"] = np.stack([f["labels"] for f in features])
        return batch

    def max_len_for(self, is_query: bool) -> int:
        """The side's own token budget (queries do not inherit the
        passage budget)."""
        return (self.args.query_max_len if is_query
                else self.args.passage_max_len)

    def encode_texts(self, texts: list[str], max_len: int | None = None,
                     is_query: bool = False):
        """Tokenize free-standing texts -> {"tokens", "mask"} (B, L) int32;
        ``max_len`` defaults to the side's own budget."""
        if max_len is None:
            max_len = self.max_len_for(is_query)
        toks, mask = self._encode(texts, max_len)
        return {"tokens": toks, "mask": mask}
