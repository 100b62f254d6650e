"""RetrievalCollator: tokenize texts for encoding (paper §3.2.2).

The inference half of ``repro.core.collator``; training batches
(``__call__``) come with the training slice.  Outputs are numpy int32
arrays: the encoder moves them to its device.
"""

from __future__ import annotations

from repro_torch.core.config import DataArguments
from repro_torch.data.tokenizer import HashTokenizer


class RetrievalCollator:
    def __init__(self, args: DataArguments, tokenizer: HashTokenizer,
                 append_eos: bool | None = None):
        self.args = args
        self.tokenizer = tokenizer
        self.append_eos = (args.append_eos if append_eos is None
                           else append_eos)

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
        toks, mask = self.tokenizer.batch_encode(
            texts, max_len, self.append_eos, self.args.pad_to_multiple)
        return {"tokens": toks, "mask": mask}
