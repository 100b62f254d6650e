"""Retriever = encoder + retrieval logic (paper §3.3): inference part.

``BiEncoderRetriever`` encodes queries and passages with one encoder.
The losses and ``forward`` come with the training slice.
"""

from __future__ import annotations

from repro_torch.core.config import ModelArguments
from repro_torch.models.encoder import PretrainedEncoder, get_encoder

class PretrainedRetriever:
    def __init__(self, encoder: PretrainedEncoder, temperature=0.02):
        self.encoder = encoder
        self.temperature = temperature

    @classmethod
    def from_model_args(cls, model_args: ModelArguments, encoder_cfg,
                        encoder: PretrainedEncoder | None = None):
        """Build a retriever from argument objects (paper workflow);
        ``encoder`` may be any object with the encoder duck-type."""
        enc = encoder or get_encoder(model_args.encoder_class, encoder_cfg)
        return cls(enc, model_args.temperature)

    def init_params(self, generator, device="cuda"):
        return self.encoder.init_params(generator, device)

    def format_query(self, text):
        return self.encoder.format_query(text)

    def format_passage(self, text, title=""):
        return self.encoder.format_passage(text, title)


class BiEncoderRetriever(PretrainedRetriever):
    def encode_query(self, params, batch):
        return self.encoder.encode(params, batch)

    def encode_passage(self, params, batch):
        return self.encoder.encode(params, batch)
