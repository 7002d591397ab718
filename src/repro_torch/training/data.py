"""Synthetic data pipeline: deterministic, seekable token streams, a copy
of ``repro.training.data`` (numpy only, so the same seed gives the same
batches bit for bit in both packages).

Produces next-token-prediction batches (tokens, labels) with document
boundaries (EOS-separated variable-length docs) so the loss mask and packing
logic are exercised like a real pipeline. Whisper batches additionally get
random frame embeddings from the stubbed audio frontend.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


class TokenStream:
    """Deterministic infinite stream of EOS-packed synthetic documents."""

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 mean_doc_len: int = 512):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.mean_doc_len = mean_doc_len
        self.eos = cfg.vocab_size - 1
        self._buf = np.empty((0,), np.int32)

    def _refill(self, need: int):
        docs = []
        total = self._buf.size
        while total < need:
            n = max(2, int(self.rng.exponential(self.mean_doc_len)))
            doc = self.rng.integers(0, self.cfg.vocab_size - 1, n).astype(np.int32)
            doc[-1] = self.eos
            docs.append(doc)
            total += n
        if docs:
            self._buf = np.concatenate([self._buf] + docs)

    def batch(self, batch_size: int, seq_len: int):
        need = batch_size * (seq_len + 1)
        self._refill(need)
        flat = self._buf[:need]
        self._buf = self._buf[need:]
        arr = flat.reshape(batch_size, seq_len + 1)
        tokens = arr[:, :-1].copy()
        labels = arr[:, 1:].copy()
        out = {"tokens": tokens, "labels": labels}
        if self.cfg.is_encoder_decoder:
            out["enc_feats"] = (self.rng.standard_normal(
                (batch_size, self.cfg.encoder_seq, self.cfg.d_model))
                .astype(np.float32) * 0.02)
        return out

    def __iter__(self):
        return self

    def batches(self, batch_size: int, seq_len: int):
        while True:
            yield self.batch(batch_size, seq_len)
