"""Phoneme-string <-> id-sequence codec.

Parity surface: utils/text/tokenizer.py:6-17 in the reference — unknown
symbols are silently dropped in both directions.
"""
from __future__ import annotations

from typing import List

import numpy as np

from forwardtacotron_tpu_torch.text.symbols import phonemes


class Tokenizer:

    def __init__(self) -> None:
        self.symbol_to_id = {s: i for i, s in enumerate(phonemes)}
        self.id_to_symbol = {i: s for i, s in enumerate(phonemes)}

    def __call__(self, text: str) -> List[int]:
        return [self.symbol_to_id[t] for t in text if t in self.symbol_to_id]

    def decode(self, sequence) -> str:
        return ''.join(self.id_to_symbol[int(s)] for s in sequence
                       if int(s) in self.id_to_symbol)

    def encode_padded(self, text: str, max_len: int) -> np.ndarray:
        """Tokenize and right-pad with PAD (=0) to a static length for jit."""
        ids = self(text)[:max_len]
        out = np.zeros(max_len, dtype=np.int32)
        out[:len(ids)] = ids
        return out
