"""Tokenizers for the text conditioner (port of
jen1_tpu/conditioning/tokenizer.py).

`ByteTokenizer` is byte-identical to the JAX package's. `HFTokenizer` loads
a `transformers` tokenizer from local files only; `get_tokenizer` falls back
to bytes, with a warning, when that fails (no local files, or no
`transformers` installed).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class ByteTokenizer:
    """UTF-8 bytes -> ids in [3, 258]; 0 = pad, 1 = eos. Deterministic."""

    vocab_size = 259
    pad_id = 0
    eos_id = 1

    def __call__(self, texts: List[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.zeros((len(texts), max_length), dtype=np.int32)
        mask = np.zeros((len(texts), max_length), dtype=bool)
        for i, text in enumerate(texts):
            raw = list(text.encode("utf-8"))[: max_length - 1]
            seq = [b + 3 for b in raw] + [self.eos_id]
            ids[i, : len(seq)] = seq
            mask[i, : len(seq)] = True
        return ids, mask


class HFTokenizer:
    """`transformers.AutoTokenizer` from local files, pad-to-max_length."""

    def __init__(self, model_name_or_path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(model_name_or_path, local_files_only=True)
        self.vocab_size = self._tok.vocab_size

    def __call__(self, texts: List[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        enc = self._tok(texts, truncation=True, max_length=max_length,
                        padding="max_length", return_tensors="np")
        return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(bool)


def get_tokenizer(model_name_or_path: Optional[str] = None):
    """The HF tokenizer when its files load locally, else the byte tokenizer
    with a warning (its ids do not match a pretrained T5 vocabulary)."""
    if model_name_or_path is not None:
        try:
            return HFTokenizer(model_name_or_path)
        except (ImportError, OSError, ValueError) as e:
            import warnings

            warnings.warn(
                f"jen1_tpu_torch: could not load the HF tokenizer for "
                f"{model_name_or_path!r} ({type(e).__name__}); falling back to the "
                "byte-level tokenizer. Token ids will NOT match T5 vocabulary - "
                "fine for hermetic tests, wrong for pretrained T5 weights.",
                UserWarning,
                stacklevel=2,
            )
    return ByteTokenizer()
