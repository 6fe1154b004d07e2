"""Tokenizer wrapper around HuggingFace AutoTokenizer (a copy of
hyvideo_prfl_tpu/utils/tokenizers.py; ``transformers`` is imported only
when a tokenizer is built, so the port imports without it).

Parity target: reference `wan/modules/tokenizers.py:37-82`
(HuggingfaceTokenizer): AutoTokenizer + optional text cleaning
('whitespace' | 'lower' | 'canonicalize'), fixed seq_len padding, returns
(ids, mask). ftfy-based canonicalization degrades gracefully when ftfy is
absent (it is not baked into this image; whitespace cleaning — the mode all
shipped configs use — has no such dependency).
"""

from __future__ import annotations

import html
import re
import string
from typing import List, Optional, Sequence, Tuple

import numpy as np


def basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def canonicalize(text: str, keep_punctuation_exact_string=None) -> str:
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(str.maketrans("", "", string.punctuation))
            for part in text.split(keep_punctuation_exact_string)
        )
    else:
        text = text.translate(str.maketrans("", "", string.punctuation))
    text = text.lower()
    return re.sub(r"\s+", " ", text).strip()


class HuggingfaceTokenizer:
    """AutoTokenizer wrapper returning fixed-length (ids, mask) numpy arrays."""

    def __init__(self, name: str, seq_len: Optional[int] = None,
                 clean: Optional[str] = "whitespace", **kwargs):
        from transformers import AutoTokenizer

        self.name = name
        self.seq_len = seq_len
        self.clean = clean
        self.tokenizer = AutoTokenizer.from_pretrained(name, **kwargs)
        self.vocab_size = self.tokenizer.vocab_size

    def _clean(self, text: str) -> str:
        if self.clean == "whitespace":
            return whitespace_clean(basic_clean(text))
        if self.clean == "lower":
            return whitespace_clean(basic_clean(text)).lower()
        if self.clean == "canonicalize":
            return canonicalize(basic_clean(text))
        return text

    def __call__(self, sequence, return_mask: bool = False,
                 add_special_tokens: bool = True, **kwargs
                 ) -> Tuple[np.ndarray, ...]:
        texts = [sequence] if isinstance(sequence, str) else list(sequence)
        texts = [self._clean(t) for t in texts]
        kwargs.setdefault("padding", "max_length" if self.seq_len else True)
        kwargs.setdefault("truncation", bool(self.seq_len))
        if self.seq_len:
            kwargs.setdefault("max_length", self.seq_len)
        out = self.tokenizer(
            texts, return_tensors="np",
            add_special_tokens=add_special_tokens, **kwargs,
        )
        if return_mask:
            return out["input_ids"], out["attention_mask"]
        return (out["input_ids"],)
