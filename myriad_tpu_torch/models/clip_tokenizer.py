"""The weightless CLIP tokenizer of the ImageBind text tower (copy of
``HashTokenizer`` from ``myriad_tpu/models/clip_tokenizer.py``).

The port imports nothing of the JAX package, so it keeps its own copy;
``tests/test_torch_myriad.py`` holds the copy equal to the original.  The
BPE tokenizer over a vocab file (``ClipBpeTokenizer``) is not ported.
"""

from __future__ import annotations

import zlib
from typing import List


class HashTokenizer:
    """Deterministic stand-in with CLIP's sot/eot framing for weightless runs."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str, context_length: int = 77) -> List[int]:
        body = [(zlib.crc32(w.encode()) % (self.vocab_size - 3)) + 1
                for w in text.lower().split()]
        ids = [self.sot] + body + [self.eot]
        ids = ids[:context_length]
        if ids[-1] != self.eot:
            ids[-1] = self.eot
        return ids + [0] * (context_length - len(ids))

    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)
