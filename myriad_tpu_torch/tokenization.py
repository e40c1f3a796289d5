"""The weightless LLaMA tokenizer (copy of ``ByteTokenizer`` from
``myriad_tpu/tokenization.py``).

The port imports nothing of the JAX package, so it keeps its own copy;
``tests/test_torch_myriad.py`` holds the copy equal to the original.  Loading
a real Vicuna tokenizer (``transformers``) is not ported: the card has no
``transformers`` and no tokenizer files.
"""

from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    """Reversible byte-level tokenizer in LLaMA's id conventions.

    ids: 0=pad/unk, 1=bos, 2=eos, bytes b -> 3 + b (3..258).
    """

    vocab_size = 32000
    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 2  # the reference sets pad = eos

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = [3 + b for b in text.encode("utf-8")]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def __call__(self, text, add_special_tokens: bool = False,
                 max_length: Optional[int] = None, **_unused):
        if isinstance(text, str):
            text = [text]
        out = [self.encode(t, add_special_tokens) for t in text]
        if max_length is not None:
            out = [ids[:max_length] for ids in out]
        return {"input_ids": out}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        raw = bytearray()
        for i in ids:
            i = int(i)
            if i >= 3:
                raw.append(min(i - 3, 255))
        return raw.decode("utf-8", errors="replace")

    def batch_decode(self, rows, **kw) -> List[str]:
        return [self.decode(r, **kw) for r in rows]
