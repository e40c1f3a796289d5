"""CLIP tokenizers for the ImageBind text tower (copies of ``ClipBpeTokenizer``
and ``HashTokenizer`` from ``myriad_tpu/models/clip_tokenizer.py``).

``ClipBpeTokenizer`` is OpenAI CLIP's byte-pair encoding over the merges of
``bpe_simple_vocab_16e6.txt.gz`` (a path the user supplies; not bundled):
byte-level unicode mapping, the lowercasing regex, the first 49152 - 256 - 2
merges, sot and eot at the end of the vocabulary.  ``HashTokenizer`` is the
deterministic stand-in with CLIP's sot/eot framing for weightless runs.  The
port imports nothing of the JAX package, so it keeps its own copies;
``tests/test_torch_myriad.py`` and ``tests/test_torch_vision_experts.py`` hold
them equal to the originals.  Both use the standard library only.
"""

from __future__ import annotations

import functools
import gzip
import html
import re
import zlib
from typing import Dict, List, Tuple


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipBpeTokenizer:
    """OpenAI-CLIP compatible tokenizer; vocab 49408, sot 49406, eot 49407."""

    PAT = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+"
                     r"|[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)

    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(merge) for merge in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def encode(self, text: str, context_length: int = 77) -> List[int]:
        ids = [self.sot] + self.encode_text(text) + [self.eot]
        ids = ids[:context_length]
        return ids + [0] * (context_length - len(ids))

    def decode(self, ids) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()


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
