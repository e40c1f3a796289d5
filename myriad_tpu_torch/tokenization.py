"""The LLaMA tokenizers: the one a ``tokenizer.model`` holds, and the
weightless ``ByteTokenizer`` (a copy of the JAX package's).

``load_llama_tokenizer(path)`` follows the JAX package's rule: the Vicuna
tokenizer where ``path`` gives one, else ``ByteTokenizer`` with a warning.
The JAX package loads HF's ``LlamaTokenizer``, which needs sentencepiece;
the card has neither sentencepiece nor protobuf nor transformers, so the
port reads the sentencepiece ``ModelProto`` from its protobuf wire format
itself and encodes as HF's LLaMA tokenizer does: the text is split at the
control, unknown and user-defined pieces, each other segment gets the dummy
prefix ``▁`` and has its spaces replaced by ``▁``, its characters are
merged pairwise by BPE (the pair whose merge ranks first, leftmost first;
the ranks order the merged pieces by score, as sentencepiece's BPE does),
and a character outside the vocabulary goes to its UTF-8 ``<0xXX>`` byte
pieces.  Decoding follows HF's defaults (special pieces kept unless
``skip_special_tokens``, byte pieces joined back into UTF-8, one leading
space stripped).  ``tests/test_torch_tokenizer.py`` holds it to
transformers' conversion of the same file, and ``ByteTokenizer`` to the
JAX package's.
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

# sentencepiece piece types (sentencepiece_model.proto; 5 is unused, 6 a byte)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED = 1, 2, 3, 4
BPE = 2  # TrainerSpec.model_type
SPACE = "\u2581"  # sentencepiece's whitespace, "▁"


class ModelProtoError(ValueError):
    """A ``tokenizer.model`` that is not a sentencepiece BPE model."""


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ModelProtoError("truncated varint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise ModelProtoError("varint longer than 10 bytes")


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of one message: an int
    for varint and fixed-width fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = int.from_bytes(buf[pos:pos + 8], "little"), pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = int.from_bytes(buf[pos:pos + 4], "little"), pos + 4
        else:
            raise ModelProtoError(f"field {field}: wire type {wire} is not protobuf's")
        if pos > len(buf):
            raise ModelProtoError(f"field {field} runs past the end of its message")
        yield field, wire, value


def parse_model_proto(data: bytes) -> Dict:
    """The parts of a sentencepiece ``ModelProto`` the tokenizer reads:
    ``pieces`` [(text, score, type)], and from the trainer and normalizer
    specs ``model_type``, ``byte_fallback``, ``unk_id``, ``bos_id``,
    ``eos_id`` and ``add_dummy_prefix`` (protobuf's defaults where absent)."""
    out = {"pieces": [], "model_type": 1, "byte_fallback": False, "unk_id": 0, "bos_id": 1,
           "eos_id": 2, "add_dummy_prefix": True}
    trainer = {3: "model_type", 35: "byte_fallback", 40: "unk_id", 41: "bos_id", 42: "eos_id"}
    for field, wire, value in _fields(data):
        if field == 1 and wire == 2:  # SentencePiece
            text, score, kind = None, 0.0, NORMAL
            for f, w, v in _fields(value):
                if f == 1 and w == 2:
                    text = v.decode("utf-8")
                elif f == 2 and w == 5:
                    score = struct.unpack("<f", v.to_bytes(4, "little"))[0]
                elif f == 3 and w == 0:
                    kind = v
            if text is None:
                raise ModelProtoError(f"piece {len(out['pieces'])} has no text")
            out["pieces"].append((text, score, kind))
        elif field == 2 and wire == 2:  # TrainerSpec
            for f, w, v in _fields(value):
                if f in trainer and w == 0:
                    # ids are int32: a varint of a negative one is its 64-bit two's complement
                    out[trainer[f]] = v - (1 << 64) if v >= 1 << 63 else v
        elif field == 3 and wire == 2:  # NormalizerSpec
            for f, w, v in _fields(value):
                if f == 3 and w == 0:
                    out["add_dummy_prefix"] = bool(v)
    out["byte_fallback"] = bool(out["byte_fallback"])
    if not out["pieces"]:
        raise ModelProtoError("the model holds no pieces")
    return out


def bpe_merge_ranks(pieces: Sequence[Tuple[str, float, int]]) -> Dict[Tuple[str, str], int]:
    """Each mergeable pair (left, right) -> its rank: every split of every
    piece into two pieces of the vocabulary, ordered by the merged piece's
    score (highest first), then the longer left part, then the longer right
    part, then the merged piece's id and the parts' ids.  The LLaMA
    conversion scores its first three pieces 0."""
    vocab = {text: i for i, (text, _, _) in enumerate(pieces)}
    scores: Dict[str, float] = {}
    for i, (text, score, _) in enumerate(pieces):
        scores.setdefault(text, 0.0 if i < 3 else score)
    merges = []
    for text, score in scores.items():
        local = [(text[:k], text[k:], score) for k in range(1, len(text))
                 if text[:k] in vocab and text[k:] in vocab]
        local.sort(key=lambda m: (vocab[m[0]], vocab[m[1]]))
        merges.extend(local)
    merges.sort(key=lambda m: (m[2], len(m[0]), len(m[1])), reverse=True)
    ranks: Dict[Tuple[str, str], int] = {}
    for rank, (left, right, _) in enumerate(merges):
        ranks.setdefault((left, right), rank)
    return ranks


class LlamaTokenizer:
    """A sentencepiece BPE ``tokenizer.model`` with the interface of HF's
    LLaMA tokenizer that the port calls."""

    def __init__(self, model: Dict):
        if model["model_type"] != BPE:
            raise ModelProtoError(f"model_type {model['model_type']}: only BPE ({BPE}) "
                                  "models are read")
        self.pieces: List[str] = [p[0] for p in model["pieces"]]
        self.types: List[int] = [p[2] for p in model["pieces"]]
        self.vocab = {text: i for i, text in enumerate(self.pieces)}
        self.vocab_size = len(self.pieces)
        self.unk_token_id = int(model["unk_id"])
        self.bos_token_id = int(model["bos_id"])
        self.eos_token_id = int(model["eos_id"])
        self.pad_token_id = self.eos_token_id  # the reference sets pad = eos
        self.byte_fallback = bool(model["byte_fallback"])
        self.add_dummy_prefix = bool(model["add_dummy_prefix"])
        self.ranks = bpe_merge_ranks(model["pieces"])
        # pieces matched in the raw text before normalisation, longest first
        self.special = {i for i, t in enumerate(self.types) if t in (UNKNOWN, CONTROL)}
        self.special.update(i for i in (self.unk_token_id, self.bos_token_id,
                                        self.eos_token_id) if 0 <= i < self.vocab_size)
        self.added = sorted((self.pieces[i] for i, t in enumerate(self.types)
                             if t == USER_DEFINED or i in self.special),
                            key=len, reverse=True)

    @classmethod
    def from_file(cls, path: str) -> "LlamaTokenizer":
        with open(path, "rb") as f:
            return cls(parse_model_proto(f.read()))

    # -- encode -----------------------------------------------------------
    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """``text`` as (segment, is an added piece) runs: the leftmost match
        of an added piece, the longest where several start there."""
        out: List[Tuple[str, bool]] = []
        start = pos = 0
        while pos < len(text):
            hit = next((a for a in self.added if text.startswith(a, pos)), None)
            if hit is None:
                pos += 1
                continue
            if pos > start:
                out.append((text[start:pos], False))
            out.append((hit, True))
            pos = start = pos + len(hit)
        if start < len(text):
            out.append((text[start:], False))
        return out

    def _bpe(self, text: str) -> List[int]:
        symbols: List[str] = []
        for ch in text:
            if ch in self.vocab:
                symbols.append(ch)
                continue
            byte_pieces = [f"<0x{b:02X}>" for b in ch.encode("utf-8")]
            if self.byte_fallback and all(p in self.vocab for p in byte_pieces):
                symbols.extend(byte_pieces)
            elif not symbols or symbols[-1] is not None:  # consecutive unknowns fuse
                symbols.append(None)
        while True:
            best = None
            for i in range(len(symbols) - 1):
                rank = self.ranks.get((symbols[i], symbols[i + 1]))
                if rank is not None and (best is None or rank < best[0]):
                    best = (rank, i)
            if best is None:
                break
            i = best[1]
            symbols[i:i + 2] = [symbols[i] + symbols[i + 1]]
        return [self.unk_token_id if s is None else self.vocab[s] for s in symbols]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.bos_token_id] if add_special_tokens else []
        for segment, added in self._split_added(text):
            if added:
                ids.append(self.vocab[segment])
                continue
            if self.add_dummy_prefix:
                segment = SPACE + segment
            ids.extend(self._bpe(segment.replace(" ", SPACE)))
        return ids

    def __call__(self, text, add_special_tokens: bool = True,
                 max_length: Optional[int] = None, **_unused):
        """{"input_ids": ids} for a string, a list of id lists for a list
        (HF's convention); ``max_length`` truncates, bos included."""
        rows = [text] if isinstance(text, str) else list(text)
        out = [self.encode(t, add_special_tokens) for t in rows]
        if max_length is not None:
            out = [ids[:max_length] for ids in out]
        return {"input_ids": out[0] if isinstance(text, str) else out}

    # -- decode -----------------------------------------------------------
    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        pieces: List[str] = []
        for i in ids:
            i = int(i)
            if not 0 <= i < self.vocab_size or (skip_special_tokens and i in self.special):
                continue
            pieces.append(self.pieces[i].replace(SPACE, " "))
        parts: List[str] = []
        run = bytearray()  # consecutive byte pieces
        n_run = 0
        for p in pieces + [None]:
            if p is not None and len(p) == 6 and p.startswith("<0x") and p.endswith(">"):
                try:
                    run.append(int(p[3:5], 16))
                    n_run += 1
                    continue
                except ValueError:
                    pass
            if n_run:
                try:
                    parts.append(run.decode("utf-8"))
                except UnicodeDecodeError:
                    parts.append("�" * n_run)
                run, n_run = bytearray(), 0
            if p is not None:
                parts.append(p)
        text = "".join(parts)
        return text[1:] if text.startswith(" ") else text

    def batch_decode(self, rows, skip_special_tokens: bool = False) -> List[str]:
        return [self.decode(r, skip_special_tokens=skip_special_tokens) for r in rows]


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


def load_llama_tokenizer(path: str = ""):
    """The tokenizer of ``path`` (a Vicuna directory holding
    ``tokenizer.model``, or the file itself) where it gives one; else
    ``ByteTokenizer``, with a warning when a path was named.  A
    ``tokenizer.model`` that does not parse raises ``ModelProtoError``."""
    if path:
        model = os.path.join(path, "tokenizer.model") if os.path.isdir(path) else path
        if os.path.isfile(model):
            return LlamaTokenizer.from_file(model)
        logging.warning("no tokenizer.model at %s; using ByteTokenizer", path)
    return ByteTokenizer()
