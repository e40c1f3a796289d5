"""The port's LLaMA tokenizer (``myriad_tpu_torch/tokenization.py``), read
from a ``tokenizer.model`` without sentencepiece or protobuf, against
transformers' conversion of the same file, on the CPU.

The test writes a small sentencepiece BPE model with transformers' bundled
``sentencepiece_model_pb2`` and protobuf: LLaMA's layout (<unk>, <s>, </s>,
the 256 byte pieces, byte fallback on, the dummy prefix), merges learned
from the repository's prompt files, and the pieces '▁###', '###', '##',
'#' and '▁#'.  The oracle is transformers' ``LlamaConverter`` output
wrapped in ``LlamaTokenizerFast``; without sentencepiece installed, the
converter takes the proto's own vocabulary and scores through
``convert_slow_tokenizer.generate_merges``.  Over the stated text set (every
line of prompts/alignment.txt and prompts/test_prompt.txt, the AQA answer
templates, the eval's question, the chat prompt's pieces, '###', runs of
spaces and newlines, the empty string, text that needs byte fallback, and
the special pieces inside text) the ids, with and without bos, and the
decodes, with and without ``skip_special_tokens``, are identical
(tolerance 0).  ``from_config(llama_model=dir)`` builds a model whose prompt
ids, target ids (``end_sym``), lookup ids and decoded row equal the JAX
``Myriad``'s given the oracle tokenizer.
"""

import collections
import importlib
import logging
import os
import types

import numpy as np
import pytest

from myriad_tpu.datasets.anomaly_detection import (ABNORMAL_DESCRIBE, ABNORMAL_DESCRIBE_V1,
                                                   NORMAL_DESCRIBE, QUESTION_PROMPTS)
from myriad_tpu.models.myriad import Myriad as JaxMyriad
from myriad_tpu_torch.models.myriad import Myriad
from myriad_tpu_torch.tokenization import (ByteTokenizer, LlamaTokenizer, ModelProtoError,
                                           load_llama_tokenizer, parse_model_proto)
import chip_smoke
from test_torch_myriad import REPO
import torch_threads  # noqa: F401  (one torch thread a test process)

cst = importlib.import_module("transformers.convert_slow_tokenizer")
pb2 = cst.import_protobuf()
SPACE = "▁"


def _prompt_lines():
    lines = []
    for name in ("alignment.txt", "test_prompt.txt"):
        with open(os.path.join(REPO, "prompts", name)) as f:
            lines += f.read().splitlines()
    return lines


def _learn_merges(lines, n_merges=300):
    """Characters and BPE merges of the lines' words, most frequent first
    (ties by the pair).  The prompt files hold none of the byte-fallback
    texts' characters."""
    words = collections.Counter(SPACE + w for line in lines for w in line.split(" ") if w)
    chars = sorted({c for w in words for c in w})
    segs = {w: list(w) for w in words}
    merged = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, n in words.items():
            for a, b in zip(segs[w], segs[w][1:]):
                pairs[(a, b)] += n
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merged.append(a + b)
        for w, s in segs.items():
            out, i = [], 0
            while i < len(s):
                if i + 1 < len(s) and (s[i], s[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            segs[w] = out
    return chars, merged


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    chars, merged = _learn_merges(_prompt_lines())
    m = pb2.ModelProto()

    def add(piece, score, kind):
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, kind

    add("<unk>", 0.0, 2)
    add("<s>", 0.0, 3)
    add("</s>", 0.0, 3)
    for b in range(256):
        add(f"<0x{b:02X}>", 0.0, 6)
    seen, rank = set(), 0
    for piece in [SPACE + "###", "###", "##", SPACE + "#"] + merged + chars + ["#"]:
        if piece not in seen:
            seen.add(piece)
            add(piece, -float(rank), 1)
            rank += 1
    m.trainer_spec.model_type = 2
    m.trainer_spec.byte_fallback = True
    m.trainer_spec.unk_id, m.trainer_spec.bos_id = 0, 1
    m.trainer_spec.eos_id, m.trainer_spec.pad_id = 2, -1
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.add_dummy_prefix = True
    m.normalizer_spec.remove_extra_whitespaces = False
    root = tmp_path_factory.mktemp("vicuna")
    (root / "tokenizer.model").write_bytes(m.SerializeToString())
    return root / "tokenizer.model"


class _Extractor:
    """``SentencePieceExtractor`` without sentencepiece: the merges from the
    proto's own vocabulary and scores."""

    def __init__(self, path):
        pass

    def extract(self, vocab_scores=None):
        vocab = {piece: i for i, (piece, _) in enumerate(vocab_scores)}
        return vocab, cst.generate_merges(vocab, vocab_scores)


class _Converter(cst.LlamaConverter):
    SpmExtractor = _Extractor


@pytest.fixture(scope="module")
def oracle(model_file):
    from transformers import LlamaTokenizerFast

    proto = pb2.ModelProto()
    proto.ParseFromString(model_file.read_bytes())
    slow = types.SimpleNamespace(vocab_file=str(model_file), legacy=True,
                                 add_prefix_space=True,
                                 convert_ids_to_tokens=lambda i: proto.pieces[i].piece)
    tok = LlamaTokenizerFast(tokenizer_object=_Converter(slow).converted(), bos_token="<s>",
                             eos_token="</s>", unk_token="<unk>", legacy=True,
                             add_bos_token=True, add_eos_token=False)
    tok.pad_token = tok.eos_token  # as the JAX loader sets it
    return tok


@pytest.fixture(scope="module")
def port(model_file):
    return LlamaTokenizer.from_file(str(model_file))


_before, _after = ("###Human: " + "<Img><ImageHere></Img>" + QUESTION_PROMPTS[1]
                   + " ###Assistant: ").split("<ImageHere>")
TEXTS = {
    "alignment": _prompt_lines()[:1],
    "test_prompt": _prompt_lines()[1:],
    "templates": [NORMAL_DESCRIBE, ABNORMAL_DESCRIBE, ABNORMAL_DESCRIBE_V1,
                  NORMAL_DESCRIBE + "###", ABNORMAL_DESCRIBE + "\n"],
    "question": ["<Img><ImageHere></Img>" + QUESTION_PROMPTS[1], QUESTION_PROMPTS[1]],
    "prompt_pieces": [_before, _after, "###Human: <Img>", "</Img> Is there any defect? "
                      "###Assistant: ", "Give the following image: <Img>ImageContent</Img>."],
    "stops": ["###", "##", "#", " ###", "a###b", "### ###", "\n###"],
    "whitespace": [" ", "   ", "a  b   c", "\n", "\n\n", " \n \n", "tab\there", "end  "],
    "empty": [""],
    "byte_fallback": ["é", "café au lait", "中文", "缺陷 defect", "🙂", "ok 👍🏽 done"],
    "special_pieces": ["<s>", "a</s>b", "x<unk>y <s> z"],
}


@pytest.mark.parametrize("group", sorted(TEXTS))
def test_encode_matches_the_oracle(oracle, port, group):
    for text in TEXTS[group]:
        for special in (False, True):
            want = oracle(text, add_special_tokens=special)["input_ids"]
            assert port(text, add_special_tokens=special)["input_ids"] == want, (text, special)
            assert port.encode(text, add_special_tokens=special) == want


@pytest.mark.parametrize("group", sorted(TEXTS))
def test_decode_matches_the_oracle(oracle, port, group):
    for text in TEXTS[group]:
        ids = oracle(text)["input_ids"] + [oracle.eos_token_id, 5, oracle.bos_token_id]
        rows = [ids, ids[1:], ids[::-1]]
        for skip in (False, True):
            for row in rows:
                assert port.decode(row, skip_special_tokens=skip) == oracle.decode(
                    row, skip_special_tokens=skip), (text, row, skip)
        assert port.batch_decode(rows) == oracle.batch_decode(rows)
        assert port.decode(ids) == oracle.decode(ids)  # skip_special_tokens False by default


def test_interface_as_hf(oracle, port):
    assert (port.bos_token_id, port.eos_token_id, port.pad_token_id, port.vocab_size) == (
        oracle.bos_token_id, oracle.eos_token_id, oracle.pad_token_id, oracle.vocab_size)
    texts = [NORMAL_DESCRIBE, "###"]
    assert port(texts)["input_ids"] == oracle(texts)["input_ids"]
    assert port(texts, max_length=4)["input_ids"] == oracle(texts, max_length=4)["input_ids"]
    assert port(NORMAL_DESCRIBE, add_special_tokens=False, max_length=3)["input_ids"] == \
        oracle(NORMAL_DESCRIBE, add_special_tokens=False, max_length=3)["input_ids"]
    assert port.decode([oracle.vocab_size + 7, 3]) == oracle.decode([oracle.vocab_size + 7, 3])


def test_model_proto_read_as_protobuf_reads_it(model_file, port):
    proto = pb2.ModelProto()
    proto.ParseFromString(model_file.read_bytes())
    ours = parse_model_proto(model_file.read_bytes())
    assert ours["pieces"] == [(p.piece, p.score, p.type) for p in proto.pieces]
    assert (ours["model_type"], ours["byte_fallback"], ours["unk_id"], ours["bos_id"],
            ours["eos_id"], ours["add_dummy_prefix"]) == (2, True, 0, 1, 2, True)
    assert port.vocab_size == len(proto.pieces)


def test_chip_smoke_writes_a_model_protobuf_reads(tmp_path):
    """The 32000-piece ``tokenizer.model`` of ``chip_smoke.py``'s phase 13."""
    path = tmp_path / "tokenizer.model"
    pieces = chip_smoke.write_tokenizer_model(str(path), seed=3,
                                              n_pieces=chip_smoke.TOKENIZER_PIECES)
    proto = pb2.ModelProto()
    proto.ParseFromString(path.read_bytes())
    assert [(p.piece, p.score, p.type) for p in proto.pieces] == pieces
    assert len(pieces) == 32000 and len({p[0] for p in pieces}) == 32000
    spec = proto.trainer_spec
    assert (spec.model_type, spec.byte_fallback, spec.unk_id, spec.bos_id, spec.eos_id,
            spec.pad_id, proto.normalizer_spec.add_dummy_prefix) == (2, True, 0, 1, 2, -1, True)
    tok = LlamaTokenizer.from_file(str(path))
    ids = tok(_after, add_special_tokens=False)["input_ids"]
    assert tok(tok.decode(ids), add_special_tokens=False)["input_ids"] == ids


def test_load_llama_tokenizer_follows_the_jax_rule(model_file, tmp_path, caplog):
    """A directory or file that gives a ``tokenizer.model`` gives the
    tokenizer; a path without one warns and gives ``ByteTokenizer``; a
    ``tokenizer.model`` that does not parse, or is not BPE, raises."""
    assert isinstance(load_llama_tokenizer(str(model_file.parent)), LlamaTokenizer)
    assert isinstance(load_llama_tokenizer(str(model_file)), LlamaTokenizer)
    assert isinstance(load_llama_tokenizer(""), ByteTokenizer)
    with caplog.at_level(logging.WARNING):
        assert isinstance(load_llama_tokenizer(str(tmp_path)), ByteTokenizer)
    assert "ByteTokenizer" in caplog.text
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "tokenizer.model").write_bytes(model_file.read_bytes()[:-3])
    with pytest.raises(ModelProtoError):
        load_llama_tokenizer(str(broken))
    unigram = pb2.ModelProto()
    unigram.ParseFromString(model_file.read_bytes())
    unigram.trainer_spec.model_type = 1
    (broken / "tokenizer.model").write_bytes(unigram.SerializeToString())
    with pytest.raises(ModelProtoError, match="BPE"):
        load_llama_tokenizer(str(broken))


def test_from_config_llama_model_ids_match_jax(model_file, oracle):
    """``from_config(llama_model=dir)`` tokenizes as the JAX ``Myriad`` does
    with the oracle tokenizer: the prompt pieces, the targets with
    ``end_sym``, the speculative lookup ids, and a decoded row (the eval's
    ``batch_decode`` rule)."""
    pm = Myriad.from_config({"arch_preset": "tiny", "llama_model": str(model_file.parent),
                             "end_sym": "###", "max_txt_len": 12}, device="cpu")
    assert isinstance(pm.llama_tokenizer, LlamaTokenizer)
    jm = types.SimpleNamespace(llama_tokenizer=oracle, _prompt_cache={}, end_sym="###",
                               max_txt_len=12)
    question = "<Img><ImageHere></Img>" + QUESTION_PROMPTS[1]
    for ours, ref in zip(pm.split_prompt(question), JaxMyriad.split_prompt(jm, question)):
        assert ours.tolist() == ref.tolist()
    texts = [NORMAL_DESCRIBE, ABNORMAL_DESCRIBE_V1, ""]
    for ours, ref in zip(pm.tokenize_targets(texts), JaxMyriad.tokenize_targets(jm, texts)):
        np.testing.assert_array_equal(ours.numpy(), ref)
    after = pm.split_prompt(question)[1]
    np.testing.assert_array_equal(pm._spec_lookup_ids(after).numpy(),
                                  JaxMyriad._spec_lookup_ids(jm, after.numpy()))
    row = np.array([[3, 700, 9, 2, 0, 41000, 17]])
    assert pm.llama_tokenizer.batch_decode(np.clip(row, 1, 40000)) == oracle.batch_decode(
        np.clip(row, 1, 40000))
