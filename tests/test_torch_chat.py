"""The port's chat (``myriad_tpu_torch/conversation``) against the JAX
package's ``Chat``, on the CPU, at ``MyriadArch.tiny`` with int8 LLM weights,
an int8 KV cache, the vision expert, and the same random weights on both
sides (fp32 compute).

Gates: over three scripted turns, the transcripts (text and token ids) are
identical, and so is the incremental path's ``_delta_log`` (the prefill width
of each turn).  The port prefills each delta at its exact width where the JAX
package pads it to a multiple of 64; identical transcripts show the padding
changes nothing.  The port's full re-prefill (``incremental=False``) and its
speculative chat (``spec_k=3``) are held to the JAX incremental greedy
transcript, which the JAX package's own tests hold to its full re-prefill
and to its speculative chat (tests/test_conversation.py); that saves the JAX
side a compile per turn.  The upload's normalisation equals the JAX
processor's bit for bit.

A sampled turn (``do_sample=True, top_p=0.01``) on flat logits: without
speculation each token is drawn from its step's nucleus, which equals the
JAX package's on the same logits (tolerance 0), and the turn's seed fixes
the transcript; with speculation both sides decode greedily at any
temperature, and the transcripts are identical.
"""

import numpy as np
import pytest
import torch

from myriad_tpu import checkpoint as ckpt_lib

from myriad_tpu.conversation import CONV_VISION as JAX_CONV_VISION
from myriad_tpu.conversation import Chat as JaxChat
from myriad_tpu.processors.blip_processors import LocImageTrainProcessor
from myriad_tpu_torch import generation
from myriad_tpu_torch.conversation import CONV_VISION, Chat
from myriad_tpu_torch.generation import top_p_filter
from myriad_tpu_torch.ops.preprocess import u8_normalize
from test_torch_myriad import pair  # noqa: F401  (the module's JAX/port model pair)
from test_torch_sampling import jax_nucleus
import torch_threads  # noqa: F401  (one torch thread a test process)

QUESTIONS = ["Is there any defect?", "Where is it?", "How severe is it?"]
NEW = 6


def _image(seed):
    return np.random.default_rng(seed).integers(0, 255, (28, 28, 3), dtype=np.uint8)


def _run(chat, conv_vision, questions, image, swap_to=None, new=NEW, **answer_kw):
    """Upload, then one answer per question; ``swap_to`` replaces the image
    embedding (same prompt text) before the second turn; ``answer_kw`` goes
    to every ``answer``."""
    conv = conv_vision.copy()
    img_list = []
    chat.upload_img(image, conv, img_list)
    out = []
    for turn, q in enumerate(questions):
        if turn == 1 and swap_to is not None:
            stash = []
            chat.upload_img(swap_to, conv, stash)
            conv.messages.pop()  # upload_img's prompt line: keep the text equal
            img_list[0] = stash[0]
        chat.ask(q, conv)
        text, tokens = chat.answer(conv, img_list, max_new_tokens=new, **answer_kw)
        out.append((text, np.asarray(tokens)))
    return out, img_list


def _assert_same(out, ref):
    for turn, ((t, k), (tr, kr)) in enumerate(zip(out, ref)):
        assert t == tr, f"turn {turn} text diverged"
        np.testing.assert_array_equal(k, kr, err_msg=f"turn {turn}")


@pytest.fixture(scope="module")
def jax_chat(pair):  # noqa: F811
    """The JAX Chat's incremental greedy run, once per module."""
    jm, _ = pair
    jchat = JaxChat(jm, LocImageTrainProcessor(identity=True))
    return jchat, _run(jchat, JAX_CONV_VISION, QUESTIONS, _image(1))[0]


@pytest.mark.parametrize("incremental,spec_k", [(True, 0), (True, 3), (False, 0)])
def test_chat_matches_jax(pair, jax_chat, incremental, spec_k):  # noqa: F811
    _, pm = pair
    jchat, ref = jax_chat
    chat = Chat(pm, incremental=incremental, spec_k=spec_k)
    out, _ = _run(chat, CONV_VISION, QUESTIONS, _image(1))
    _assert_same(out, ref)
    if incremental:
        assert chat._delta_log == jchat._delta_log
        # every turn after the first prefilled only its delta
        assert all(d < chat._frontier for d in chat._delta_log[1:])
        assert chat._cache[0]["k"].dtype == torch.int8


def test_upload_normalises_as_the_jax_processor():
    image = _image(2)
    ref = LocImageTrainProcessor(identity=True)({"img": image})["img"]
    out = u8_normalize(torch.from_numpy(image), out_dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref, np.float32))


def test_chat_replaced_image_forces_reprefill(pair):  # noqa: F811
    """Replacing an image embedding between turns, with the prompt text
    unchanged, must not reuse the old image's cached K/V: turn 2 re-prefills
    the whole prompt, as in the JAX package."""
    jm, pm = pair
    images = (_image(8), _image(9))
    jchat = JaxChat(jm, LocImageTrainProcessor(identity=True))
    chat = Chat(pm)
    ref, _ = _run(jchat, JAX_CONV_VISION, QUESTIONS[:2], images[0], swap_to=images[1])
    out, _ = _run(chat, CONV_VISION, QUESTIONS[:2], images[0], swap_to=images[1])
    _assert_same(out, ref)
    assert chat._delta_log == jchat._delta_log
    assert chat._delta_log[1] == chat._frontier


DEMO_YAML = """model:
  arch: myriad
  arch_preset: tiny
  image_size: 28
  llm_kv_dtype: int8
  param_policy: fp32
"""


def _demo_files(tmp_path, run_device="cpu"):
    """A tiny demo YAML (``run.device`` when given) and a 30x40 PNG."""
    from myriad_tpu_torch.datasets.png import encode_png

    cfg = tmp_path / "demo.yaml"
    cfg.write_text(DEMO_YAML + (f"run:\n  device: {run_device}\n" if run_device else ""))
    png = tmp_path / "image.png"
    png.write_bytes(encode_png(np.random.default_rng(3).integers(0, 255, (30, 40, 3),
                                                                 dtype=np.uint8)))
    return str(cfg), str(png)


def test_demo_chats_over_stdin_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``python -m myriad_tpu_torch.demo`` with the reference demo's command
    line (``--cfg-path``, a PNG, dotted ``--options``) answers each stdin
    line on ``run.device: cpu``; without ``run.device`` it goes to the card,
    which raises here."""
    import io
    import sys

    from myriad_tpu_torch import demo

    cfg, png = _demo_files(tmp_path)
    monkeypatch.setattr(sys, "stdin", io.StringIO("Any defect?\nWhere?\nquit\n"))
    assert demo.main(["--cfg-path", cfg, "--image", png, "--max-new-tokens", "4", "--options",
                      "model.llm_weight_dtype=int8", "model.llm_spec_k=2"]) == 0
    out = capsys.readouterr().out
    assert out.count("myriad>") == 2 and "Received." in out
    cfg, png = _demo_files(tmp_path, run_device=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="run.device"):
            demo.main(["--cfg-path", cfg, "--image", png])


def test_demo_matches_the_reference_demo(pair, tmp_path, monkeypatch):  # noqa: F811
    """F11: ``demo.main`` over a tiny YAML with ``run.device: cpu``, a PNG of
    another size than the model's and ``model.llm_weight_dtype=int8``, one
    question on stdin, the weights the pair's: the first upload's embedding
    (within 1e-5 of each token's largest entry, or 1e-5 where that is below
    1: the VETokenizer's tokens reach ~1e3 on these weights) and the answer
    (tokens and text identical) equal the JAX
    ``Chat``'s fed by the reference demo's steps (PIL's RGB conversion and
    resize, ``LocImageTrainProcessor(identity=True)``); the model's resolved
    keys equal the JAX ``from_config``'s."""
    import io
    import sys

    from PIL import Image

    from myriad_tpu_torch import demo
    from myriad_tpu_torch.common.config import Config
    from myriad_tpu_torch.models.myriad import Myriad
    from test_torch_myriad import _resolved

    jm, pm = pair
    cfg, png = _demo_files(tmp_path)
    options = ["model.llm_weight_dtype=int8"]
    seen = {}

    def load_the_pair(model, seed):
        seen["model"] = model
        model.load_state_dicts(pm.module.state_dict(), pm.vision_expert.module.state_dict())

    upload, answer = Chat.upload_img, Chat.answer

    def recording_upload(chat, image, conv, img_list):
        res = upload(chat, image, conv, img_list)
        seen.setdefault("embedding", img_list[-1])
        return res

    def recording_answer(chat, conv, img_list, **kw):
        seen["answer"] = answer(chat, conv, img_list, **kw)
        return seen["answer"]

    monkeypatch.setattr(Myriad, "init_random", load_the_pair)
    monkeypatch.setattr(Chat, "upload_img", recording_upload)
    monkeypatch.setattr(Chat, "answer", recording_answer)
    monkeypatch.setattr(sys, "stdin", io.StringIO(QUESTIONS[0] + "\nquit\n"))
    assert demo.main(["--cfg-path", cfg, "--image", png, "--max-new-tokens", str(NEW),
                      "--options", *options]) == 0

    size = jm.arch.img_size
    image = Image.open(png).convert("RGB").resize((size, size))
    jchat = JaxChat(jm, LocImageTrainProcessor(identity=True))
    conv, img_list = JAX_CONV_VISION.copy(), []
    jchat.upload_img(np.asarray(image), conv, img_list)
    jchat.ask(QUESTIONS[0], conv)
    text, tokens = jchat.answer(conv, img_list, max_new_tokens=NEW)
    ref = np.asarray(img_list[0])
    scale = np.maximum(np.abs(ref).max(axis=-1, keepdims=True), 1.0)
    assert (np.abs(seen["embedding"].numpy() - ref) <= 1e-5 * scale).all()
    assert seen["answer"][0] == text
    np.testing.assert_array_equal(seen["answer"][1], np.asarray(tokens))
    model_cfg = Config(cfg_path=cfg, options=options).model_cfg
    jax_side, port_side = _resolved(dict(model_cfg))
    assert jax_side == port_side
    assert seen["model"].arch.llama.weight_dtype == "int8"


SAMPLED = dict(do_sample=True, top_p=0.01)


@pytest.fixture
def flat_pair(pair):  # noqa: F811
    """``pair`` with ``lm_head`` scaled by 0.02 on both sides, so the top
    token's probability falls below 0.01 and a top-p 0.01 sampler departs
    from greedy; the weights are restored afterwards."""
    jm, pm = pair
    saved = jm.trainable, jm.frozen
    params = jm.params
    head = np.asarray(params["llama"]["lm_head"])
    flat = head * np.asarray(0.02, head.dtype)
    params["llama"] = dict(params["llama"], lm_head=flat)
    jm.trainable, jm.frozen = ckpt_lib.split_by_predicate(params, jm._trainable_predicate())
    lm_head = pm.module.llama.lm_head
    assert tuple(lm_head.shape) == flat.shape
    kept = lm_head.detach().clone()
    with torch.no_grad():
        lm_head.copy_(torch.from_numpy(flat))
    yield jm, pm
    jm.trainable, jm.frozen = saved
    with torch.no_grad():
        lm_head.copy_(kept)


@pytest.mark.parametrize("incremental", [True, False])
def test_chat_sampled_turn_without_speculation_raises(flat_pair, incremental, monkeypatch):
    """A sampled turn without speculation (before top-p sampling was ported,
    it raised): every token lies in its step's nucleus, the nucleus is the
    JAX package's on the same logits and holds several tokens somewhere, and
    a second run gives the same turn (each turn seeds its generator with 0,
    as the JAX one takes ``PRNGKey(0)``), on the resident cache and off it."""
    _, pm = flat_pair
    steps = []
    real = generation._select_token

    def record(logits, cfg, generator=None):
        ids = real(logits, cfg, generator)
        steps.append((logits.clone(), cfg, ids.clone()))
        return ids

    monkeypatch.setattr(generation, "_select_token", record)
    kw = dict(new=12, temperature=1.0, **SAMPLED)
    out, _ = _run(Chat(pm, incremental=incremental, spec_k=0), CONV_VISION, QUESTIONS[:1],
                  _image(1), **kw)
    assert len(steps) >= 2
    widest = 0
    for logits, cfg, ids in steps:
        kept = jax_nucleus(logits, cfg.top_p, cfg.temperature)
        np.testing.assert_array_equal(torch.isfinite(top_p_filter(logits, cfg)).numpy(), kept)
        assert kept[np.arange(len(ids)), ids.numpy()].all()
        widest = max(widest, int(kept.sum(-1).max()))
    assert widest > 1
    again, _ = _run(Chat(pm, incremental=incremental, spec_k=0), CONV_VISION, QUESTIONS[:1],
                    _image(1), **kw)
    _assert_same(again, out)


@pytest.mark.parametrize("seed,temperature", [(1, 1.0), (1, 1.5), (2, 1.0), (2, 1.5)])
def test_chat_sampled_turn_with_speculation_matches_jax(flat_pair, seed, temperature):
    """``top_p <= 0.01`` makes a speculative turn greedy on both sides, at
    any temperature."""
    jm, pm = flat_pair
    kw = dict(new=12, temperature=temperature, **SAMPLED)
    jchat = JaxChat(jm, LocImageTrainProcessor(identity=True), spec_k=3)
    ref, _ = _run(jchat, JAX_CONV_VISION, QUESTIONS, _image(seed), **kw)
    chat = Chat(pm, spec_k=3)
    out, _ = _run(chat, CONV_VISION, QUESTIONS, _image(seed), **kw)
    _assert_same(out, ref)
    assert chat._delta_log == jchat._delta_log


def test_chat_upload_after_a_reference_bank(pair):  # noqa: F811
    """F10: an upload on a model whose expert holds a one-shot reference bank
    (as ``evaluate`` builds one for its classes, which the chat's 'object'
    class is not among) encodes the image with the zero-shot maps, as the
    JAX ``Chat`` does; the port used to index the bank past its classes
    (IndexError).  The embedding equals an upload's without a bank, and the
    bank is left as it was."""
    _, pm = pair
    ve = pm.vision_expert
    saved = (list(ve.class_names), dict(ve.class_index), ve._text_feats, ve._ref_bank)
    try:
        ref_list = []
        Chat(pm).upload_img(_image(4), CONV_VISION.copy(), ref_list)
        ve.class_names, ve.class_index = list(saved[0]), dict(saved[1])
        ve._text_feats = None
        refs = np.random.default_rng(5).normal(size=(2, 28, 28, 3)).astype(np.float32)
        ve.build_reference_bank({c: refs for c in ve.class_names})
        bank = ve._ref_bank
        img_list = []
        Chat(pm).upload_img(_image(4), CONV_VISION.copy(), img_list)
        assert ve._ref_bank is bank and "object" in ve.class_index
        torch.testing.assert_close(img_list[0], ref_list[0], rtol=0, atol=0)
    finally:
        ve.class_names, ve.class_index, ve._text_feats, ve._ref_bank = saved
