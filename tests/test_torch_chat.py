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
speculation the port raises (top-p sampling is not ported), where it used to
return the greedy transcript; with speculation both sides decode greedily at
any temperature, and the transcripts are identical.
"""

import numpy as np
import pytest
import torch

from myriad_tpu import checkpoint as ckpt_lib

from myriad_tpu.conversation import CONV_VISION as JAX_CONV_VISION
from myriad_tpu.conversation import Chat as JaxChat
from myriad_tpu.processors.blip_processors import LocImageTrainProcessor
from myriad_tpu_torch.conversation import CONV_VISION, Chat
from myriad_tpu_torch.ops.preprocess import u8_normalize
from test_torch_myriad import pair  # noqa: F401  (the module's JAX/port model pair)
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


def test_demo_chats_over_stdin_on_the_cpu(tmp_path):
    """``python -m myriad_tpu_torch.demo`` answers each stdin line; the
    options reach ``Myriad.from_config``; built with no ``--device`` it would
    go to the card."""
    import os
    import subprocess
    import sys

    from myriad_tpu_torch.demo import parse_options

    assert parse_options(["arch_preset=tiny", "llm_spec_k=3", "llm_staged_decode=False"]) == {
        "arch_preset": "tiny", "llm_spec_k": 3, "llm_staged_decode": False}
    with pytest.raises(ValueError):
        parse_options(["llm_spec_k"])
    image = tmp_path / "image.npy"
    np.save(image, _image(3))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "myriad_tpu_torch.demo", "--image", str(image), "--device", "cpu",
         "--max-new-tokens", "4", "--options", "arch_preset=tiny", "llm_weight_dtype=int8",
         "llm_kv_dtype=int8", "llm_spec_k=2"],
        input="Any defect?\nWhere?\nquit\n", cwd=repo, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("myriad>") == 2 and "Received." in res.stdout


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
def test_chat_sampled_turn_without_speculation_raises(flat_pair, incremental):
    _, pm = flat_pair
    chat = Chat(pm, incremental=incremental, spec_k=0)
    with pytest.raises(NotImplementedError):
        _run(chat, CONV_VISION, QUESTIONS[:1], _image(1), new=12, temperature=1.0, **SAMPLED)


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
