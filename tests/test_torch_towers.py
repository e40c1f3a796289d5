"""The port's vision towers (EVA-ViT, LoraAdaptorV2, ln_vision, Q-Former, the
VE map encoders, ImageBind vision/text, LinearLayerDecoder, zero-shot maps,
encode_img) against the JAX package's, on the CPU, at ``MyriadArch.tiny``
with the same random weights on both sides (fp32).

Tolerance: 1e-4 absolute and relative on activations (fp32 sums in another
order through a few layers); 1e-5 on the anomaly maps, the gate of
tests/test_myriad_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu import checkpoint as ckpt_lib
from myriad_tpu.models.eva_vit import EvaViT as JaxEvaViT
from myriad_tpu.models.layers import Policy as JaxPolicy
from myriad_tpu.models.myriad import Myriad as JaxMyriad
from myriad_tpu.models.myriad import MyriadArch as JaxArch
from myriad_tpu.models.myriad import MyriadModule as JaxMyriadModule
from myriad_tpu.models.networks import LoraAdaptorV2 as JaxLoraAdaptorV2
from myriad_tpu.models.networks import VEInstructorV2 as JaxVEInstructorV2
from myriad_tpu.models.networks import VETokenizer as JaxVETokenizer
from myriad_tpu.models.qformer import QFormer as JaxQFormer
from myriad_tpu.models.vision_expert import AnomalyExpertModule as JaxExpert
from myriad_tpu.models.vision_expert import upsample_align_corners as jax_upsample
from myriad_tpu.ops.preprocess import u8_normalize as jax_u8_normalize
from myriad_tpu_torch.convert_from_jax import state_dict_from_jax
from myriad_tpu_torch.models.layers import Policy
from myriad_tpu_torch.models.myriad import Myriad, MyriadArch
from myriad_tpu_torch.models.vision_expert import upsample_align_corners
from myriad_tpu_torch.ops.preprocess import u8_normalize

TOL = dict(atol=1e-4, rtol=1e-4)


def _perturb(tree, rng, std=0.05):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, std)
        else:
            a = np.asarray(v)
            out[k] = a + rng.normal(size=a.shape).astype(a.dtype) * std if a.dtype.kind == "f" else a
    return out


@pytest.fixture(scope="module")
def pair():
    """A tiny JAX Myriad with perturbed weights and the port loaded from it."""
    jm = JaxMyriad(arch=JaxArch.tiny(), use_ve=True, policy=JaxPolicy.fp32(), max_txt_len=16)
    rng = np.random.default_rng(0)
    params = _perturb(jax.tree_util.tree_map(np.asarray, jm.params), rng)
    jm.trainable, jm.frozen = ckpt_lib.split_by_predicate(params, jm._trainable_predicate())
    ve_params = _perturb(jax.tree_util.tree_map(np.asarray, jm.vision_expert.params["params"]),
                         rng)
    jm.vision_expert.params = {"params": ve_params}
    pm = Myriad(MyriadArch.tiny(), policy=Policy.fp32(), class_names=["bottle", "cable"])
    pm.load_state_dicts(state_dict_from_jax(params), state_dict_from_jax(ve_params))
    return jm, params, ve_params, pm


def _np(x):
    return np.asarray(x, np.float32)


def _images(n=2, size=28, seed=1):
    return np.random.default_rng(seed).integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


def _maps(n=2, seed=2):
    return np.random.default_rng(seed).uniform(size=(n, 224, 224, 1)).astype(np.float32)


def test_u8_normalize_matches(rng):
    x = _images()
    ref = jax_u8_normalize(jnp.asarray(x))
    out = u8_normalize(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), _np(ref))


def test_eva_vit_matches(pair):
    jm, params, _, pm = pair
    a = jm.arch
    x = np.array(jax_u8_normalize(jnp.asarray(_images())))
    ref = JaxEvaViT(img_size=a.img_size, patch_size=a.vit_patch, embed_dim=a.vit_dim,
                    depth=a.vit_depth, num_heads=a.vit_heads, mlp_ratio=a.vit_mlp_ratio,
                    dtype=jnp.float32, param_dtype=jnp.float32).apply(
        {"params": params["visual_encoder"]}, jnp.asarray(x))
    with torch.inference_mode():
        out = pm.module.visual_encoder(torch.from_numpy(x))
    assert out.shape == (2, 5, a.vit_dim)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_adaptor_and_ln_vision_match(pair):
    jm, params, _, pm = pair
    feats = np.random.default_rng(4).normal(size=(2, 5, jm.arch.vit_dim)).astype(np.float32)
    ref = JaxLoraAdaptorV2(dims=jm.arch.vit_dim, input_dim=jm.arch.adaptor_rank,
                           dtype=jnp.float32, param_dtype=jnp.float32).apply(
        {"params": params["expert_adaptor"]}, jnp.asarray(feats))
    with torch.inference_mode():
        out = pm.module.expert_adaptor(torch.from_numpy(feats))
        np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)
        ln_ref = jm.module.apply({"params": params}, ref,
                                 method=lambda m, x: m.ln_vision(x))
        np.testing.assert_allclose(pm.module.ln_vision(out).numpy(), _np(ln_ref), **TOL)


def test_qformer_matches(pair):
    jm, params, _, pm = pair
    a = jm.arch
    r = np.random.default_rng(5)
    q = r.normal(size=(2, 11, a.qformer_hidden)).astype(np.float32)
    feats = r.normal(size=(2, 5, a.vit_dim)).astype(np.float32)
    ref = JaxQFormer(hidden_size=a.qformer_hidden, num_layers=a.qformer_layers,
                     num_heads=a.qformer_heads, intermediate_size=a.qformer_intermediate,
                     dtype=jnp.float32, param_dtype=jnp.float32).apply(
        {"params": params["qformer"]}, jnp.asarray(q), jnp.asarray(feats))
    with torch.inference_mode():
        out = pm.module.qformer(torch.from_numpy(q), torch.from_numpy(feats))
    assert len(pm.module.qformer.layer) == a.qformer_layers
    assert pm.module.qformer.layer[1].crossattention is None  # every 2nd layer only
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_ve_instructor_matches(pair):
    jm, params, _, pm = pair
    maps = _maps()
    ref = JaxVEInstructorV2(out_dim=jm.arch.qformer_hidden, dtype=jnp.float32,
                            param_dtype=jnp.float32).apply(
        {"params": params["ve_instructor"]}, jnp.asarray(maps))
    with torch.inference_mode():
        out = pm.module.ve_instructor(torch.from_numpy(maps))
    assert out.shape == (2, 49, jm.arch.qformer_hidden)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_ve_tokenizer_matches(pair):
    jm, params, _, pm = pair
    maps = _maps(seed=3)
    ref = JaxVETokenizer(llm_dim=jm.arch.llama.hidden_size, dtype=jnp.float32,
                         param_dtype=jnp.float32).apply(
        {"params": params["ve_tokenizer"]}, jnp.asarray(maps))
    with torch.inference_mode():
        out = pm.module.ve_tokenizer(torch.from_numpy(maps))
    assert out.shape == (2, 18, jm.arch.llama.hidden_size)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def _expert(jm):
    return JaxExpert(jm.arch.imagebind, map_size=jm.arch.map_size, dtype=jnp.float32,
                     param_dtype=jnp.float32)


def test_imagebind_vision_taps_and_decoder_match(pair):
    jm, _, ve_params, pm = pair
    x = jnp.asarray(_images())
    emb_ref, taps_ref = _expert(jm).apply({"params": ve_params}, x,
                                          method=lambda m, i: m.visual(i))
    dec_ref = _expert(jm).apply({"params": ve_params}, x,
                                method=JaxExpert.decoded_patch_tokens)
    mod = pm.vision_expert.module
    with torch.inference_mode():
        emb, taps = mod.visual(torch.from_numpy(np.asarray(x)))
        dec = mod.image_decoder(taps)
    np.testing.assert_allclose(emb.numpy(), _np(emb_ref), **TOL)
    assert len(taps) == len(jm.arch.imagebind.out_layers)
    for t, tr in zip(taps, taps_ref):
        np.testing.assert_allclose(t.numpy(), _np(tr), **TOL)
    for t, tr in zip(dec, dec_ref):
        assert t.shape[1] == 4  # cls dropped: a 2x2 patch grid
        np.testing.assert_allclose(t.numpy(), _np(tr), **TOL)


def test_imagebind_text_matches(pair):
    jm, _, ve_params, pm = pair
    tok = pm.vision_expert.tokenizer
    ids = np.asarray([tok.encode(s, jm.arch.imagebind.context_length)
                      for s in ("a photo of a bottle.", "damaged cable", "flawless pill")])
    ref = _expert(jm).apply({"params": ve_params}, jnp.asarray(ids),
                            method=JaxExpert.encode_text)
    with torch.inference_mode():
        out = pm.vision_expert.module.encode_text(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_upsample_align_corners_matches(rng):
    x = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    ref = jax_upsample(jnp.asarray(x), (9, 7))
    out = upsample_align_corners(torch.from_numpy(x), (9, 7))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=1e-6, rtol=1e-6)
    # align_corners: the corners are copied exactly
    np.testing.assert_allclose(out[..., 0, 0].numpy(), x[..., 0, 0], atol=1e-6)
    np.testing.assert_allclose(out[..., -1, -1].numpy(), x[..., -1, -1], atol=1e-6)


def test_text_features_and_zero_shot_maps_match(pair):
    jm, _, ve_params, pm = pair
    jve = jm.vision_expert
    jve.class_names = ["bottle", "cable"]
    jve.class_index = {"bottle": 0, "cable": 1}
    jve.build_text_features()
    feats = pm.vision_expert.build_text_features()
    np.testing.assert_allclose(feats.numpy(), _np(jve._text_feats), **TOL)
    x = _images()
    maps_ref, masks_ref = jve(jnp.asarray(x), ["cable", "bottle"])
    maps, masks = pm.vision_expert(torch.from_numpy(x), ["cable", "bottle"])
    assert maps.shape == (2, 224, 224, 1) and masks.shape == (2, 2, 2, 1)
    np.testing.assert_allclose(maps.numpy(), _np(maps_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(masks.numpy(), _np(masks_ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_encode_img_matches(pair, stage):
    jm, params, _, pm = pair
    x, maps = _images(), _maps(seed=6)
    ref = jm.module.apply({"params": params}, jnp.asarray(x), jnp.asarray(maps), stage,
                          method=JaxMyriadModule.encode_img)
    with torch.inference_mode():
        out = pm.module.encode_img(torch.from_numpy(x), torch.from_numpy(maps), stage)
    n_tok = {0: 8 + 18, 1: 8 + 49 + 18, 2: 8 + 49}[stage]
    assert out.shape == (2, n_tok, jm.arch.llama.hidden_size)
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)
