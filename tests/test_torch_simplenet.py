"""The port's SimpleNet expert (myriad_tpu_torch/models/simplenet.py) against
the JAX package's, on the CPU in fp32.

WideResNet-50-2 at its published widths on 32-pixel images, batch 2: the
trunk's layer2 and layer3 taps, the embedder's aggregated patch features and
``SimpleNetInterface``'s image scores and smoothed maps within 1e-4 of the
largest magnitude of the JAX value; ``load_simplenet_interface`` reads the
npz files that the JAX ``save_params`` wrote; the expert adapter takes uint8
as its CLIP-normalised float; the discriminator margin loss is equal (1e-6).  The JAX parameters are filled from their traced shapes
(``jax.eval_shape``), never compiled initialisers, and the JAX embedder runs
as one compiled program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu import checkpoint as jax_ckpt
from myriad_tpu.models import simplenet as jsn
from myriad_tpu_torch.convert_from_jax import state_dict_from_jax
from myriad_tpu_torch.models import simplenet as tsn
import torch_threads  # noqa: F401  (one torch thread a test process)

SIZE, BATCH = 32, 2


def _fill(shapes, rng):
    """Values for a SimpleNet parameter tree: He-normal kernels, BatchNorm
    statistics near an identity (a positive variance), small biases."""
    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if name == "var":
            return (1.0 + 0.2 * np.abs(rng.normal(size=s.shape))).astype(np.float32)
        return (0.1 * rng.normal(size=s.shape)).astype(np.float32)  # bias, mean
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(0)
    emb = jsn.SimpleNetEmbedder()
    img = jnp.zeros((1, SIZE, SIZE, 3))
    emb_params = _fill(jax.eval_shape(lambda r: emb.init(r, img), jax.random.PRNGKey(0)), rng)
    head = jsn.SimpleHead()
    feats = jnp.zeros((1, 1536))
    heads = {c: _fill(jax.eval_shape(lambda r: head.init(r, feats), jax.random.PRNGKey(1)), rng)
             for c in ("bottle", "cable")}
    x = rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    return emb, emb_params, head, heads, x


def _port_embedder(emb_params):
    emb = tsn.SimpleNetEmbedder(device="cpu")
    emb.load_state_dict(state_dict_from_jax(emb_params["params"]), strict=True)
    return emb


def test_wide_resnet_and_embedder_match_jax(nets):
    emb, emb_params, _, _, x = nets

    @jax.jit
    def ref_fn(p, x):
        taps = jsn.WideResNet50().apply({"params": p["params"]["backbone"]}, x)
        return taps, emb.apply(p, x)

    (l2, l3), (ref, ref_hw) = ref_fn(emb_params, x)
    ours = _port_embedder(emb_params)
    with torch.no_grad():
        t2, t3 = ours.backbone(torch.from_numpy(x))
        feats, hw = ours(torch.from_numpy(x))
    assert t2.shape == (BATCH, SIZE // 8, SIZE // 8, 512)
    assert t3.shape == (BATCH, SIZE // 16, SIZE // 16, 1024)
    _close(t2, l2)
    _close(t3, l3)
    assert hw == tuple(ref_hw)
    _close(feats, ref)


@pytest.mark.parametrize("n,out", [(4608, 1536), (9216, 1536), (3072, 1536), (10, 4)])
def test_pooling_and_patchify_match_jax(n, out):
    x = np.random.default_rng(n).normal(size=(2, 3, n)).astype(np.float32)
    got = tsn.adaptive_avg_pool_1d(torch.from_numpy(x), out)
    _close(got, jsn.adaptive_avg_pool_1d(jnp.asarray(x), out), 1e-5)
    # the segments' means themselves (the JAX package's differences of a
    # cumulative sum round them by up to ~4e-6 at these lengths)
    starts, ends = (np.arange(out) * n) // out, -(-((np.arange(out) + 1) * n) // out)
    exact = np.stack([x.astype(np.float64)[..., a:b].mean(-1) for a, b in zip(starts, ends)], -1)
    _close(got, exact, 1e-6)
    f = np.random.default_rng(1).normal(size=(2, 5, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsn.patchify_3x3(torch.from_numpy(f)).numpy(),
                                  np.asarray(jsn.patchify_3x3(jnp.asarray(f))))


@pytest.mark.parametrize("shape,size", [((2, 6, 4, 4), (8, 8)), ((1, 3, 7, 5), (224, 224)),
                                        ((2, 1, 28, 28), (224, 224)), ((1, 2, 9, 9), (18, 18))])
def test_bilinear_resize_matches_jax_image_resize(shape, size):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), shape[:2] + size, "bilinear")
    _close(tsn.resize_bilinear(torch.from_numpy(x), size), ref, 1e-5)


def test_interface_from_jax_npz_matches_jax(nets, tmp_path):
    """``load_simplenet_interface`` over npz files written by the JAX
    ``save_params`` (two class heads and the backbone): scores and maps
    equal the JAX interface's on the same files."""
    emb, emb_params, head, heads, x = nets
    root = tmp_path / "heads"
    for cls, p in heads.items():
        jax_ckpt.save_params(str(root / f"{cls}.npz"), p["params"])
    (root / "notes.txt").write_text("not a head")
    backbone = str(tmp_path / "backbone.npz")
    jax_ckpt.save_params(backbone, emb_params["params"]["backbone"])
    ref = jsn.SimpleNetInterface(emb, emb_params, head, heads)
    ours = tsn.load_simplenet_interface(str(root), backbone_path=backbone, device="cpu")
    assert sorted(ours.heads) == ["bottle", "cable"]
    classes = ["cable", "bottle"]
    ref_scores, ref_maps = ref(jnp.asarray(x), classes)
    scores, maps = ours(torch.from_numpy(x), classes)
    assert maps.shape == (BATCH, 224, 224, 1)
    _close(scores, ref_scores)
    _close(maps, ref_maps)
    with pytest.raises(FileNotFoundError, match="no per-class head"):
        tsn.load_simplenet_interface(str(tmp_path / "empty"), device="cpu")


def test_adapter_takes_uint8_as_its_clip_normalised_float(nets):
    """The port's expert adapter normalises uint8 images with the CLIP
    statistics before it renormalises them to ImageNet's; its maps and masks
    equal the JAX adapter's on the CLIP-normalised float of the same images.
    (The JAX adapter renormalises uint8 as if it were that float: a
    deviation kept on purpose, ROADMAP C.)"""
    from myriad_tpu.models import vision_experts as jve
    from myriad_tpu.ops.preprocess import u8_normalize
    from myriad_tpu_torch.models import vision_experts as tve

    emb, emb_params, head, heads, _ = nets
    u8 = np.random.default_rng(5).integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8)
    classes = ["bottle", "cable"]
    ref = jve.SimpleNetExpertAdapter(jsn.SimpleNetInterface(emb, emb_params, head, heads))
    ref_maps, ref_masks = ref(u8_normalize(jnp.asarray(u8)), classes)
    port_heads = {}
    for cls, p in heads.items():
        port_heads[cls] = tsn.SimpleHead(device="cpu")
        port_heads[cls].load_state_dict(state_dict_from_jax(p["params"]), strict=True)
    ours = tve.SimpleNetExpertAdapter(tsn.SimpleNetInterface(_port_embedder(emb_params),
                                                             port_heads))
    maps, masks = ours(torch.from_numpy(u8), classes)
    assert maps.shape == (BATCH, 224, 224, 1) and masks.shape == (BATCH, 16, 16, 1)
    _close(maps, ref_maps)
    _close(masks, ref_masks)


def test_margin_loss_matches_jax(nets):
    _, _, head, heads, _ = nets
    p = heads["bottle"]
    feats = np.random.default_rng(3).normal(size=(6, 1536)).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    ref = jsn.discriminator_margin_loss(head, p, jnp.asarray(feats), 0.015, 0.5, rng)
    noise = np.array(jax.random.normal(rng, feats.shape, jnp.float32))
    ours = tsn.SimpleHead(device="cpu")
    ours.load_state_dict(state_dict_from_jax(p["params"]), strict=True)
    with torch.no_grad():
        got = tsn.discriminator_margin_loss(ours, torch.from_numpy(feats), 0.015, 0.5,
                                            noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        drawn = tsn.discriminator_margin_loss(ours, torch.from_numpy(feats), 0.015, 0.5,
                                              torch.Generator().manual_seed(0))
    assert np.isfinite(float(drawn))
