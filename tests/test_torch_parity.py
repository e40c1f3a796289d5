"""Per-tower activation parity vs torch at tiny scale (VERDICT r1 next #2).

For each frozen tower the test builds a random torch state dict using the
REFERENCE checkpoint key names, runs an independent torch implementation of
the published architecture (written here, not copied), converts the state
dict with myriad_tpu.convert, and asserts the flax tower reproduces the
torch activations in fp32.  This pins the full conversion chain
(names + transposes + math) for every tower — LLaMA already has HF parity
in tests/test_llama.py.

Reference architectures mirrored:
* EVA-ViT block stack — minigpt4/models/eva_vit.py:76-126 (q/v bias only)
* Q-Former query path — minigpt4/models/Qformer.py:95-130 (post-LN BERT,
  cross-attention every 2 layers, query-branch FFN)
* ImageBind vision/text — minigpt4/models/model/ImageBind/models/
  (Conv3d video stem on a repeated frame, pre-norm trunk, EOS pooling)
* AnomalyGPT LinearLayer decoder — adrefexpert_v2.py:16-29
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from myriad_tpu.models.eva_vit import EvaViT
from myriad_tpu.models.imagebind import (
    ImageBindConfig,
    ImageBindText,
    ImageBindVision,
    LinearLayerDecoder,
)
from myriad_tpu.models.qformer import QFormer
import torch_threads  # noqa: F401  (one torch thread a test process)

torch.manual_seed(0)
FP32 = dict(dtype=jnp.float32, param_dtype=jnp.float32)


def _t(shape, scale=0.05):
    return torch.randn(*shape, dtype=torch.float32) * scale


def _mha(q, k, v, n_heads, mask=None):
    """(B, T, D) torch multi-head attention, fp32 softmax."""
    b, tq, d = q.shape
    dh = d // n_heads
    split = lambda x: x.view(b, -1, n_heads, dh).transpose(1, 2)
    q, k, v = split(q), split(k), split(v)
    logits = (q @ k.transpose(-1, -2)) * dh**-0.5
    if mask is not None:
        logits = logits + mask
    probs = logits.softmax(-1)
    return (probs @ v).transpose(1, 2).reshape(b, tq, d)


# ---------------------------------------------------------------------------
# EVA-ViT
# ---------------------------------------------------------------------------
def _eva_sd(dim=32, depth=2, heads=4, mlp_hidden=64, patch=14):
    sd = {
        "patch_embed.proj.weight": _t((dim, 3, patch, patch)),
        "patch_embed.proj.bias": _t((dim,)),
        "cls_token": _t((1, 1, dim)),
        "pos_embed": _t((1, 5, dim)),
    }
    for i in range(depth):
        p = f"blocks.{i}."
        sd.update({
            p + "norm1.weight": 1 + _t((dim,)), p + "norm1.bias": _t((dim,)),
            p + "norm2.weight": 1 + _t((dim,)), p + "norm2.bias": _t((dim,)),
            p + "attn.qkv.weight": _t((3 * dim, dim)),
            p + "attn.q_bias": _t((dim,)),
            p + "attn.v_bias": _t((dim,)),
            p + "attn.proj.weight": _t((dim, dim)),
            p + "attn.proj.bias": _t((dim,)),
            p + "mlp.fc1.weight": _t((mlp_hidden, dim)),
            p + "mlp.fc1.bias": _t((mlp_hidden,)),
            p + "mlp.fc2.weight": _t((dim, mlp_hidden)),
            p + "mlp.fc2.bias": _t((dim,)),
        })
    return sd


def _eva_torch_forward(sd, x, depth=2, heads=4, patch=14):
    """x: (B, 3, H, W) -> (B, 1+P, D); eva_vit.py:76-126,239-280."""
    x = F.conv2d(x, sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"],
                 stride=patch)
    b, d = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd["cls_token"].expand(b, -1, -1), x], dim=1)
    x = x + sd["pos_embed"]
    for i in range(depth):
        p = f"blocks.{i}."
        h = F.layer_norm(x, (d,), sd[p + "norm1.weight"], sd[p + "norm1.bias"], 1e-6)
        qkv_bias = torch.cat([sd[p + "attn.q_bias"],
                              torch.zeros_like(sd[p + "attn.v_bias"]),
                              sd[p + "attn.v_bias"]])
        qkv = F.linear(h, sd[p + "attn.qkv.weight"], qkv_bias)
        q, k, v = qkv.chunk(3, dim=-1)
        h = _mha(q, k, v, heads)
        x = x + F.linear(h, sd[p + "attn.proj.weight"], sd[p + "attn.proj.bias"])
        h = F.layer_norm(x, (d,), sd[p + "norm2.weight"], sd[p + "norm2.bias"], 1e-6)
        h = F.gelu(F.linear(h, sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"]))
        x = x + F.linear(h, sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"])
    return x


def test_eva_vit_activation_parity():
    from myriad_tpu.convert import convert_eva_vit_state_dict

    sd = _eva_sd()
    x = torch.randn(2, 3, 28, 28) * 0.5
    with torch.no_grad():
        ref = _eva_torch_forward(sd, x).numpy()

    params = convert_eva_vit_state_dict(sd, depth=2)["params"]
    model = EvaViT(img_size=28, patch_size=14, embed_dim=32, depth=2,
                   num_heads=4, mlp_ratio=2.0, **FP32)
    got = model.apply({"params": params},
                      jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))
    err = np.max(np.abs(np.asarray(got) - ref))
    assert err < 2e-5, err


# ---------------------------------------------------------------------------
# Q-Former (query-only path)
# ---------------------------------------------------------------------------
def _qf_sd(dim=16, depth=2, inter=32, enc_width=32, prefix="bert."):
    sd = {
        prefix + "embeddings.LayerNorm.weight": 1 + _t((dim,)),
        prefix + "embeddings.LayerNorm.bias": _t((dim,)),
    }

    def attn(p, kv_dim):
        sd.update({
            p + "self.query.weight": _t((dim, dim)), p + "self.query.bias": _t((dim,)),
            p + "self.key.weight": _t((dim, kv_dim)), p + "self.key.bias": _t((dim,)),
            p + "self.value.weight": _t((dim, kv_dim)), p + "self.value.bias": _t((dim,)),
            p + "output.dense.weight": _t((dim, dim)), p + "output.dense.bias": _t((dim,)),
            p + "output.LayerNorm.weight": 1 + _t((dim,)),
            p + "output.LayerNorm.bias": _t((dim,)),
        })

    for i in range(depth):
        pre = f"{prefix}encoder.layer.{i}."
        attn(pre + "attention.", dim)
        if i % 2 == 0:
            attn(pre + "crossattention.", enc_width)
        sd.update({
            pre + "intermediate_query.dense.weight": _t((inter, dim)),
            pre + "intermediate_query.dense.bias": _t((inter,)),
            pre + "output_query.dense.weight": _t((dim, inter)),
            pre + "output_query.dense.bias": _t((dim,)),
            pre + "output_query.LayerNorm.weight": 1 + _t((dim,)),
            pre + "output_query.LayerNorm.bias": _t((dim,)),
        })
    return sd


def _qf_torch_forward(sd, q, enc, depth=2, heads=2, prefix="bert."):
    """q: (B, Q, D) query embeds; enc: (B, T, Dv); Qformer.py:95-130."""
    d = q.shape[-1]

    def ln(x, p):
        return F.layer_norm(x, (d,), sd[p + "weight"], sd[p + "bias"], 1e-12)

    def attn_block(x, kv, p):
        qh = F.linear(x, sd[p + "self.query.weight"], sd[p + "self.query.bias"])
        kh = F.linear(kv, sd[p + "self.key.weight"], sd[p + "self.key.bias"])
        vh = F.linear(kv, sd[p + "self.value.weight"], sd[p + "self.value.bias"])
        h = _mha(qh, kh, vh, heads)
        h = F.linear(h, sd[p + "output.dense.weight"], sd[p + "output.dense.bias"])
        return ln(h + x, p + "output.LayerNorm.")

    x = ln(q, prefix + "embeddings.LayerNorm.")
    for i in range(depth):
        pre = f"{prefix}encoder.layer.{i}."
        x = attn_block(x, x, pre + "attention.")
        if i % 2 == 0:
            x = attn_block(x, enc, pre + "crossattention.")
        h = F.gelu(F.linear(x, sd[pre + "intermediate_query.dense.weight"],
                            sd[pre + "intermediate_query.dense.bias"]))
        h = F.linear(h, sd[pre + "output_query.dense.weight"],
                     sd[pre + "output_query.dense.bias"])
        x = ln(h + x, pre + "output_query.LayerNorm.")
    return x


def test_qformer_activation_parity():
    from myriad_tpu.convert import convert_qformer_state_dict

    sd = _qf_sd()
    q = torch.randn(2, 8, 16) * 0.5
    enc = torch.randn(2, 5, 32) * 0.5
    with torch.no_grad():
        ref = _qf_torch_forward(sd, q, enc).numpy()

    params = convert_qformer_state_dict(sd, num_layers=2)["params"]
    model = QFormer(hidden_size=16, num_layers=2, num_heads=2,
                    intermediate_size=32, **FP32)
    got = model.apply({"params": params}, jnp.asarray(q.numpy()),
                      jnp.asarray(enc.numpy()))
    err = np.max(np.abs(np.asarray(got) - ref))
    assert err < 2e-5, err


# ---------------------------------------------------------------------------
# ImageBind vision + text
# ---------------------------------------------------------------------------
CFG = ImageBindConfig.tiny()


def _ib_block_sd(p, dim, mlp=4.0):
    return {
        p + "norm_1.weight": 1 + _t((dim,)), p + "norm_1.bias": _t((dim,)),
        p + "norm_2.weight": 1 + _t((dim,)), p + "norm_2.bias": _t((dim,)),
        p + "attn.in_proj_weight": _t((3 * dim, dim)),
        p + "attn.in_proj_bias": _t((3 * dim,)),
        p + "attn.out_proj.weight": _t((dim, dim)),
        p + "attn.out_proj.bias": _t((dim,)),
        p + "mlp.fc1.weight": _t((int(dim * mlp), dim)),
        p + "mlp.fc1.bias": _t((int(dim * mlp),)),
        p + "mlp.fc2.weight": _t((dim, int(dim * mlp))),
        p + "mlp.fc2.bias": _t((dim,)),
    }


def _ib_sd(cfg=CFG):
    dv, dt = cfg.vision_embed_dim, cfg.text_embed_dim
    n_tok = (cfg.img_size // cfg.patch_size) ** 2 + 1
    sd = {
        "modality_preprocessors.vision.rgbt_stem.proj.1.weight":
            _t((dv, 3, 2, cfg.patch_size, cfg.patch_size)),
        "modality_preprocessors.vision.cls_token": _t((1, 1, dv)),
        "modality_preprocessors.vision.pos_embedding_helper.pos_embed":
            _t((1, n_tok, dv)),
        "modality_trunks.vision.pre_transformer_layer.0.weight": 1 + _t((dv,)),
        "modality_trunks.vision.pre_transformer_layer.0.bias": _t((dv,)),
        "modality_heads.vision.0.weight": 1 + _t((dv,)),
        "modality_heads.vision.0.bias": _t((dv,)),
        "modality_heads.vision.2.weight": _t((cfg.out_embed_dim, dv)),
        "modality_preprocessors.text.token_embedding.weight":
            _t((cfg.vocab_size, dt)),
        "modality_preprocessors.text.pos_embed": _t((1, cfg.context_length, dt)),
        "modality_heads.text.proj.0.weight": 1 + _t((dt,)),
        "modality_heads.text.proj.0.bias": _t((dt,)),
        "modality_heads.text.proj.1.weight": _t((cfg.out_embed_dim, dt)),
        "modality_postprocessors.text.1.log_logit_scale":
            torch.tensor(math.log(1 / 0.07)),
    }
    for i in range(cfg.vision_num_blocks):
        sd.update(_ib_block_sd(f"modality_trunks.vision.blocks.{i}.", dv))
    for i in range(cfg.text_num_blocks):
        sd.update(_ib_block_sd(f"modality_trunks.text.blocks.{i}.", dt))
    return sd


def _ib_trunk(sd, x, pre, n_blocks, heads, out_layers=(), mask=None):
    d = x.shape[-1]
    taps = []
    for i in range(n_blocks):
        p = f"{pre}blocks.{i}."
        h = F.layer_norm(x, (d,), sd[p + "norm_1.weight"], sd[p + "norm_1.bias"], 1e-6)
        qkv = F.linear(h, sd[p + "attn.in_proj_weight"], sd[p + "attn.in_proj_bias"])
        q, k, v = qkv.chunk(3, dim=-1)
        h = _mha(q, k, v, heads, mask)
        h = F.linear(h, sd[p + "attn.out_proj.weight"], sd[p + "attn.out_proj.bias"])
        x = x + h
        h = F.layer_norm(x, (d,), sd[p + "norm_2.weight"], sd[p + "norm_2.bias"], 1e-6)
        h = F.gelu(F.linear(h, sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"]))
        x = x + F.linear(h, sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"])
        if i in out_layers:
            taps.append(x)
    return x, taps


def _ib_vision_torch(sd, images, cfg=CFG):
    """images (B,3,H,W); Conv3d stem over the 2x-repeated frame."""
    video = images.unsqueeze(2).repeat(1, 1, 2, 1, 1)  # PadIm2Video(repeat)
    x = F.conv3d(video, sd["modality_preprocessors.vision.rgbt_stem.proj.1.weight"],
                 stride=(2, cfg.patch_size, cfg.patch_size))
    b, d = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat(
        [sd["modality_preprocessors.vision.cls_token"].expand(b, -1, -1), x], 1
    )
    x = x + sd["modality_preprocessors.vision.pos_embedding_helper.pos_embed"]
    x = F.layer_norm(x, (d,), sd["modality_trunks.vision.pre_transformer_layer.0.weight"],
                     sd["modality_trunks.vision.pre_transformer_layer.0.bias"], 1e-6)
    x, taps = _ib_trunk(sd, x, "modality_trunks.vision.", cfg.vision_num_blocks,
                        cfg.vision_num_heads, cfg.out_layers)
    h = F.layer_norm(x, (d,), sd["modality_heads.vision.0.weight"],
                     sd["modality_heads.vision.0.bias"], 1e-6)[:, 0]
    h = F.linear(h, sd["modality_heads.vision.2.weight"])
    return h / h.norm(dim=-1, keepdim=True), taps


def _ib_text_torch(sd, ids, cfg=CFG):
    x = F.embedding(ids, sd["modality_preprocessors.text.token_embedding.weight"])
    l = ids.shape[1]
    d = x.shape[-1]
    x = x + sd["modality_preprocessors.text.pos_embed"][:, :l]
    mask = torch.full((l, l), float("-1e9")).triu(1)
    x, _ = _ib_trunk(sd, x, "modality_trunks.text.", cfg.text_num_blocks,
                     cfg.text_num_heads, mask=mask)
    h = F.layer_norm(x, (d,), sd["modality_heads.text.proj.0.weight"],
                     sd["modality_heads.text.proj.0.bias"], 1e-6)
    h = h[torch.arange(ids.shape[0]), ids.argmax(dim=-1)]
    h = F.linear(h, sd["modality_heads.text.proj.1.weight"])
    h = h / h.norm(dim=-1, keepdim=True)
    return h * sd["modality_postprocessors.text.1.log_logit_scale"].exp()


@pytest.fixture(scope="module")
def ib_params():
    from myriad_tpu.convert import convert_imagebind_state_dict

    sd = _ib_sd()
    return sd, convert_imagebind_state_dict(sd, CFG)["params"]


def test_imagebind_vision_parity(ib_params):
    sd, params = ib_params
    images = torch.randn(2, 3, CFG.img_size, CFG.img_size) * 0.5
    with torch.no_grad():
        ref_emb, ref_taps = _ib_vision_torch(sd, images)
    model = ImageBindVision(CFG, **FP32)
    emb, taps = model.apply({"params": params["visual"]},
                            jnp.asarray(images.numpy().transpose(0, 2, 3, 1)))
    assert np.max(np.abs(np.asarray(emb) - ref_emb.numpy())) < 5e-5
    for got_t, ref_t in zip(taps, ref_taps):
        assert np.max(np.abs(np.asarray(got_t) - ref_t.numpy())) < 5e-5


def test_imagebind_text_parity(ib_params):
    sd, params = ib_params
    ids = torch.randint(1, CFG.vocab_size, (3, CFG.context_length))
    ids[:, 0] = 0
    with torch.no_grad():
        ref = _ib_text_torch(sd, ids).numpy()
    model = ImageBindText(CFG, **FP32)
    got = model.apply({"params": params["text"]}, jnp.asarray(ids.numpy()))
    assert np.max(np.abs(np.asarray(got) - ref)) < 5e-5


def test_anomaly_decoder_parity(ib_params):
    from myriad_tpu.convert import convert_anomaly_decoder_state_dict

    sd = {}
    taps = []
    for i in range(2):
        sd[f"image_decoder.fc.{i}.weight"] = _t((8, CFG.vision_embed_dim))
        sd[f"image_decoder.fc.{i}.bias"] = _t((8,))
        taps.append(torch.randn(2, 5, CFG.vision_embed_dim))
    with torch.no_grad():
        ref = [F.linear(t[:, 1:], sd[f"image_decoder.fc.{i}.weight"],
                        sd[f"image_decoder.fc.{i}.bias"]).numpy()
               for i, t in enumerate(taps)]
    params = convert_anomaly_decoder_state_dict(sd, num_taps=2)["params"]
    model = LinearLayerDecoder(num_taps=2, out_dim=8, **FP32)
    got = model.apply({"params": params}, [jnp.asarray(t.numpy()) for t in taps])
    for g, r in zip(got, ref):
        assert np.max(np.abs(np.asarray(g) - r)) < 1e-5
