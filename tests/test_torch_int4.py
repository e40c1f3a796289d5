"""The port's int4 weight-only serving (myriad_tpu_torch/ops/quant.py int4
section, ``Quant4Dense``, a tiny int4 LLaMA) against the JAX package's, on
the CPU.

Tolerances: the quantizers are bit-exact; the plain version of kernel B5
against the TPU kernel in interpret mode within 1e-5 of the output's largest
magnitude (both dequantize to the same bf16 weight and sum in fp32, in
another order); the CPU route (requantize to int8, then W8A8) against the
jitted JAX route within 1e-5 of the largest output (int32 sums, the fp32
rescale in another order); greedy token ids identical.  The int4 weights
are made by quantizing float weights (``quantize_tree(mode="int4")``): a
freshly initialised JAX int4 model has all-zero projections.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu import generation as jgen
from myriad_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from myriad_tpu.models.llama import LlamaForCausalLM as JaxLlama
from myriad_tpu.ops import quant as jq
from myriad_tpu_torch import generation as gen
from myriad_tpu_torch.convert_from_jax import state_dict_from_jax
from myriad_tpu_torch.models.layers import Policy, Quant4Dense, init_random_
from myriad_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from myriad_tpu_torch.ops import quant
from test_torch_llama import _float_params
import torch_threads  # noqa: F401  (one torch thread a test process)

STOPS = dict(eos_token_id=2, stop_single=5, stop_pair=(7, 9), pad_token_id=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_values(rng, shape):
    """fp32 values that bf16 holds exactly: the TPU kernel in interpret mode
    takes fp32 x (the CPU has no bf16 x bf16 -> fp32 dot), so feeding it
    bf16-exact values makes its product the bf16 product."""
    return np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("shape", [(256, 72), (64, 40)])
def test_int4_quantizers_bit_exact(rng, shape):
    """group 128 at d = 256; the whole dim (g = d = 64) where 128 does not divide."""
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    w[:, 3] = 0.0  # an all-zero column takes the 1e-8 scale floor
    w4_j, s_j = jq.quantize_int4_grouped(jnp.asarray(w))
    w4_t, s_t = quant.quantize_int4_grouped(torch.from_numpy(w))
    assert w4_t.dtype == torch.uint8 and s_t.dtype == torch.float32
    assert tuple(s_t.shape) == (shape[0] // quant.int4_group(shape[0]), shape[1])
    np.testing.assert_array_equal(w4_t.numpy(), np.asarray(w4_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(quant.unpack_int4(w4_t).numpy(), np.asarray(jq.unpack_int4(w4_j)))
    np.testing.assert_array_equal(quant.dequant_int4(w4_t, s_t).numpy(),
                                  np.asarray(jq.dequant_int4(w4_j, s_j)))


@pytest.mark.parametrize("m,d,f", [(8, 256, 128), (8, 6400, 128), (5, 64, 72)])
def test_int4_plain_matches_pallas_kernel(rng, m, d, f):
    """The plain version of B5 against the TPU kernel in interpret mode:
    d = 6400 splits the contraction in two (nk = 2, padded to 6656), and
    d = 64 is one group of the whole dim."""
    w4, s4 = jq.quantize_int4_grouped(jnp.asarray(rng.normal(size=(d, f)) * 0.02, jnp.float32))
    x = _bf16_values(rng, (m, d))
    ref = np.asarray(jq.int4_matmul(jnp.asarray(x), w4, s4, interpret=True, use_pallas=True))
    out = quant.int4_weight_only_matmul(torch.from_numpy(x), _t(w4), _t(s4))
    assert out.dtype == torch.float32 and out.shape == (m, f)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # a bf16 x gives the same values rounded once to bf16
    out16 = quant.int4_weight_only_matmul(torch.from_numpy(x).bfloat16(), _t(w4), _t(s4))
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -7 * np.abs(ref).max())


@pytest.mark.parametrize("lead,d", [((3,), 256), ((2, 150), 256), ((4,), 64)])
def test_int4_matmul_cpu_route_matches_jax(rng, lead, d):
    """On the CPU every row count requantizes to per-column int8 and takes
    W8A8, as JAX's default route off the TPU, compiled as the model is."""
    w4, s4 = jq.quantize_int4_grouped(jnp.asarray(rng.normal(size=(d, 40)) * 0.05,
                                                  jnp.float32))
    x = rng.normal(size=lead + (d,)).astype(np.float32)
    ref = np.asarray(jax.jit(jq.int4_matmul)(jnp.asarray(x), w4, s4))
    before = quant.counter4.count
    out = quant.int4_matmul(torch.from_numpy(x), _t(w4), _t(s4))
    assert quant.counter4.count == before  # no kernel on the CPU
    assert out.shape == lead + (40,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    w8, s_col = quant.requantize_int4_to_int8(_t(w4), _t(s4))
    np.testing.assert_array_equal(
        out.reshape(-1, 40).numpy(), quant.w8a8_matmul(torch.from_numpy(x).reshape(-1, d),
                                                       w8, s_col).numpy())


@pytest.fixture(scope="module")
def int4_models():
    """Tiny JAX LLaMA with int4 projections quantized from perturbed float
    weights, and the port loaded from the same tree with strict=True."""
    jcfg = JaxLlamaConfig.tiny(kv_cache_dtype="int8")
    params = jq.quantize_tree(_float_params(2), mode="int4")
    jmodel = JaxLlama(dataclasses.replace(jcfg, weight_dtype="int4"), jnp.float32, jnp.float32)
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(weight_dtype="int4", kv_cache_dtype="int8"),
                              policy=Policy.fp32(), device="cpu")
    sd = state_dict_from_jax(params)
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, {"params": params}, tmodel, sd


def test_bridge_passes_int4_leaves_through(int4_models):
    _, params, tmodel, sd = int4_models
    layer = params["params"]["model"]["layers_0"]
    for key, leaf in (("self_attn.k_proj", layer["self_attn"]["k_proj"]),
                      ("self_attn.q_proj.base", layer["self_attn"]["q_proj"]["base"]),
                      ("mlp.down_proj", layer["mlp"]["down_proj"])):
        for name in ("w_int4", "scale4"):
            np.testing.assert_array_equal(sd[f"model.layers.0.{key}.{name}"].numpy(),
                                          np.asarray(leaf[name]))
    mods = dict(tmodel.named_modules())
    assert isinstance(mods["model.layers.1.mlp.up_proj"], Quant4Dense)
    assert isinstance(mods["model.layers.1.self_attn.v_proj.base"], Quant4Dense)
    assert tmodel.lm_head.dtype == torch.float32  # the head stays float
    assert tuple(mods["model.layers.0.mlp.down_proj"].scale4.shape) == (1, 64)  # g = d = 128


def test_int4_greedy_token_ids_identical(int4_models):
    jmodel, params, tmodel, _ = int4_models
    x = np.random.default_rng(3).normal(size=(2, 11, 64)).astype(np.float32)
    kw = dict(max_new_tokens=10, prefill_chunks=2, staged_decode=True, cache_granularity=8,
              **STOPS)
    # compiled as the JAX Myriad serves it (one jit): its compiler folds the
    # requantization's (max * 8) / 127 into one multiply, which the port
    # follows; an eager prefill would divide instead
    ref = jax.jit(lambda p, e: jgen.greedy_generate(
        jmodel, p, e, config=jgen.GenerationConfig(**kw), cache_dtype="int8"))(
            params, jnp.asarray(x))
    out = gen.greedy_generate(tmodel, torch.from_numpy(x), config=gen.GenerationConfig(**kw),
                              cache_dtype="int8")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_random_init_fills_int4_as_the_quantizer_does():
    """``init_random_`` draws N(0, std) (in, out) and stores its group-wise
    quantization: seeded, every nibble value reachable, scales positive."""
    layer = Quant4Dense(256, 24, policy=Policy.fp32(), device="cpu")
    other = Quant4Dense(256, 24, policy=Policy.fp32(), device="cpu")
    init_random_(layer, torch.Generator().manual_seed(5))
    init_random_(other, torch.Generator().manual_seed(5))
    assert torch.equal(layer.w_int4, other.w_int4) and torch.equal(layer.scale4, other.scale4)
    q = quant.unpack_int4(layer.w_int4)
    assert int(q.min()) >= -8 and int(q.max()) == 7 and tuple(layer.scale4.shape) == (2, 24)
    assert bool((layer.scale4 > 0).all())
    w = torch.empty(256, 24).normal_(0.0, 0.02, generator=torch.Generator().manual_seed(5))
    w4, s4 = quant.quantize_int4_grouped(w)
    assert torch.equal(layer.w_int4, w4) and torch.equal(layer.scale4, s4)
