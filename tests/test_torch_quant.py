"""The port's int8 numerics (myriad_tpu_torch/ops/quant.py, the KV quant of
models/llama.py) against the JAX package's, on the CPU.

Tolerances: the quantizers are bit-exact (int8 payloads and fp32/fp16 scales
equal); W8A8 sums int8 products exactly on both sides, so only the fp32
rescale may differ (rtol 1e-6); the bf16 weight-only product is held to one
bf16 rounding of the largest output (2^-7 * max|ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu.models.llama import quantize_kv as jax_quantize_kv
from myriad_tpu.ops import quant as jq
from myriad_tpu_torch.models.llama import quantize_kv
from myriad_tpu_torch.ops import quant
import torch_threads  # noqa: F401  (one torch thread a test process)


def _bf16_np(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("shape", [(64, 48), (96, 256)])
def test_quantize_per_channel_bit_exact(rng, shape):
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    w[:, 3] = 0.0  # an all-zero column takes the 1e-8 scale floor
    w8_j, s_j = jq.quantize_per_channel(jnp.asarray(w))
    w8_t, s_t = quant.quantize_per_channel(torch.from_numpy(w))
    np.testing.assert_array_equal(w8_t.numpy(), np.asarray(w8_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert w8_t.dtype == torch.int8 and s_t.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact_with_fp16_scales(rng, dtype):
    x = rng.normal(size=(2, 3, 7, 16)).astype(np.float32) * 3.0
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    x8_j, s_j = jax_quantize_kv(xj)
    x8_t, s_t = quantize_kv(xt)
    np.testing.assert_array_equal(x8_t.numpy(), np.asarray(x8_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    # the cache stores the scales fp16 (init_cache), cast up at use
    np.testing.assert_array_equal(s_t.to(torch.float16).numpy(),
                                  np.asarray(s_j.astype(jnp.float16)))


@pytest.mark.parametrize("m", [1, 5, 300])
def test_w8a8_matches_jax(rng, m):
    w8, scale = jq.quantize_per_channel(jnp.asarray(rng.normal(size=(64, 40)), jnp.float32))
    x = rng.normal(size=(m, 64)).astype(np.float32)
    ref = np.asarray(jq._w8a8_matmul(jnp.asarray(x), w8, scale))
    out = quant.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(np.array(w8)),
                            torch.from_numpy(np.array(scale)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,k,n,full_range", [(1, 128, 256, False), (8, 128, 256, False),
                                               (20, 128, 256, False), (32, 128, 256, False),
                                               (5, 200, 36, False), (16, 128, 256, True)])
def test_weight_only_plain_matches_pallas_kernel(rng, m, k, n, full_range):
    """The plain version of kernel B1 against the TPU kernel in interpret
    mode, both in bf16: a verify round's 32 rows, a ragged (K, N) that the
    JAX wrapper pads, and a weight holding every int8 value, -128 included
    (which the per-channel quantizer never makes), with scales over several
    binades."""
    if full_range:
        w8 = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
        w8.reshape(-1)[:256] = np.arange(-128, 128)
        w8, scale = jnp.asarray(w8), jnp.asarray(np.exp(rng.normal(size=n) * 3) * 1e-3,
                                                 jnp.float32)
    else:
        w8, scale = jq.quantize_per_channel(jnp.asarray(rng.normal(size=(k, n)) * 0.02,
                                                        jnp.float32))
    x = _bf16_np(rng.normal(size=(m, k)))
    ref = jq.int8_matmul(jnp.asarray(x, jnp.bfloat16), w8, scale, interpret=True,
                         use_pallas=True)
    ref = np.asarray(ref.astype(jnp.float32))
    out = quant.int8_weight_only_matmul(torch.from_numpy(x).to(torch.bfloat16),
                                        torch.from_numpy(np.asarray(w8)),
                                        torch.from_numpy(np.asarray(scale)))
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -7 * np.abs(ref).max())


@pytest.mark.parametrize("lead", [(3,), (2, 150)])
def test_int8_matmul_cpu_row_rule_is_w8a8(rng, lead):
    """On the CPU every row count takes W8A8, as in the JAX package off-TPU."""
    w8, scale = jq.quantize_per_channel(jnp.asarray(rng.normal(size=(32, 24)), jnp.float32))
    x = rng.normal(size=lead + (32,)).astype(np.float32)
    ref = np.asarray(jq.int8_matmul(jnp.asarray(x), w8, scale))
    w8_t, s_t = torch.from_numpy(np.asarray(w8)), torch.from_numpy(np.asarray(scale))
    out = quant.int8_matmul(torch.from_numpy(x), w8_t, s_t)
    assert out.shape == lead + (24,)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    w8a8 = quant.w8a8_matmul(torch.from_numpy(x).reshape(-1, 32), w8_t, s_t)
    np.testing.assert_array_equal(out.reshape(-1, 24).numpy(), w8a8.numpy())


def test_int8_matmul_cpu_never_counts_a_launch(rng):
    before = quant.counter.count
    quant.int8_matmul(torch.randn(4, 16), torch.zeros(16, 8, dtype=torch.int8),
                      torch.ones(8))
    quant.int8_weight_only_matmul(torch.randn(4, 16), torch.zeros(16, 8, dtype=torch.int8),
                                  torch.ones(8))
    assert quant.counter.count == before
