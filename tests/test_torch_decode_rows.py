"""The port's row-grid decode attention (kernel B2', ``decode_attention_rows``
in myriad_tpu_torch/ops/decode_attention.py) and the ``MYRIAD_DECODE_ATTN``
dispatch of ``ops/attention.py`` against the JAX package's, on the CPU.

Tolerance: with bf16 q the plain version of B2' is held to the TPU kernel in
interpret mode within 2e-2 absolute (the kernel keeps the probabilities in
fp32, the plain version rounds them to bf16 before p.V), as for B2 in
tests/test_torch_attention.py; in fp32 the row dispatch equals JAX's within
1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu.models.llama import quantize_kv as jax_quantize_kv
from myriad_tpu.ops.attention import mha as jax_mha
from myriad_tpu.ops.decode_attention import decode_attention_rows as jax_rows
from myriad_tpu_torch.ops import attention, decode_attention as da
import torch_threads  # noqa: F401  (one torch thread a test process)

BF16_ATOL = 2e-2
FP32_ATOL = 1e-5


def _t(a, dtype=None):
    a = np.asarray(a)
    t = torch.from_numpy(np.array(a.astype(np.float32) if a.dtype.name == "bfloat16" else a))
    return t if dtype is None else t.to(dtype)


def _mask(b, kv_len, frontier):
    m = np.where(np.arange(kv_len) <= frontier, 0.0, -1e9).astype(np.float32)
    return np.broadcast_to(m[None, None, None], (b, 1, 1, kv_len)).copy()


def _cache(rng, b, h, t, d, quant):
    k = jnp.asarray(rng.normal(size=(b, h, t, d)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(b, h, t, d)), jnp.float32)
    if not quant:
        return k.astype(jnp.bfloat16), v.astype(jnp.bfloat16), None, None
    (k8, ks), (v8, vs) = jax_quantize_kv(k), jax_quantize_kv(v)
    return k8, v8, ks.astype(jnp.float16), vs.astype(jnp.float16)


@pytest.mark.parametrize("quant", [True, False])
def test_rows_plain_matches_pallas_kernel_bf16(rng, quant):
    """kv_len below the cache length: the TPU kernel gets the slice a staged
    decode step reads (its T must be 32-aligned); the port reads the prefix
    in place."""
    b, h, t, d, kv_len = 2, 3, 96, 128, 64
    q = jnp.asarray(rng.normal(size=(b, h, 1, d)), jnp.bfloat16)
    k, v, ks, vs = _cache(rng, b, h, t, d, quant)
    mask = _mask(b, kv_len, 50)
    sl = (slice(None), slice(None), slice(0, kv_len))
    ref = jax_rows(q, k[sl], v[sl], mask=jnp.asarray(mask), interpret=True,
                   k_scale=None if ks is None else ks[sl], v_scale=None if vs is None else vs[sl])
    cache_dtype = torch.int8 if quant else torch.bfloat16
    args = dict(mask=torch.from_numpy(mask), kv_len=kv_len,
                k_scale=None if ks is None else _t(ks, torch.float16),
                v_scale=None if vs is None else _t(vs, torch.float16))
    before = da.counter_rows.count
    out = da.decode_attention_rows(_t(q, torch.bfloat16), _t(k, cache_dtype), _t(v, cache_dtype),
                                   **args)
    assert da.counter_rows.count == before  # the CPU takes the plain version
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, 1, d)
    np.testing.assert_allclose(out.float().numpy(), _t(ref).numpy(), atol=BF16_ATOL, rtol=0)
    plain = da.decode_attention_rows_plain(_t(q, torch.bfloat16), _t(k, cache_dtype),
                                           _t(v, cache_dtype), **args)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_mha_row_mode_matches_jax(rng, monkeypatch):
    """MYRIAD_DECODE_ATTN=row on both sides: the JAX row kernel (interpret)
    and the port's row dispatch agree in fp32; a prefill chunk is untouched
    by the switch."""
    monkeypatch.setenv("MYRIAD_DECODE_ATTN", "row")
    b, h, t, d = 2, 2, 64, 128
    q = jnp.asarray(rng.normal(size=(b, h, 1, d)), jnp.float32)
    k8, v8, ks, vs = _cache(rng, b, h, t, d, True)
    ks, vs = ks.astype(jnp.float32), vs.astype(jnp.float32)
    mask = _mask(b, t, 40)
    ref = jax_mha(q, k8, v8, mask=jnp.asarray(mask), k_scale=ks, v_scale=vs)
    out = attention.mha(_t(q), _t(k8), _t(v8), mask=torch.from_numpy(mask), k_scale=_t(ks),
                        v_scale=_t(vs), kv_len=t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL, rtol=0)
    pos = torch.arange(4, dtype=torch.int32)[None].expand(b, 4)
    chunk = attention.mha(torch.randn(b, h, 4, d), _t(k8), _t(v8), k_scale=_t(ks),
                          v_scale=_t(vs), positions=pos)
    assert chunk.shape == (b, h, 4, d)


def test_mha_routes_by_decode_attn_mode(monkeypatch):
    """row -> decode_attention_rows, auto and bh -> decode_attention; xla
    and unknown values raise, as does row where B2' cannot take the width."""
    b, h, t, d = 1, 2, 16, 8
    q, k, v = torch.randn(b, h, 1, d), torch.randn(b, h, t, d), torch.randn(b, h, t, d)
    calls = []
    monkeypatch.setattr(da, "decode_attention", lambda *a, **kw: calls.append("bh"))
    monkeypatch.setattr(da, "decode_attention_rows", lambda *a, **kw: calls.append("row"))
    for mode, want in (("row", "row"), ("auto", "bh"), ("bh", "bh")):
        monkeypatch.setenv("MYRIAD_DECODE_ATTN", mode)
        attention.mha(q, k, v, kv_len=9)
        assert calls[-1] == want, mode
    monkeypatch.delenv("MYRIAD_DECODE_ATTN")
    attention.mha(q, k, v)
    assert calls[-1] == "bh"
    for mode in ("xla", "rows", ""):
        monkeypatch.setenv("MYRIAD_DECODE_ATTN", mode)
        with pytest.raises(ValueError, match="MYRIAD_DECODE_ATTN"):
            attention.mha(q, k, v)
    assert len(calls) == 4
    monkeypatch.undo()
    monkeypatch.setenv("MYRIAD_DECODE_ATTN", "row")
    wide = torch.randn(b, h, 1, 256)
    with pytest.raises(ValueError, match="B2'"):
        attention.mha(wide, torch.randn(b, h, t, 256), torch.randn(b, h, t, 256))


def test_rows_supported_takes_any_length():
    """B2' streams the cache through fixed-size tiles, so only the head dim
    gates it (at most 128, a multiple of 4), as for B2."""
    assert da.rows_supported(416, 128) and da.rows_supported(4096, 128)
    assert da.rows_supported(7137, 128) and da.rows_supported(65536, 128)
    assert da.rows_supported(1, 4) and da.rows_supported(8192, 40)
    assert not da.rows_supported(416, 130) and not da.rows_supported(416, 256)
    assert not da.rows_supported(416, 42)
