"""The port's attention (myriad_tpu_torch/ops/{attention,decode_attention,
prefill_attention}.py) against the JAX package's, on the CPU.

Which comparison holds at which dtype: in fp32 the plain versions equal JAX's
XLA path ``_xla_mha`` (what JAX runs on the CPU) to fp32 rounding (atol
1e-5); in bf16 they are held to the Pallas kernels run in interpret mode
within 2e-2 absolute, since the kernels keep the probabilities in fp32 (B2)
or round them before normalising (B3) where the plain versions round the
normalised probabilities to bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu.models.llama import quantize_kv as jax_quantize_kv
from myriad_tpu.ops.attention import _xla_mha
from myriad_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from myriad_tpu.ops.prefill_attention import prefill_attention as jax_prefill_attention
from myriad_tpu_torch.ops import attention, decode_attention as da, prefill_attention as pa
import torch_threads  # noqa: F401  (one torch thread a test process)

BF16_ATOL = 2e-2
FP32_ATOL = 1e-5


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(a).astype(np.float32)
                                  if np.asarray(a).dtype.name == "bfloat16" else np.asarray(a)))
    return t if dtype is None else t.to(dtype)


def _cache(rng, b, h, t, d, quant, dtype=jnp.float32):
    k = jnp.asarray(rng.normal(size=(b, h, t, d)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(b, h, t, d)), jnp.float32)
    if not quant:
        return k.astype(dtype), v.astype(dtype), None, None
    k8, ks = jax_quantize_kv(k)
    v8, vs = jax_quantize_kv(v)
    # the serving cache stores the scales fp16
    return k8, v8, ks.astype(jnp.float16), vs.astype(jnp.float16)


def _torch_cache(k, v, ks, vs, dtype):
    kt = _t(k, torch.int8 if ks is not None else dtype)
    vt = _t(v, torch.int8 if ks is not None else dtype)
    if ks is None:
        return kt, vt, None, None
    return kt, vt, _t(ks, torch.float16), _t(vs, torch.float16)


def _decode_mask(b, kv_len, frontier):
    m = np.where(np.arange(kv_len) <= frontier, 0.0, -1e9).astype(np.float32)
    return np.broadcast_to(m[None, None, None], (b, 1, 1, kv_len)).copy()


@pytest.mark.parametrize("quant", [True, False])
def test_decode_plain_matches_xla_fp32(rng, quant):
    b, h, t, d, kv_len = 2, 3, 48, 16, 40
    q = jnp.asarray(rng.normal(size=(b, h, 1, d)), jnp.float32)
    k, v, ks, vs = _cache(rng, b, h, t, d, quant)
    mask = _decode_mask(b, kv_len, 30)
    sl = (slice(None), slice(None), slice(0, kv_len))
    ref = _xla_mha(q, k[sl].astype(jnp.float32) if not quant else k[sl],
                   v[sl].astype(jnp.float32) if not quant else v[sl], jnp.asarray(mask),
                   d ** -0.5, None if ks is None else ks[sl], None if vs is None else vs[sl])
    kt, vt, kst, vst = _torch_cache(k, v, ks, vs, torch.float32)
    out = da.decode_attention(_t(q), kt, vt, mask=torch.from_numpy(mask), k_scale=kst,
                              v_scale=vst, kv_len=kv_len)
    assert out.shape == (b, h, 1, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("quant", [True, False])
def test_decode_plain_matches_pallas_kernel_bf16(rng, quant):
    """kv_len below the cache length: the TPU kernel is fed the slice a
    staged decode step reads; the port reads the prefix in place."""
    b, h, t, d, kv_len = 2, 4, 160, 32, 128
    q = jnp.asarray(rng.normal(size=(b, h, 1, d)), jnp.bfloat16)
    k, v, ks, vs = _cache(rng, b, h, t, d, quant, jnp.bfloat16)
    mask = _decode_mask(b, kv_len, 100)
    sl = (slice(None), slice(None), slice(0, kv_len))
    ref = jax_decode_attention(q, k[sl], v[sl], mask=jnp.asarray(mask), interpret=True,
                               k_scale=None if ks is None else ks[sl],
                               v_scale=None if vs is None else vs[sl])
    kt, vt, kst, vst = _torch_cache(k, v, ks, vs, torch.bfloat16)
    out = da.decode_attention(_t(q, torch.bfloat16), kt, vt, mask=torch.from_numpy(mask),
                              k_scale=kst, v_scale=vst, kv_len=kv_len)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _t(ref).numpy(), atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("tq,offset", [(12, 0), (5, 20), (16, 7)])
@pytest.mark.parametrize("quant", [True, False])
def test_prefill_plain_matches_xla_fp32(rng, tq, offset, quant):
    b, h, tk, d = 2, 3, 48, 16
    q = jnp.asarray(rng.normal(size=(b, h, tq, d)), jnp.float32)
    k, v, ks, vs = _cache(rng, b, h, tk, d, quant)
    positions = offset + np.broadcast_to(np.arange(tq, dtype=np.int32)[None], (b, tq))
    allowed = np.arange(tk)[None, None, None, :] <= positions[:, None, :, None]
    mask = jnp.asarray(np.where(allowed, 0.0, -1e9).astype(np.float32))
    kx = k if quant else k.astype(jnp.float32)
    vx = v if quant else v.astype(jnp.float32)
    ref = _xla_mha(q, kx, vx, mask, d ** -0.5, ks, vs)
    kt, vt, kst, vst = _torch_cache(k, v, ks, vs, torch.float32)
    out = pa.prefill_attention(_t(q), kt, vt, torch.from_numpy(positions.copy()),
                               scale=d ** -0.5, k_scale=kst, v_scale=vst)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("tq,offset", [(16, 0), (24, 40)])
@pytest.mark.parametrize("quant", [True, False])
def test_prefill_plain_matches_pallas_kernel_bf16(rng, tq, offset, quant):
    b, h, tk, d = 2, 2, 96, 32
    q = jnp.asarray(rng.normal(size=(b, h, tq, d)), jnp.bfloat16)
    k, v, ks, vs = _cache(rng, b, h, tk, d, quant, jnp.bfloat16)
    positions = offset + np.broadcast_to(np.arange(tq, dtype=np.int32)[None], (b, tq))
    ref = jax_prefill_attention(q, k, v, jnp.asarray(positions), scale=d ** -0.5,
                                k_scale=ks, v_scale=vs, interpret=True)
    kt, vt, kst, vst = _torch_cache(k, v, ks, vs, torch.bfloat16)
    out = pa.prefill_attention(_t(q, torch.bfloat16), kt, vt,
                               torch.from_numpy(positions.copy()), scale=d ** -0.5,
                               k_scale=kst, v_scale=vst)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _t(ref).numpy(), atol=BF16_ATOL, rtol=0)


def test_mha_routes_by_shape_and_counts_no_cpu_launch(rng):
    b, h, t, d = 1, 2, 16, 8
    k = torch.randn(b, h, t, d)
    v = torch.randn(b, h, t, d)
    counts = (da.counter.count, pa.counter.count)
    one = attention.mha(torch.randn(b, h, 1, d), k, v, kv_len=9)
    assert one.shape == (b, h, 1, d)
    with pytest.raises(ValueError):
        attention.mha(torch.randn(b, h, 4, d), k, v)  # a chunk needs positions
    pos = torch.arange(4, dtype=torch.int32)[None]
    assert attention.mha(torch.randn(b, h, 4, d), k, v, positions=pos).shape == (b, h, 4, d)
    assert (da.counter.count, pa.counter.count) == counts


def test_kv_len_reads_only_the_prefix():
    """Positions at or past kv_len never reach the result, whatever they hold."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 2, 1, 8, generator=g)
    k = torch.randn(2, 2, 20, 8, generator=g)
    v = torch.randn(2, 2, 20, 8, generator=g)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 12:] = 1e4
    v2[:, :, 12:] = float("nan")
    a = da.decode_attention(q, k, v, kv_len=12)
    b = da.decode_attention(q, k2, v2, kv_len=12)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
