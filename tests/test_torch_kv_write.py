"""The port's KV-cache writes (myriad_tpu_torch/ops/kv_write.py, the plain
version of kernel B4) against the JAX package's ``kv_cache_write``, on the
CPU.

Gates, all bit-exact (assert_array_equal): copy mode against the Pallas
kernel in interpret mode for D >= 8 and against ``vmap`` for D = 1 (the
per-position scales, which the TPU kernel could not write), with starts that
clamp on both sides; quantize mode against JAX ``quantize_kv`` followed by
``kv_cache_write`` for the payloads and the fp16 scales.  A negative start
clamps to 0 as in the Pallas kernel; JAX's ``vmap(dynamic_update_slice)``
would wrap it from the end, so the ``vmap`` comparisons take starts >= 0
(cache frontiers never go below 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu.models.llama import quantize_kv as jax_quantize_kv
from myriad_tpu.ops import kv_write as jkw
from myriad_tpu_torch.ops import kv_write
import torch_threads  # noqa: F401  (one torch thread a test process)

B, H, T = 3, 4, 24
# per-row starts: in range, past the end (clamped to T - t) and negative (to 0)
STARTS = np.array([5, 40, -3], np.int32)
STARTS_NONNEG = np.array([5, 40, 0], np.int32)


def _buffers(rng, d, t, dtype):
    if dtype == np.int8:
        buf = rng.integers(-127, 128, size=(B, H, T, d)).astype(np.int8)
        upd = rng.integers(-127, 128, size=(B, H, t, d)).astype(np.int8)
    else:
        buf = rng.normal(size=(B, H, T, d)).astype(dtype)
        upd = rng.normal(size=(B, H, t, d)).astype(dtype)
    return buf, upd


@pytest.mark.parametrize("d,t,dtype,impl", [
    (128, 4, np.int8, "pallas_interpret"),      # the int8 payload of a verify round
    (16, 1, np.float32, "pallas_interpret"),    # a decode step, float cache
    (8, 7, np.float32, "pallas_interpret"),
    (1, 4, np.float16, "vmap"),                 # the fp16 per-position scales
])
def test_copy_matches_jax(rng, d, t, dtype, impl):
    starts = STARTS if impl.startswith("pallas") else STARTS_NONNEG
    buf, upd = _buffers(rng, d, t, dtype)
    ref = np.asarray(jkw.kv_cache_write(jnp.asarray(buf), jnp.asarray(upd),
                                        jnp.asarray(starts), impl=impl))
    out = torch.from_numpy(buf.copy())
    res = kv_write.kv_cache_write(out, torch.from_numpy(upd), torch.from_numpy(starts))
    assert res is out  # written in place
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("start", [3, T - 2, -1])
def test_scalar_start_broadcasts_to_every_row(rng, start):
    buf, upd = _buffers(rng, 8, 4, np.float32)
    ref = np.asarray(jkw.kv_cache_write(jnp.asarray(buf), jnp.asarray(upd),
                                        jnp.full((B,), start, jnp.int32),
                                        impl="pallas_interpret"))
    out = torch.from_numpy(buf.copy())
    kv_write.kv_cache_write(out, torch.from_numpy(upd), start)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("t,x_dtype", [(1, jnp.float32), (4, jnp.float32), (9, jnp.bfloat16)])
def test_quantize_write_matches_jax(rng, t, x_dtype):
    d = 32
    k = np.array(jnp.asarray(rng.normal(size=(B, H, t, d)) * 3, x_dtype))
    v = np.asarray(jnp.asarray(rng.normal(size=(B, H, t, d)), x_dtype))
    k[0, 1, 0] = 0.0  # an all-zero row takes the 1e-8 scale floor
    bufs = {"k": rng.integers(-127, 128, size=(B, H, T, d)).astype(np.int8),
            "v": rng.integers(-127, 128, size=(B, H, T, d)).astype(np.int8),
            "k_scale": rng.random(size=(B, H, T, 1)).astype(np.float16),
            "v_scale": rng.random(size=(B, H, T, 1)).astype(np.float16)}
    idx = jnp.asarray(STARTS_NONNEG)
    ref = {}
    for name, x in (("k", k), ("v", v)):
        x8, s = jax_quantize_kv(jnp.asarray(x))
        ref[name] = jkw.kv_cache_write(jnp.asarray(bufs[name]), x8, idx, impl="vmap")
        ref[name + "_scale"] = jkw.kv_cache_write(jnp.asarray(bufs[name + "_scale"]),
                                                  s.astype(jnp.float16), idx, impl="vmap")
    out = {n: torch.from_numpy(a.copy()) for n, a in bufs.items()}
    to_torch = (lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                if x_dtype == jnp.bfloat16 else torch.from_numpy(a))
    kv_write.kv_quantize_write(out["k"], out["v"], out["k_scale"], out["v_scale"],
                               to_torch(k), to_torch(v), torch.from_numpy(STARTS_NONNEG))
    for name in bufs:
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]), err_msg=name)


def test_cpu_tensors_take_the_plain_version_and_bad_inputs_raise(rng):
    buf, upd = _buffers(rng, 8, 4, np.float32)
    before = kv_write.counter.count
    kv_write.kv_cache_write(torch.from_numpy(buf), torch.from_numpy(upd), 0)
    assert kv_write.counter.count == before  # no kernel on the CPU
    with pytest.raises(ValueError):  # the update does not fit the cache's heads
        kv_write.kv_cache_write(torch.from_numpy(buf), torch.zeros(B, H + 1, 4, 8), 0)
    with pytest.raises(ValueError):  # per-row starts of the wrong length
        kv_write.kv_cache_write(torch.from_numpy(buf), torch.from_numpy(upd),
                                torch.zeros(B + 1, dtype=torch.int32))
