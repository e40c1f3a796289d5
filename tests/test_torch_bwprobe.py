"""The port's bandwidth probe (myriad_tpu_torch/tools/bwprobe.py, kernel B7's
plain version and the CLI) against the JAX package's ``tools/bwprobe.py``
Pallas kernels in interpret mode, on the CPU.

Tolerance: none.  The operands hold small integers, so every fp32 partial
sum is exact on both sides whatever the order.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from myriad_tpu_torch.tools import bwprobe
import torch_threads  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tools/ is not a package: load the JAX probe by path, under its own name
_spec = importlib.util.spec_from_file_location("jax_bwprobe",
                                               os.path.join(REPO, "tools", "bwprobe.py"))
jax_bwprobe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_bwprobe)


def _operand(rng, rows, dtype):
    a = rng.integers(-3, 4, (rows, bwprobe.WIDTH)).astype(np.int8)
    return a if dtype == "int8" else np.asarray(jnp.asarray(a, jnp.bfloat16))


def _torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("two", [False, True])
def test_stream_sums_match_pallas_kernels(rng, dtype, two):
    """4 blocks of 128 rows x 4096 (2 MiB of int8): sum + c per block."""
    block, rows, c = 128, 512, 1.5
    x = _operand(rng, rows, dtype)
    y = _operand(rng, rows, dtype) if two else None
    with pltpu.force_tpu_interpret_mode():
        if two:
            ref = jax_bwprobe._stream_sum2(jnp.asarray(x), jnp.asarray(y), jnp.float32(c), block)
        else:
            ref = jax_bwprobe._stream_sum(jnp.asarray(x), jnp.float32(c), block)
    before = bwprobe.counter.count
    out = bwprobe.stream_sum(_torch(x), c, block, None if y is None else _torch(y))
    assert bwprobe.counter.count == before  # the CPU takes the plain version
    assert out.dtype == torch.float32 and out.dim() == 0
    assert float(out) == float(np.asarray(ref)[0, 0])
    want = float(np.asarray(x, np.float64).sum()) + c * (rows // block)
    if y is not None:
        want += float(np.asarray(y, np.float64).sum())
    assert float(out) == want


def test_probe_cli_on_the_cpu(capsys):
    assert bwprobe.main(["--gb", "0.01", "--iters", "2", "--impl", "cuda2", "--block", "64",
                         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "impl=cuda2: 2 passes" in out and "GB/s effective; cpu" in out
    for impl in ("cuda", "torch"):
        out = bwprobe.probe(0.005, "bfloat16", 2, impl, 32, "cpu")
        assert out["bytes"] == 640 * bwprobe.WIDTH * 2  # 0.005 GiB cut to whole blocks
        # ones: rows * WIDTH, plus c = i per block (only the kernel adds it)
        extra = [i * 640 // 32 for i in range(2)] if impl == "cuda" else [0, 1]
        assert out["sums"] == [640 * bwprobe.WIDTH + e for e in extra]
