"""The port's on-device preprocessing (myriad_tpu_torch/ops/preprocess.py:
kernel B6's plain version, the bicubic resize and ``device_preprocess``)
against the JAX package's, on the CPU.

Tolerances: B6's plain version is held to the TPU kernel in interpret mode
within 1e-6 in fp32 (XLA compiles the kernel's division by 255 into a
multiply by the reciprocal, the port divides: two ulps at |out| < 2.3) and
within one bf16 ulp (2^-6 at |out| < 4) in bf16; it equals JAX's XLA
normalisation (``u8_normalize``) bit for bit; the resize path is held within
1e-5 (fp32 matrix products summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu.ops import preprocess as jpp
from myriad_tpu_torch.ops import preprocess as pp
import torch_threads  # noqa: F401  (one torch thread a test process)


def _images(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(2, 28, 28, 3), (1, 5, 7, 3)])
def test_u8_normalize_rows_plain_matches_pallas_kernel(rng, shape):
    """(1, 5, 7, 3) is 105 elements: the TPU kernel pads to one (8, 128)
    block; the port needs no padding."""
    img = _images(rng, shape)
    ref = np.asarray(jpp.u8_normalize_pallas(jnp.asarray(img), interpret=True))
    before = pp.counter.count
    out = pp.u8_normalize_rows(torch.from_numpy(img))
    assert pp.counter.count == before  # the CPU takes the plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jpp.u8_normalize(jnp.asarray(img))))
    ref16 = jpp.u8_normalize_pallas(jnp.asarray(img), out_dtype=jnp.bfloat16, interpret=True)
    out16 = pp.u8_normalize_rows(torch.from_numpy(img), out_dtype=torch.bfloat16)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), np.asarray(ref16.astype(jnp.float32)),
                               atol=2.0 ** -6, rtol=0)


def test_resize_matrix_is_the_jax_one():
    for n_in, n_out in ((64, 32), (48, 24), (20, 28), (224, 224)):
        np.testing.assert_array_equal(pp.resize_matrix_bicubic(n_in, n_out),
                                      jpp.resize_matrix_bicubic(n_in, n_out))


@pytest.mark.parametrize("out_size,use_pallas", [(32, False), (32, True), (None, True),
                                                 (None, False), (40, False)])
def test_device_preprocess_matches_jax(rng, out_size, use_pallas):
    """JAX's branch order: the kernel only with use_pallas and no out_size;
    a resize where out_size differs from the image's (40 is the image's)."""
    img = _images(rng, (2, 40, 40, 3))
    ref = np.asarray(jpp.device_preprocess(jnp.asarray(img), out_size=out_size,
                                           use_pallas=use_pallas))
    out = pp.device_preprocess(torch.from_numpy(img), out_size=out_size, use_pallas=use_pallas)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
