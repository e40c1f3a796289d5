"""The port's CUDA kernels (B1, B2, B3) against their plain PyTorch versions,
on the card.  Every test here needs a CUDA device and skips without one.

This file imports no JAX (the card has none), so it runs there without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Tolerances: B1 one bf16 rounding of the largest output (2^-7 * max|plain|);
B2/B3 2e-2 absolute (bf16 probabilities and outputs, |out| of a few units).
"""

import pytest
import torch

from myriad_tpu_torch.models.llama import quantize_kv
from myriad_tpu_torch.ops import decode_attention as da
from myriad_tpu_torch.ops import prefill_attention as pa
from myriad_tpu_torch.ops import quant

pytestmark = pytest.mark.cuda
BF16_ATOL = 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cache(dev, g, b, h, t, d, int8):
    k = torch.randn(b, h, t, d, generator=g, device=dev)
    v = torch.randn(b, h, t, d, generator=g, device=dev)
    if not int8:
        return k.bfloat16(), v.bfloat16(), None, None
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    return k8, v8, ks.half(), vs.half()


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 4096, 11008), (48, 11008, 4096),
                                   (256, 4096, 4096), (3, 96, 40)])
def test_int8_matmul_kernel_matches_plain(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(0)
    w8, scale = quant.quantize_per_channel(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    before = quant.counter.count
    out = quant.int8_weight_only_matmul(x, w8, scale)
    assert quant.counter.count == before + 1
    ref = quant.int8_weight_only_matmul_plain(x, w8, scale)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert (out.float() - ref.float()).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()


def test_int8_matmul_row_rule_on_card(dev):
    """Rows <= 256 take kernel B1; more rows take W8A8 on torch._int_mm."""
    g = torch.Generator(device=dev).manual_seed(1)
    w8, scale = quant.quantize_per_channel(torch.randn(512, 256, generator=g, device=dev))
    before = quant.counter.count
    quant.int8_matmul(torch.randn(2, 128, 512, generator=g, device=dev).bfloat16(), w8, scale)
    assert quant.counter.count == before + 1
    x = torch.randn(300, 512, generator=g, device=dev)
    y = quant.int8_matmul(x.bfloat16(), w8, scale)
    assert quant.counter.count == before + 1
    ref = quant.w8a8_matmul(x.bfloat16().float().cpu(), w8.cpu(), scale.cpu())
    torch.testing.assert_close(y.float().cpu(), ref.bfloat16().float(), rtol=2 ** -7, atol=1e-3)


def test_kernels_refuse_what_they_do_not_take(dev):
    w8 = torch.zeros(64, 32, dtype=torch.int8, device=dev)
    scale = torch.ones(32, device=dev)
    with pytest.raises(ValueError):  # fp32 activations
        quant.int8_weight_only_matmul(torch.zeros(4, 64, device=dev), w8, scale)
    with pytest.raises(ValueError):  # more rows than the kernel serves
        quant.int8_weight_only_matmul(torch.zeros(300, 64, dtype=torch.bfloat16, device=dev),
                                      w8, scale)
    q = torch.zeros(1, 2, 1, 256, dtype=torch.bfloat16, device=dev)
    kv = torch.zeros(1, 2, 8, 256, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # head dim above 128
        da.decode_attention(q, kv, kv)


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("kv_len", [320, 416])
def test_decode_attention_kernel_matches_plain(dev, int8, kv_len):
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, t, d = 8, 32, 416, 128
    q = torch.randn(b, h, 1, d, generator=g, device=dev).to(torch.bfloat16)
    k, v, ks, vs = _cache(dev, g, b, h, t, d, int8)
    mask = torch.where(torch.arange(kv_len, device=dev) <= 300, 0.0, -1e9)
    mask = mask[None, None, None].expand(b, 1, 1, kv_len)
    args = dict(mask=mask, k_scale=ks, v_scale=vs, kv_len=kv_len)
    before = da.counter.count
    out = da.decode_attention(q, k, v, **args)
    assert da.counter.count == before + 1
    ref = da.decode_attention_plain(q, k, v, **args)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_ATOL


@pytest.mark.parametrize("tq,offset", [(297, 0), (33, 264), (7, 290), (1, 100)])
@pytest.mark.parametrize("int8", [True, False])
def test_prefill_attention_kernel_matches_plain(dev, tq, offset, int8):
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, tk, d = 2, 32, 416, 128
    q = torch.randn(b, h, tq, d, generator=g, device=dev).to(torch.bfloat16)
    k, v, ks, vs = _cache(dev, g, b, h, tk, d, int8)
    pos = (offset + torch.arange(tq, device=dev, dtype=torch.int32))[None].expand(b, tq)
    args = dict(scale=d ** -0.5, k_scale=ks, v_scale=vs)
    before = pa.counter.count
    out = pa.prefill_attention(q, k, v, pos, **args)
    assert pa.counter.count == before + 1
    ref = pa.prefill_attention_plain(q, k, v, pos, **args)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_ATOL
