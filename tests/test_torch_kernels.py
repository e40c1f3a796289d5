"""The port's CUDA kernels (B1-B7) against their plain PyTorch versions, on
the card.  Every test here needs a CUDA device and skips without one.

This file imports no JAX (the card has none), so it runs there without the
suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Tolerances: B1 and B5 one bf16 rounding of the largest output (2^-7 *
max|plain|: the same dequantized weight, fp32 sums in another order, one
rounding to bf16), and none where one-hot rows make every sum exact; B2, B2' and B3 2e-2 absolute (bf16 probabilities and
outputs, |out| of a few units); B4, B6 and B7 none: B4's writes, B6's IEEE
divisions and B7's sums of small integers are exact.
"""

import functools

import pytest
import torch

from myriad_tpu_torch.ops import decode_attention as da
from myriad_tpu_torch.ops import kv_write as kw
from myriad_tpu_torch.ops import prefill_attention as pa
from myriad_tpu_torch.ops import preprocess as pp
from myriad_tpu_torch.ops import quant
from myriad_tpu_torch.tools import bwprobe

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
    (k8, ks), (v8, vs) = kw.quantize_kv(k), kw.quantize_kv(v)
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


@functools.lru_cache(maxsize=3)
def _int8_weight(k, n):
    g = torch.Generator(device="cuda").manual_seed(k + n)
    return quant.quantize_per_channel(torch.randn(k, n, generator=g, device="cuda") * 0.02)


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096)])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 31, 32, 33, 64, 132, 240, 256])
def test_int8_matmul_kernel_row_sweep(dev, m, k, n):
    """Every row count around the kernel's 8-row tiles and 32-row slabs, at
    Vicuna-7B's three projection shapes (M = 132: a chat turn's delta)."""
    w8, scale = _int8_weight(k, n)
    x = torch.randn(m, k, generator=torch.Generator(device=dev).manual_seed(m), device=dev)
    x = x.to(torch.bfloat16)
    out = quant.int8_weight_only_matmul(x, w8, scale)
    ref = quant.int8_weight_only_matmul_plain(x, w8, scale)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert (out.float() - ref.float()).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()


def _int8_random(dev, k, n, seed=3):
    """Random int8 weights, -128 included, and scales over several binades."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w8 = torch.randint(-128, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    scale = torch.exp(torch.randn(n, generator=g, device=dev) * 3) * 0.01
    return w8, scale


@pytest.mark.parametrize("k,n", [(4096, 11008), (1000, 36), (1000, 40), (1000, 48), (999, 44)])
@pytest.mark.parametrize("m", [16, 32])
def test_int8_matmul_kernel_converts_exactly(dev, m, k, n):
    """One-hot rows of x pick one weight row each, and the picked rows hold
    every int8 value: every output is one weight byte times its column's
    scale, bit-identical to the plain version.  N = 36, 40 and 44 take the
    4-byte copies; K = 1000 and 999 end inside a stage, through the tensor
    copy (N = 48) and the element copies of x (K odd)."""
    w8, scale = _int8_random(dev, k, n)
    g = torch.Generator(device=dev).manual_seed(m)
    pick = torch.randperm(k, generator=g, device=dev)[:m]
    every = torch.arange(m * n, device=dev) % 256 - 128
    w8[pick] = every.reshape(m, n).to(torch.int8)
    x = torch.zeros(m, k, device=dev, dtype=torch.bfloat16)
    x[torch.arange(m, device=dev), pick] = 1.0
    out = quant.int8_weight_only_matmul(x, w8, scale)
    ref = quant.int8_weight_only_matmul_plain(x, w8, scale)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("m,k,n", [(8, 4096, 11008), (32, 11008, 4096), (256, 4096, 4096),
                                   (5, 1000, 36)])
def test_int8_matmul_kernel_deterministic(dev, m, k, n):
    """The splits of K are summed in a fixed order: two runs give the same
    bits."""
    w8, scale = _int8_random(dev, k, n)
    x = torch.randn(m, k, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    x = x.to(torch.bfloat16)
    assert torch.equal(quant.int8_weight_only_matmul(x, w8, scale),
                       quant.int8_weight_only_matmul(x, w8, scale))


@pytest.mark.parametrize("m", [8, 32, 256])
def test_int8_matmul_kernel_one_launch_no_scratch(dev, m):
    """One call counts one launch and allocates its output and nothing else:
    the splits of K meet in the cluster's shared memory."""
    w8, scale = _int8_random(dev, 4096, 11008)
    x = torch.randn(m, 4096, device=dev).to(torch.bfloat16)
    quant.int8_weight_only_matmul(x, w8, scale)  # built and warm
    torch.cuda.synchronize()
    before, allocs = quant.counter.count, torch.cuda.memory_stats()["allocation.all.allocated"]
    out = quant.int8_weight_only_matmul(x, w8, scale)
    assert quant.counter.count == before + 1
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs + 1
    assert out.shape == (m, 11008)


def test_int8_matmul_launch_plan(dev):
    """The splits of K fill the card at the three projection shapes, the
    card holds the clusters, and up to 32 rows three blocks share an SM."""
    for k, n, splits in ((4096, 4096, 8), (4096, 11008, 4), (11008, 4096, 8)):
        for m in (8, 16, 32):
            plan = quant.int8_launch(m, k, n)
            assert plan["splits"] == splits and plan["tiles"] == -(-n // 128)
            assert plan["clusters"] > 0 and plan["blocks_per_sm"] == 3


def _decode_case(dev, b, kv_len, int8, masked, seed=0, d=128):
    """A cache of at least 416 positions, of which the first ``kv_len`` are
    read; the caller's mask hides the positions past 300 (or past kv_len - 5
    on a short cache), or there is no mask."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, t = 32, max(416, kv_len)
    q = torch.randn(b, h, 1, d, generator=g, device=dev).to(torch.bfloat16)
    k, v, ks, vs = _cache(dev, g, b, h, t, d, int8)
    mask = None
    if masked:
        frontier = max(0, min(300, kv_len - 5))
        mask = torch.where(torch.arange(kv_len, device=dev) <= frontier, 0.0, -1e9)
        mask = mask[None, None, None].expand(b, 1, 1, kv_len)
    return q, k, v, dict(mask=mask, k_scale=ks, v_scale=vs, kv_len=kv_len)


# (batch, kv_len): the greedy path's shapes; 333 ends inside a key tile and
# inside a split; 37 and 64 take one split (no cluster); at batch 1, 8192
# positions ask for 9 splits and take the cluster's cap of 8
DECODE_CASES = [(8, 320), (8, 416), (8, 333), (8, 64), (1, 37), (1, 512), (1, 8192),
                (8, 8192)]


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("b,kv_len", DECODE_CASES)
def test_decode_attention_kernel_matches_plain(dev, b, kv_len, int8, masked):
    q, k, v, args = _decode_case(dev, b, kv_len, int8, masked)
    before = da.counter.count
    out = da.decode_attention(q, k, v, **args)
    assert da.counter.count == before + 1
    ref = da.decode_attention_plain(q, k, v, **args)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_ATOL


def test_decode_attention_cluster_plan(dev):
    """The splits of one (b, h) form one cluster: 2 at the greedy path's
    shape (512 blocks, all resident at once), capped at 8 (the portable
    cluster size) at batch 1 on a long cache, and one split, with no cluster
    and no inbox for the merge, up to 64 positions."""
    main = da.cluster_launch(8, 32, 320)
    assert main["splits"] == 2 and main["clusters"] * 2 >= 8 * 32 * 2
    long = da.cluster_launch(1, 32, 8192)
    assert long["splits"] == 8 and long["clusters"] > 0 and long["smem"] == main["smem"]
    one = da.cluster_launch(8, 32, 64)
    assert one["splits"] == 1 and one["clusters"] == 0 and one["smem"] < main["smem"]


@pytest.mark.parametrize("b,kv_len", [(8, 320), (8, 333), (1, 8192)])
def test_decode_attention_kernel_deterministic(dev, b, kv_len):
    """The cluster's rank 0 merges the splits in rank order: two runs give
    the same bits."""
    q, k, v, args = _decode_case(dev, b, kv_len, True, True)
    first = da.decode_attention(q, k, v, **args)
    assert torch.equal(first, da.decode_attention(q, k, v, **args))


@pytest.mark.parametrize("masked", [True, False])
def test_decode_attention_kernel_one_launch_no_scratch(dev, masked):
    """One call counts one launch and allocates its output and nothing else:
    no scratch for the splits, no mask when the caller gives none or gives it
    as fp32 (B, 1, 1, kv_len), contiguous."""
    q, k, v, args = _decode_case(dev, 8, 320, True, masked)
    if masked:
        args["mask"] = args["mask"].contiguous()
    da.decode_attention(q, k, v, **args)  # built and warm
    torch.cuda.synchronize()
    before, allocs = da.counter.count, torch.cuda.memory_stats()["allocation.all.allocated"]
    out = da.decode_attention(q, k, v, **args)
    assert da.counter.count == before + 1
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs + 1
    assert out.shape == q.shape


# the serving engine's decode step: eight rows at frontiers spread over 64-410,
# each masked at its own frontier over the whole 416-position bucket
ENGINE_FRONTIERS = [64, 410, 297, 120, 233, 350, 180, 389]


@pytest.mark.parametrize("int8", [True, False])
def test_decode_attention_kernel_ragged_frontiers(dev, int8):
    from myriad_tpu_torch.ops.attention import causal_mask

    g = torch.Generator(device=dev).manual_seed(11)
    b, h, t, d = 8, 32, 416, 128
    q = torch.randn(b, h, 1, d, generator=g, device=dev).to(torch.bfloat16)
    k, v, ks, vs = _cache(dev, g, b, h, t, d, int8)
    front = torch.tensor(ENGINE_FRONTIERS, device=dev, dtype=torch.int32)
    args = dict(mask=causal_mask(front[:, None], t), k_scale=ks, v_scale=vs, kv_len=t)
    before = da.counter.count
    out = da.decode_attention(q, k, v, **args)
    assert da.counter.count == before + 1
    ref = da.decode_attention_plain(q, k, v, **args)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_ATOL
    assert torch.equal(out, da.decode_attention(q, k, v, **args))
    # a row sees nothing past its frontier: junk there changes no output
    k2, v2 = k.clone(), v.clone()
    for i, f in enumerate(ENGINE_FRONTIERS):
        k2[i, :, f + 1:] = k2[i, :, f + 1:].flip(1)
        v2[i, :, f + 1:] = 0
    assert torch.equal(out, da.decode_attention(q, k2, v2, **args))


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


@pytest.mark.parametrize("t", [1, 4, 297])
def test_prefill_attention_kernel_ragged_positions(dev, t):
    """Per-row positions (a speculative verify round): each row's block stops
    at its own last visible key."""
    g = torch.Generator(device=dev).manual_seed(2)
    b, h, tk, d = 8, 32, 416, 128
    q = torch.randn(b, h, t, d, generator=g, device=dev).to(torch.bfloat16)
    k, v, ks, vs = _cache(dev, g, b, h, tk, d, True)
    starts = torch.tensor([0, 3, 17, 60, 101, 64, 90, 119], device=dev, dtype=torch.int32)
    pos = starts[:, None] + torch.arange(t, device=dev, dtype=torch.int32)[None, :]
    args = dict(scale=d ** -0.5, k_scale=ks, v_scale=vs)
    out = pa.prefill_attention(q, k, v, pos, **args)
    ref = pa.prefill_attention_plain(q, k, v, pos, **args)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_ATOL


STARTS = [300, 412, 0, 413, 37, 200, 5, 1000]  # 413 and 1000 clamp to T - t


@pytest.mark.parametrize("dtype,d", [(torch.int8, 128), (torch.float16, 1),
                                     (torch.bfloat16, 128), (torch.int8, 36)])
@pytest.mark.parametrize("per_row", [True, False])
def test_kv_write_copy_bit_exact(dev, dtype, d, per_row):
    g = torch.Generator(device=dev).manual_seed(3)
    b, h, T, t = 8, 32, 416, 4
    buf = (torch.randn(b, h, T, d, generator=g, device=dev) * 50).to(dtype)
    upd = (torch.randn(b, h, t, d, generator=g, device=dev) * 50).to(dtype)
    idx = torch.tensor(STARTS, dtype=torch.int32, device=dev) if per_row else 413
    out, ref = buf.clone(), buf.clone()
    before = kw.counter.count
    kw.kv_cache_write(out, upd, idx)
    assert kw.counter.count == before + 1
    kw.kv_cache_write_plain(ref, upd, idx)
    assert torch.equal(out, ref)
    # a strided update (the attention's transposed K) takes the same path
    upd_t = upd.transpose(1, 2).contiguous().transpose(1, 2)
    out2 = buf.clone()
    kw.kv_cache_write(out2, upd_t, idx)
    assert torch.equal(out2, ref)


@pytest.mark.parametrize("t,d", [(1, 128), (4, 128), (297, 128), (4, 40)])
def test_kv_quantize_write_bit_exact(dev, t, d):
    g = torch.Generator(device=dev).manual_seed(4)
    b, h, T = 8, 32, 416
    bufs = [torch.randint(-127, 128, (b, h, T, d), generator=g, device=dev, dtype=torch.int8)
            for _ in range(2)]
    scales = [torch.rand(b, h, T, 1, generator=g, device=dev).half() for _ in range(2)]
    k = (torch.randn(b, t, h, d, generator=g, device=dev) * 4).bfloat16().transpose(1, 2)
    v = torch.randn(b, t, h, d, generator=g, device=dev).bfloat16().transpose(1, 2)
    k[0, 1, 0] = 0  # an all-zero row takes the 1e-8 scale floor
    idx = torch.tensor(STARTS, dtype=torch.int32, device=dev) if t < 297 else 0
    out = [x.clone() for x in bufs + scales]
    ref = [x.clone() for x in bufs + scales]
    before = kw.counter.count
    kw.kv_quantize_write(*out, k, v, idx)
    assert kw.counter.count == before + 1
    kw.kv_quantize_write_plain(*ref, k, v, idx)
    for name, a, r in zip(("k", "v", "k_scale", "v_scale"), out, ref):
        assert torch.equal(a, r), name


def test_kv_quantize_write_engine_decode_step(dev):
    """The engine's decode step: t = 1 at eight per-row frontiers."""
    g = torch.Generator(device=dev).manual_seed(12)
    b, h, T, d = 8, 32, 416, 128
    bufs = [torch.randint(-127, 128, (b, h, T, d), generator=g, device=dev, dtype=torch.int8)
            for _ in range(2)]
    bufs += [torch.rand(b, h, T, 1, generator=g, device=dev).half() for _ in range(2)]
    k = (torch.randn(b, 1, h, d, generator=g, device=dev) * 4).bfloat16().transpose(1, 2)
    v = torch.randn(b, 1, h, d, generator=g, device=dev).bfloat16().transpose(1, 2)
    idx = torch.tensor(ENGINE_FRONTIERS, dtype=torch.int32, device=dev)
    out, ref = [x.clone() for x in bufs], [x.clone() for x in bufs]
    before = kw.counter.count
    kw.kv_quantize_write(*out, k, v, idx)
    assert kw.counter.count == before + 1
    kw.kv_quantize_write_plain(*ref, k, v, idx)
    for name, a, r in zip(("k", "v", "k_scale", "v_scale"), out, ref):
        assert torch.equal(a, r), name
    # one position a row, at its frontier, and nothing else
    changed = (out[0] != bufs[0]).any(dim=-1).any(dim=1)  # (b, T)
    for i, f in enumerate(ENGINE_FRONTIERS):
        assert changed[i].nonzero().flatten().tolist() in ([f], [])


def test_kv_write_refuses_what_it_does_not_take(dev):
    buf = torch.zeros(2, 4, 16, 8, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # dtype mismatch
        kw.kv_cache_write(buf, torch.zeros(2, 4, 1, 8, device=dev), 0)
    with pytest.raises(ValueError):  # per-row starts must be int32 on the card
        kw.kv_cache_write(buf, torch.zeros(2, 4, 1, 8, dtype=torch.bfloat16, device=dev),
                          torch.zeros(2, dtype=torch.int64, device=dev))
    k8 = torch.zeros(2, 4, 16, 8, dtype=torch.int8, device=dev)
    sc = torch.zeros(2, 4, 16, 1, dtype=torch.float16, device=dev)
    with pytest.raises(ValueError):  # fp32 K/V
        kw.kv_quantize_write(k8, k8.clone(), sc, sc.clone(), torch.zeros(2, 4, 1, 8, device=dev),
                             torch.zeros(2, 4, 1, 8, device=dev), 0)


# B4 over block boundaries (B * H * t not a multiple of a block's rows, H odd),
# every row width (D = 1: the scales; 80: a row of 10 lanes in a group of 16;
# 37: element loops) and the three path lengths; per-row starts that clamp
KV_SHAPES = [(8, 32, 1), (1, 32, 1), (3, 5, 1), (3, 7, 4), (2, 3, 297)]
KV_DIMS = [1, 8, 37, 64, 80, 128, 256]


def _kv_case(dev, seed, b, h, t, d, T=416):
    g = torch.Generator(device=dev).manual_seed(seed)
    k = (torch.randn(b, t, h, d, generator=g, device=dev) * 4).bfloat16().transpose(1, 2)
    v = torch.randn(b, t, h, d, generator=g, device=dev).bfloat16().transpose(1, 2)
    bufs = [torch.randint(-127, 128, (b, h, T, d), generator=g, device=dev, dtype=torch.int8)
            for _ in range(2)]
    bufs += [torch.rand(b, h, T, 1, generator=g, device=dev).half() for _ in range(2)]
    starts = torch.tensor((STARTS * b)[:b], dtype=torch.int32, device=dev)
    return k, v, bufs, starts


def _quantize_write_both(bufs, k, v, idx):
    out, ref = [x.clone() for x in bufs], [x.clone() for x in bufs]
    kw.kv_quantize_write(*out, k, v, idx)
    kw.kv_quantize_write_plain(*ref, k, v, idx)
    return out, ref


@pytest.mark.parametrize("d", KV_DIMS)
@pytest.mark.parametrize("b,h,t", KV_SHAPES)
def test_kv_quantize_write_any_rows_and_width(dev, b, h, t, d):
    k, v, bufs, starts = _kv_case(dev, 11, b, h, t, d)
    k[0, h - 1, t - 1] = 0  # an all-zero row takes the 1e-8 scale floor
    for idx in (starts, 413):
        before = kw.counter.count
        out, ref = _quantize_write_both(bufs, k, v, idx)
        assert kw.counter.count == before + 1
        for name, a, r in zip(("k", "v", "k_scale", "v_scale"), out, ref):
            assert torch.equal(a, r), name


@pytest.mark.parametrize("d", KV_DIMS)
@pytest.mark.parametrize("b,h,t", KV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.int8, torch.float16, torch.bfloat16])
def test_kv_write_copy_any_rows_and_width(dev, b, h, t, d, dtype):
    g = torch.Generator(device=dev).manual_seed(12)
    buf = (torch.randn(b, h, 416, d, generator=g, device=dev) * 50).to(dtype)
    upd = (torch.randn(b, t, h, d, generator=g, device=dev) * 50).to(dtype).transpose(1, 2)
    starts = torch.tensor((STARTS * b)[:b], dtype=torch.int32, device=dev)
    for idx in (starts, 413):
        out, ref = buf.clone(), buf.clone()
        kw.kv_cache_write(out, upd, idx)
        kw.kv_cache_write_plain(ref, upd, idx)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("shift", [1, 2, 4, 8])
def test_kv_write_unaligned_views(dev, shift, d):
    """K and V, payloads and scales that start `shift` elements into their
    storage (the copy's byte units or the quantization's one-warp rows)."""
    b, h, t, T = 3, 5, 4, 64
    g = torch.Generator(device=dev).manual_seed(13)

    def view(n, dtype, shape, fill):
        flat = fill(torch.empty(n + shift, device=dev)).to(dtype)
        return flat[shift:].view(shape)

    rand = lambda x: x.normal_(generator=g) * 4  # noqa: E731
    k = view(b * t * h * d, torch.bfloat16, (b, t, h, d), rand).transpose(1, 2)
    v = view(b * t * h * d, torch.bfloat16, (b, t, h, d), rand).transpose(1, 2)
    bufs = [view(b * h * T * d, torch.int8, (b, h, T, d), rand) for _ in range(2)]
    bufs += [view(b * h * T, torch.float16, (b, h, T, 1), rand) for _ in range(2)]
    starts = torch.tensor(STARTS[:b], dtype=torch.int32, device=dev)
    out, ref = _quantize_write_both(bufs, k, v, starts)
    for name, a, r in zip(("k", "v", "k_scale", "v_scale"), out, ref):
        assert torch.equal(a, r), name
    for buf, upd in ((bufs[0], bufs[1][:, :, :t]), (bufs[2], bufs[3][:, :, :t])):
        o, r = buf.clone(), buf.clone()
        kw.kv_cache_write(o, upd, starts)
        kw.kv_cache_write_plain(r, upd, starts)
        assert torch.equal(o, r)


@pytest.mark.parametrize("b,h,t", [(8, 32, 1), (8, 32, 4), (8, 32, 297)])
def test_kv_quantize_write_deterministic_and_in_a_graph(dev, b, h, t):
    """The same bits twice, and from a CUDA graph's replay."""
    k, v, bufs, starts = _kv_case(dev, 14, b, h, t, 128)
    idx = starts if t == 4 else 300
    out, ref = _quantize_write_both(bufs, k, v, idx)
    again = [x.clone() for x in bufs]
    kw.kv_quantize_write(*again, k, v, idx)
    graphed = [x.clone() for x in bufs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kw.kv_quantize_write(*graphed, k, v, idx)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graphed = [x.clone() for x in bufs]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kw.kv_quantize_write(*graphed, k, v, idx)
    graph.replay()
    torch.cuda.synchronize()
    for a, b2, c, r in zip(out, again, graphed, ref):
        assert torch.equal(a, r) and torch.equal(b2, r) and torch.equal(c, r)


def test_kv_write_refuses_layouts_it_does_not_serve(dev):
    b, h, T, t, d = 2, 4, 16, 1, 8
    k8 = torch.zeros(b, h, T, d, dtype=torch.int8, device=dev)
    sc = torch.zeros(b, h, T, 1, dtype=torch.float16, device=dev)
    x = torch.zeros(b, h, t, d, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # scales not of the payload's strides / D
        wide = torch.zeros(b, h, T, 2, dtype=torch.float16, device=dev)[..., :1]
        kw.kv_quantize_write(k8, k8.clone(), wide, wide.clone(), x, x.clone(), 0)
    with pytest.raises(ValueError):  # payload positions not one row after the other
        sparse = torch.zeros(b, h, T, 2 * d, dtype=torch.int8, device=dev)[..., :d]
        kw.kv_quantize_write(sparse, sparse.clone(), sc, sc.clone(), x, x.clone(), 0)
    with pytest.raises(ValueError):  # K and V of two layouts
        every_other_head = torch.zeros(b, 2 * h, t, d, dtype=torch.bfloat16, device=dev)[:, ::2]
        kw.kv_quantize_write(k8, k8.clone(), sc, sc.clone(), x, every_other_head, 0)
    with pytest.raises(ValueError):  # an update without a contiguous last dim
        kw.kv_cache_write(k8, torch.zeros(b, h, d, 2, dtype=torch.int8, device=dev).mT, 0)
    with pytest.raises(ValueError):  # the update on another device
        kw.kv_cache_write(k8, torch.zeros(b, h, t, d, dtype=torch.int8), 0)


@pytest.mark.parametrize("m,k,n", [(1, 4096, 11008), (8, 4096, 11008), (32, 11008, 4096),
                                   (8, 4096, 4096), (256, 4096, 4096), (3, 64, 40),
                                   (5, 1000, 36)])
def test_int4_matmul_kernel_matches_plain(dev, m, k, n):
    """Vicuna-7B's projections at M = 1, 8, 32; K = 11008 ends in a half
    chunk; K = 64 and 1000 are one group of the whole dim (g != 128)."""
    g = torch.Generator(device=dev).manual_seed(0)
    w4, s4 = quant.quantize_int4_grouped(torch.randn(k, n, generator=g, device=dev) * 0.02)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    before = quant.counter4.count
    out = quant.int4_weight_only_matmul(x, w4, s4)
    assert quant.counter4.count == before + 1
    ref = quant.int4_weight_only_matmul_plain(x, w4, s4)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert (out.float() - ref.float()).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()


def test_int4_matmul_row_rule_on_card(dev):
    """Rows <= 256 take kernel B5; more rows requantize and take W8A8."""
    g = torch.Generator(device=dev).manual_seed(1)
    w4, s4 = quant.quantize_int4_grouped(torch.randn(512, 256, generator=g, device=dev))
    before8, before4 = quant.counter.count, quant.counter4.count
    quant.int4_matmul(torch.randn(2, 128, 512, generator=g, device=dev).bfloat16(), w4, s4)
    assert quant.counter4.count == before4 + 1
    x = torch.randn(300, 512, generator=g, device=dev)
    y = quant.int4_matmul(x.bfloat16(), w4, s4)
    assert (quant.counter.count, quant.counter4.count) == (before8, before4 + 1)
    w8, s_col = quant.requantize_int4_to_int8(w4.cpu(), s4.cpu())
    ref = quant.w8a8_matmul(x.bfloat16().float().cpu(), w8, s_col)
    torch.testing.assert_close(y.float().cpu(), ref.bfloat16().float(), rtol=2 ** -7, atol=1e-3)


def test_int4_matmul_refuses_what_it_does_not_take(dev):
    w4 = torch.zeros(32, 40, dtype=torch.uint8, device=dev)
    s4 = torch.ones(1, 40, device=dev)
    with pytest.raises(ValueError):  # fp32 activations
        quant.int4_weight_only_matmul(torch.zeros(4, 64, device=dev), w4, s4)
    with pytest.raises(ValueError):  # more rows than the kernel serves
        quant.int4_weight_only_matmul(torch.zeros(300, 64, dtype=torch.bfloat16, device=dev),
                                      w4, s4)
    with pytest.raises(ValueError):  # N not a multiple of 4
        quant.int4_weight_only_matmul(torch.zeros(4, 64, dtype=torch.bfloat16, device=dev),
                                      w4[:, :38].contiguous(), s4[:, :38].contiguous())


@functools.lru_cache(maxsize=3)
def _int4_weight(k, n):
    g = torch.Generator(device="cuda").manual_seed(k + n)
    return quant.quantize_int4_grouped(torch.randn(k, n, generator=g, device="cuda") * 0.02)


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096)])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 31, 32, 33, 64, 132, 240, 256])
def test_int4_matmul_kernel_row_sweep(dev, m, k, n):
    """Every row count around the kernel's 8-row tiles and 32-row slabs, at
    Vicuna-7B's three projection shapes."""
    w4, s4 = _int4_weight(k, n)
    x = torch.randn(m, k, generator=torch.Generator(device=dev).manual_seed(m), device=dev)
    x = x.to(torch.bfloat16)
    out = quant.int4_weight_only_matmul(x, w4, s4)
    ref = quant.int4_weight_only_matmul_plain(x, w4, s4)
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert (out.float() - ref.float()).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()


def _int4_random(dev, k, n, group, seed=3):
    """Every nibble value, and scales over several binades."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w4 = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    s4 = torch.exp(torch.randn(k // group, n, generator=g, device=dev) * 3) * 0.01
    return w4, s4


@pytest.mark.parametrize("k,n,group", [(4096, 4096, 128), (4096, 11008, 128), (1000, 36, 1000),
                                       (1000, 40, 40)])
@pytest.mark.parametrize("m", [16, 32])
def test_int4_matmul_kernel_dequantizes_exactly(dev, m, k, n, group):
    """One-hot rows of x pick one input row each, so every output is one
    dequantized weight element: bit-identical to the plain version, at group
    128, at a whole-dim group that is not a multiple of 16, and at a group
    that splits the kernel's 128-row stages (its scales are looked up per
    register)."""
    w4, s4 = _int4_random(dev, k, n, group)
    g = torch.Generator(device=dev).manual_seed(m)
    pick = torch.randperm(k, generator=g, device=dev)[:m]
    x = torch.zeros(m, k, device=dev, dtype=torch.bfloat16)
    x[torch.arange(m, device=dev), pick] = 1.0
    out = quant.int4_weight_only_matmul(x, w4, s4)
    ref = quant.int4_weight_only_matmul_plain(x, w4, s4)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("m,k,n", [(8, 4096, 11008), (32, 11008, 4096), (256, 4096, 4096),
                                   (5, 1000, 36)])
def test_int4_matmul_kernel_deterministic(dev, m, k, n):
    """The splits of K are summed in a fixed order: two runs give the same
    bits."""
    w4, s4 = _int4_random(dev, k, n, quant.int4_group(k))
    x = torch.randn(m, k, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    x = x.to(torch.bfloat16)
    assert torch.equal(quant.int4_weight_only_matmul(x, w4, s4),
                       quant.int4_weight_only_matmul(x, w4, s4))


@pytest.mark.parametrize("m", [8, 32, 256])
def test_int4_matmul_kernel_one_launch_no_scratch(dev, m):
    """One call counts one launch and allocates its output and nothing else:
    the splits of K meet in the cluster's shared memory."""
    w4, s4 = _int4_random(dev, 4096, 11008, 128)
    x = torch.randn(m, 4096, device=dev).to(torch.bfloat16)
    quant.int4_weight_only_matmul(x, w4, s4)  # built and warm
    torch.cuda.synchronize()
    before, allocs = quant.counter4.count, torch.cuda.memory_stats()["allocation.all.allocated"]
    out = quant.int4_weight_only_matmul(x, w4, s4)
    assert quant.counter4.count == before + 1
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs + 1
    assert out.shape == (m, 11008)


def test_int4_matmul_launch_plan(dev):
    """The splits of K fill the card at both output widths, and the card
    holds the clusters."""
    for k, n, splits in ((4096, 4096, 8), (4096, 11008, 4), (11008, 4096, 8)):
        plan = quant.int4_launch(8, k, n, 128)
        assert plan["splits"] == splits and plan["tiles"] == -(-n // 128)
        assert plan["clusters"] > 0


def _rows_case(dev, int8, kv_len, seed=5, d=128):
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, t = 8, 32, max(416, kv_len)
    q = torch.randn(b, h, 1, d, generator=g, device=dev).to(torch.bfloat16)
    k, v, ks, vs = _cache(dev, g, b, h, t, d, int8)
    frontier = max(0, min(300, kv_len - 5))
    mask = torch.where(torch.arange(kv_len, device=dev) <= frontier, 0.0, -1e9)
    mask = mask[None, None, None].expand(b, 1, 1, kv_len)
    return q, k, v, dict(mask=mask, k_scale=ks, v_scale=vs, kv_len=kv_len)


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("kv_len", [1, 37, 320, 416, 8192])
def test_decode_attention_rows_kernel_matches_plain(dev, int8, kv_len):
    """Any cache length: 8192 is past what the one-block-per-row design held
    in shared memory; 37 and 320 end inside a key tile and a split."""
    q, k, v, args = _rows_case(dev, int8, kv_len)
    before = da.counter_rows.count
    out = da.decode_attention_rows(q, k, v, **args)
    assert da.counter_rows.count == before + 1
    ref = da.decode_attention_rows_plain(q, k, v, **args)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_ATOL


@pytest.mark.parametrize("kv_len", [320, 8192])
def test_decode_attention_rows_kernel_deterministic(dev, kv_len):
    """The splits merge in a fixed order: two runs give the same bits."""
    q, k, v, args = _rows_case(dev, True, kv_len)
    first = da.decode_attention_rows(q, k, v, **args)
    assert torch.equal(first, da.decode_attention_rows(q, k, v, **args))


def _chunk_case(dev, tq, tk, int8, seed=8, d=128):
    """Ragged per-row positions: row 0 starts at position 0 (its first query
    sees one key), the others end inside a key tile or at the cache's end."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h = 4, 8
    q = torch.randn(b, h, tq, d, generator=g, device=dev).to(torch.bfloat16)
    k, v, ks, vs = _cache(dev, g, b, h, tk, d, int8)
    starts = torch.tensor([0, 61, min(130, tk - tq), tk - tq], device=dev, dtype=torch.int32)
    pos = starts[:, None] + torch.arange(tq, device=dev, dtype=torch.int32)[None, :]
    return q, k, v, pos, dict(scale=d ** -0.5, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("tk", [416, 1024])
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("tq", [1, 4, 7, 15, 16, 17, 33, 64, 65, 297])
def test_prefill_attention_kernel_any_chunk(dev, tq, int8, tk):
    """Both regimes of B3 (key splits below 16 rows, tensor cores from 16)
    at the chunk lengths around their edges."""
    q, k, v, pos, args = _chunk_case(dev, tq, tk, int8)
    before = pa.counter.count
    out = pa.prefill_attention(q, k, v, pos, **args)
    assert pa.counter.count == before + 1
    ref = pa.prefill_attention_plain(q, k, v, pos, **args)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_ATOL


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("d", [40, 72])
def test_attention_kernels_narrow_heads(dev, d, int8):
    """Head dims below 128, the columns past D read as zeros: int8 rows of 40
    and 72 bytes take the element-wise staging, bf16 rows of 80 and 144
    bytes the 16-byte copies."""
    for tq in (4, 33):
        q, k, v, pos, args = _chunk_case(dev, tq, 416, int8, d=d)
        out = pa.prefill_attention(q, k, v, pos, **args)
        ref = pa.prefill_attention_plain(q, k, v, pos, **args)
        assert (out.float() - ref.float()).abs().max().item() <= BF16_ATOL, tq
    q, k, v, args = _rows_case(dev, int8, 333, d=d)
    out = da.decode_attention_rows(q, k, v, **args)
    ref = da.decode_attention_rows_plain(q, k, v, **args)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_ATOL


@pytest.mark.parametrize("tq", [4, 297])
def test_prefill_attention_kernel_deterministic(dev, tq):
    q, k, v, pos, args = _chunk_case(dev, tq, 416, True)
    first = pa.prefill_attention(q, k, v, pos, **args)
    assert torch.equal(first, pa.prefill_attention(q, k, v, pos, **args))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 224, 224, 3), (1, 5, 7, 3)])
def test_u8_normalize_kernel_bit_exact(dev, out_dtype, shape):
    g = torch.Generator(device=dev).manual_seed(6)
    img = torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)
    before = pp.counter.count
    out = pp.u8_normalize_rows(img, out_dtype=out_dtype)
    assert pp.counter.count == before + 1
    ref = pp.u8_normalize_rows_plain(img, out_dtype=out_dtype)
    assert out.dtype == out_dtype and torch.equal(out, ref)
    assert torch.equal(pp.device_preprocess(img, use_pallas=True, out_dtype=out_dtype), ref)
    assert pp.counter.count == before + 2


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_u8_normalize_kernel_every_value_and_channel(dev, out_dtype):
    """All 768 (value, channel) pairs, at each of the three positions of a
    pair in a 4-byte word (the kernel's unit)."""
    values = torch.arange(256, device=dev, dtype=torch.uint8)
    for lead in range(3):
        img = torch.cat([torch.zeros(lead, dtype=torch.uint8, device=dev),
                         values[:, None].expand(256, 3).flatten(),
                         torch.zeros(3 - lead, dtype=torch.uint8, device=dev)])
        img = img.view(-1, 3)
        out = pp.u8_normalize_rows(img, out_dtype=out_dtype)
        assert torch.equal(out, pp.u8_normalize_rows_plain(img, out_dtype=out_dtype))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [3, 12, 48, 4099 * 3, 1024 * 4 * 3 + 3, 3 << 20])
def test_u8_normalize_kernel_any_length(dev, n, out_dtype):
    """Lengths that end inside a word, a block and the grid, and one larger
    than many blocks; a non-contiguous view (the wrapper copies it)."""
    g = torch.Generator(device=dev).manual_seed(15)
    img = torch.randint(0, 256, (n // 3, 3), generator=g, device=dev, dtype=torch.uint8)
    before = pp.counter.count
    out = pp.u8_normalize_rows(img, out_dtype=out_dtype)
    assert pp.counter.count == before + 1
    assert torch.equal(out, pp.u8_normalize_rows_plain(img, out_dtype=out_dtype))
    strided = torch.randint(0, 256, (n // 3, 6), generator=g, device=dev,
                            dtype=torch.uint8)[:, ::2]
    assert torch.equal(pp.u8_normalize_rows(strided, out_dtype=out_dtype),
                       pp.u8_normalize_rows_plain(strided, out_dtype=out_dtype))
    assert torch.equal(pp.u8_normalize_rows(img, out_dtype=out_dtype), out)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("two", [False, True])
def test_stream_sum_kernel_exact(dev, dtype, two):
    """Small integers: every fp32 partial sum is exact, in any order."""
    g = torch.Generator(device=dev).manual_seed(7)
    block, rows = 64, 64 * 37
    x = torch.randint(-3, 4, (rows, bwprobe.WIDTH), generator=g, device=dev).to(dtype)
    y = torch.randint(-3, 4, (rows, bwprobe.WIDTH), generator=g, device=dev).to(dtype) \
        if two else None
    before = bwprobe.counter.count
    out = bwprobe.stream_sum(x, 2.5, block, y)
    assert bwprobe.counter.count == before + 1
    assert out.item() == bwprobe.stream_sum_plain(x, 2.5, block, y).item()
    with pytest.raises(ValueError):  # rows not a multiple of the block
        bwprobe.stream_sum(x[:rows - 1], 2.5, block)


def test_bwprobe_cli_on_the_card(dev):
    assert bwprobe.main(["--gb", "0.25", "--iters", "2", "--impl", "cuda"]) == 0
    res = bwprobe.probe(0.25, "int8", 2, "cuda2", 512, "cuda")
    assert res["gb_per_s"] > 0 and res["bytes"] == 2 * 64 * 512 * bwprobe.WIDTH



@pytest.mark.parametrize("spec_k", [0, 2])
def test_serving_engine_on_the_card(dev, spec_k):
    """A small LLaMA (two layers, head dim 128, int8 weights and KV, bf16) in
    the continuous-batching engine: six requests over four slots, two
    arrivals a tick; every request finishes, two runs of the schedule give
    the same transcripts bit for bit, and B1-B4 (B2 only without
    speculation) are launched."""
    from myriad_tpu_torch.generation import GenerationConfig
    from myriad_tpu_torch.models.layers import Policy, init_random_
    from myriad_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from myriad_tpu_torch.serving import ServingEngine

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=2, weight_dtype="int8", kv_cache_dtype="int8")
    model = LlamaForCausalLM(cfg, policy=Policy.bf16_params(), device=dev)
    g = torch.Generator(device=dev).manual_seed(13)
    init_random_(model, g, std=0.2)
    prompts = [torch.randn(n, 256, generator=g, device=dev).bfloat16()
               for n in (40, 9, 25, 60, 3, 17)]
    gen_cfg = GenerationConfig(max_new_tokens=20, eos_token_id=-1, stop_single=-1,
                               stop_pair=(-1, -1))

    def run():
        eng = ServingEngine(model, slots=4, bucket=128, config=gen_cfg, cache_dtype="int8",
                            segment=8, admit_widths=(16, 32, 64), spec_k=spec_k)
        out, queue = {}, list(enumerate(prompts))
        while queue or eng.pending:
            for _ in range(2):
                if queue:
                    i, x = queue.pop(0)
                    eng.submit(x, request_id=i)
            out.update((f.request_id, f.raw_tokens) for f in eng.step())
        return out

    counters = (quant.counter, da.counter, pa.counter, kw.counter)
    before = [c.count for c in counters]
    first = run()
    launched = [c.count - b for c, b in zip(counters, before)]
    assert sorted(first) == list(range(6))
    assert all(len(t) == 20 and ((t >= 0) & (t < 256)).all() for t in first.values())
    assert launched[0] > 0 and launched[2] > 0 and launched[3] > 0
    assert (launched[1] > 0) == (spec_k == 0)
    again = run()
    assert all(torch.equal(torch.from_numpy(first[i]), torch.from_numpy(again[i]))
               for i in first)


# -- the fp32-output mode of B1 and B5 (row-parallel shards) ------------------------
# Vicuna-7B's projections cut over 2 and 4 ranks: the row-parallel shapes
# (o: 2048 / 1024 -> 4096, down: 5504 / 2752 -> 4096) write fp32 partials;
# the column-parallel ones (q/k/v 4096 -> 2048 / 1024, gate/up 4096 -> 5504 /
# 2752) keep the bf16 mode.
ROW_SHAPES = [(2048, 4096), (1024, 4096), (5504, 4096), (2752, 4096)]
COLUMN_SHAPES = [(4096, 2048), (4096, 1024), (4096, 5504), (4096, 2752)]


def _abs_sum(x, w, scale=None):
    """|x| @ |W| (x |scale|): the scale of an fp32 sum's rounding error."""
    out = x.abs().float() @ w.abs().float()
    return out if scale is None else out * scale.abs()


@pytest.mark.parametrize("k,n", ROW_SHAPES + COLUMN_SHAPES)
@pytest.mark.parametrize("m", [8, 32])
def test_int8_matmul_fp32_out_matches_plain(dev, m, k, n):
    """The fp32-output mode against the plain version's fp32 (x @ W) x scale:
    the same products, fp32 sums in another order (2^-14 of the sum of
    |terms|); its bf16 rounding is the bf16 mode's output bit for bit (one
    body, one value, one rounding)."""
    w8, scale = _int8_weight(k, n)
    x = torch.randn(m, k, generator=torch.Generator(device=dev).manual_seed(m), device=dev)
    x = x.to(torch.bfloat16)
    before = quant.counter.count
    out = quant.int8_weight_only_matmul(x, w8, scale, out_dtype=torch.float32)
    assert quant.counter.count == before + 1
    ref = quant.int8_weight_only_matmul_plain(x, w8, scale, out_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    tol = 2.0 ** -14 * _abs_sum(x, w8, scale).max().item()
    assert (out - ref).abs().max().item() <= tol
    assert torch.equal(out.to(torch.bfloat16), quant.int8_weight_only_matmul(x, w8, scale))


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("k", [4096, 11008])
def test_int8_matmul_fp32_partials_sum_to_the_whole(dev, k, ranks):
    """A row-parallel projection's shards: the fp32 partials of every
    rank's rows, summed, give the unsharded fp32 product up to the sums'
    order, and one rounding of that sum is the unsharded bf16 output but
    where the order moves a value across a rounding boundary."""
    w8, scale = _int8_weight(k, 4096)
    x = torch.randn(8, k, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    x = x.to(torch.bfloat16)
    w = k // ranks
    parts = [quant.int8_weight_only_matmul(x[:, r * w:(r + 1) * w].contiguous(),
                                           w8[r * w:(r + 1) * w].contiguous(), scale,
                                           out_dtype=torch.float32) for r in range(ranks)]
    whole = quant.int8_weight_only_matmul(x, w8, scale, out_dtype=torch.float32)
    total = functools.reduce(torch.add, parts)
    assert (total - whole).abs().max().item() <= 2.0 ** -14 * _abs_sum(x, w8, scale).max().item()
    same = (total.to(torch.bfloat16) == whole.to(torch.bfloat16)).float().mean().item()
    assert same >= 0.99


@pytest.mark.parametrize("k,n", [(2048, 4096), (5504, 4096), (4096, 2048), (4096, 5504)])
@pytest.mark.parametrize("m", [8, 32])
def test_int4_matmul_fp32_out_matches_plain(dev, m, k, n):
    """B5's fp32-output mode at the two-rank shapes (5504 = 43 groups of
    128): against the plain version's fp32 sum, and its bf16 rounding equal
    to the bf16 mode's output bit for bit."""
    w4, s4 = _int4_weight(k, n)
    x = torch.randn(m, k, generator=torch.Generator(device=dev).manual_seed(m), device=dev)
    x = x.to(torch.bfloat16)
    before = quant.counter4.count
    out = quant.int4_weight_only_matmul(x, w4, s4, out_dtype=torch.float32)
    assert quant.counter4.count == before + 1
    ref = quant.int4_weight_only_matmul_plain(x, w4, s4, out_dtype=torch.float32)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    tol = 2.0 ** -14 * _abs_sum(x, quant.dequant_int4(w4, s4)).max().item()
    assert (out - ref).abs().max().item() <= tol
    assert torch.equal(out.to(torch.bfloat16), quant.int4_weight_only_matmul(x, w4, s4))


def _int4_shard(dev, k, n, group, goff, seed=7):
    """A row shard's random int4 rows (every nibble value) and the scale rows
    that its rows from offset ``goff`` touch (several binades)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w4 = torch.randint(0, 256, (k // 2, n), generator=g, device=dev, dtype=torch.uint8)
    s4 = torch.exp(torch.randn(-(-(goff + k) // group), n, generator=g, device=dev) * 3) * 0.01
    return w4, s4


# (K, N, group offset): Vicuna-7B's down over 4 ranks (2752 rows, 21.5 groups
# of 128: a partial last group from offset 0, a partial first group from 64),
# over 8 (1376 from 32: both partial), and a small shard that starts and ends
# inside groups at an N the tensor copies do not take (40)
INT4_SHARDS = [(2752, 4096, 0), (2752, 4096, 64), (1376, 4096, 32), (200, 40, 96)]


@pytest.mark.parametrize("k,n,goff", INT4_SHARDS)
@pytest.mark.parametrize("m", [1, 8, 32])
def test_int4_matmul_group_offset_matches_plain(dev, m, k, n, goff):
    """B5 on a row shard whose rows start ``goff`` rows into a group of 128:
    one-hot rows of x make every output one dequantized weight element, so
    each row's scale row is checked bit for bit against the plain version;
    random rows within one bf16 rounding, in both output modes."""
    w4, s4 = _int4_shard(dev, k, n, 128, goff)
    g = torch.Generator(device=dev).manual_seed(m)
    pick = torch.randint(0, k, (m,), generator=g, device=dev)
    onehot = torch.zeros(m, k, device=dev, dtype=torch.bfloat16)
    onehot[torch.arange(m, device=dev), pick] = 1.0
    kw = dict(goff=goff, group=128)
    assert torch.equal(quant.int4_weight_only_matmul(onehot, w4, s4, **kw),
                       quant.int4_weight_only_matmul_plain(onehot, w4, s4, **kw))
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16) * 0.1
    before = quant.counter4.count
    out = quant.int4_weight_only_matmul(x, w4, s4, **kw)
    f32 = quant.int4_weight_only_matmul(x, w4, s4, out_dtype=torch.float32, **kw)
    assert quant.counter4.count == before + 2
    ref = quant.int4_weight_only_matmul_plain(x, w4, s4, out_dtype=torch.float32, **kw)
    assert (out.float() - ref).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()
    tol = 2.0 ** -14 * _abs_sum(x, quant.dequant_int4(w4, s4, **kw)).max().item()
    assert (f32 - ref).abs().max().item() <= tol
    assert torch.equal(f32.to(torch.bfloat16), out)


@pytest.mark.parametrize("ranks", [4, 8])
def test_int4_matmul_row_shards_that_split_groups_sum_to_the_whole(dev, ranks):
    """Vicuna-7B's down (11008 -> 4096, 86 groups of 128) over 4 and 8
    ranks, each shard's scale rows a view of the whole scale4 from
    ``int4_row_groups``: the fp32 partials sum to the unsharded fp32 product
    up to the sums' order."""
    from myriad_tpu_torch.parallel.mesh import Mesh

    w4, s4 = _int4_weight(11008, 4096)
    x = torch.randn(8, 11008, generator=torch.Generator(device=dev).manual_seed(9), device=dev)
    x = x.to(torch.bfloat16)
    kl = 11008 // ranks
    total = torch.zeros(8, 4096, device=dev)
    for r in range(ranks):
        view, goff, group = quant.int4_row_groups(s4, kl, Mesh(n_model=ranks, model_rank=r))
        total += quant.int4_weight_only_matmul(
            x[:, r * kl:(r + 1) * kl].contiguous(), w4[r * kl // 2:(r + 1) * kl // 2], view,
            out_dtype=torch.float32, goff=goff, group=group)
    whole = quant.int4_weight_only_matmul(x, w4, s4, out_dtype=torch.float32)
    tol = 2.0 ** -14 * _abs_sum(x, quant.dequant_int4(w4, s4)).max().item()
    assert (total - whole).abs().max().item() <= tol


def test_int4_matmul_launch_plan_with_a_group_offset(dev):
    """Stages of 128 rows lie in one group (the uniform path: the scale row
    comes with the stage) from a whole stage's offset; from any other
    offset, or with a group that splits stages, the scales are looked up."""
    for k, n, group, goff, uniform in ((2752, 4096, 128, 0, True), (2752, 4096, 128, 64, False),
                                       (1376, 4096, 128, 32, False), (4096, 11008, 128, 0, True),
                                       (1000, 40, 1000, 0, True), (1000, 40, 40, 0, False),
                                       (200, 40, 128, 96, False)):
        plan = quant.int4_launch(8, k, n, group, goff)
        assert plan["uniform"] is uniform, (k, n, group, goff)
        assert plan["tiles"] == -(-n // 128)


def test_int4_matmul_refuses_an_offset_its_groups_do_not_cover(dev):
    w4, s4 = _int4_shard(dev, 192, 64, 128, 64)  # 2 scale rows cover offsets 0-64
    x = torch.zeros(8, 192, dtype=torch.bfloat16, device=dev)
    quant.int4_weight_only_matmul(x, w4, s4, goff=64, group=128)
    for goff, group in ((66, 128), (63, 128), (128, 128), (0, 64)):
        with pytest.raises(ValueError, match="cover"):
            quant.int4_weight_only_matmul(x, w4, s4, goff=goff, group=group)


def test_fp32_out_refuses_other_dtypes(dev):
    w8, scale = _int8_weight(4096, 4096)
    x = torch.zeros(8, 4096, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        quant.int8_weight_only_matmul(x, w8, scale, out_dtype=torch.float16)
