#!/usr/bin/env python3
"""Drive the PyTorch port's AQA serving path once on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing its own lines:

1. build the CUDA kernels (myriad_tpu_torch/csrc, nvcc, sm_90a) from the
   checkout and print the build time;
2. hold each kernel on the main path (B1 int8 weight-only matmul, B2 decode
   attention, B3 prefill attention) against its plain PyTorch version on
   the card, at the main path's shapes, with the stated tolerance, and time
   both (CUDA events around 10 back-to-back calls, median of 21 such runs,
   after warm-up);
3. build Myriad at full width (EVA-ViT-g, Q-Former, ImageBind-huge,
   Vicuna-7B with int8 weights and an int8 KV cache, towers in bf16) with
   random weights drawn from --seed on the card, and run ``generate``
   (zero-shot maps, greedy, 90 new tokens) on 8 uint8 224x224 images and the
   AQA question; check the tokens, the maps and that every kernel of the path
   was launched; compare the prefill logits with the plain path's.

The last two lines are a JSON summary of the kernels and the
``{"ok": true, "device": ...}`` result.  Any failed check exits non-zero
before them.  Without a CUDA card, or outside a checkout of the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# the real AQA question (myriad_tpu/datasets/anomaly_detection.py
# QUESTION_PROMPTS[1]; that module imports cv2)
AQA_QUESTION = ("<Img><ImageHere></Img>This image may be simulated by photo editing. "
                "According to IAD expert opinions and corresponding visual descriptions, "
                "find out if there are defects in this image.")
SCENES = ["bottle", "cable", "capsule", "hazelnut"]
BATCH = 8
NEW_TOKENS = 90


def _time_ms(fn, launches: int = 10, repeats: int = 21) -> float:
    """Device time of one call: CUDA events around ``launches`` back-to-back
    calls (the host runs ahead, so launch gaps do not count), median over
    ``repeats`` after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def check(cond, what) -> None:
    """A failed check ends the run with a non-zero exit and no result line."""
    if not cond:
        raise AssertionError(what)


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


class Check:
    """One kernel's comparisons with its plain version."""

    def __init__(self, name, source, replaces, counter):
        self.name, self.source, self.replaces, self.counter = name, source, replaces, counter
        self.max_err = 0.0
        self.ms = self.plain_ms = self.launches = None

    def compare(self, label, kernel, plain, tol_of, main_shape=False):
        """Check the kernel against its plain version and time both; the
        main path's shape supplies the times of the JSON summary."""
        import torch

        out = kernel()
        ref = plain()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tol_of(ref)
        ok = bool(torch.isfinite(out.float()).all()) and err <= tol
        self.max_err = max(self.max_err, err)
        ms, plain_ms = _time_ms(kernel), _time_ms(plain)
        if main_shape:
            self.ms, self.plain_ms = ms, plain_ms
        print(f"  {self.name} {label}: max_abs_err={err:.3e} tol={tol:.3e} kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f}" + ("" if ok else "  FAILED"), flush=True)
        check(ok, f"{self.name} {label}: kernel disagrees with its plain version")

    def record(self):
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": self.launches,
                "max_abs_err": self.max_err, "ms": self.ms, "plain_ms": self.plain_ms}


def kernel_checks(dev, seed):
    """Phase 2: each kernel against its plain version at the main path's shapes."""
    import torch

    from myriad_tpu_torch.models.llama import quantize_kv
    from myriad_tpu_torch.ops import decode_attention as da
    from myriad_tpu_torch.ops import prefill_attention as pa
    from myriad_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    b1 = Check("B1 int8_matmul", "myriad_tpu_torch/csrc/int8_matmul.cu",
               "myriad_tpu/ops/quant.py:73", quant.counter)
    b2 = Check("B2 decode_attention", "myriad_tpu_torch/csrc/decode_attention.cu",
               "myriad_tpu/ops/decode_attention.py:31", da.counter)
    b3 = Check("B3 prefill_attention", "myriad_tpu_torch/csrc/prefill_attention.cu",
               "myriad_tpu/ops/prefill_attention.py:37", pa.counter)

    # B1: a bf16 output differs by at most one rounding of its largest value
    print("B1: tolerance 2^-7 * max|plain| (one bf16 ulp at the largest output)")
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
        w8, scale = quant.quantize_per_channel(randn(k, n) * 0.02)
        for m in (1, 8, 48):
            x = randn(m, k, dtype=bf16)
            b1.compare(f"M={m} {k}x{n}", lambda: quant.int8_weight_only_matmul(x, w8, scale),
                       lambda: quant.int8_weight_only_matmul_plain(x, w8, scale),
                       lambda ref: 2.0 ** -7 * ref.float().abs().max().item(),
                       main_shape=(m == BATCH and (k, n) == (4096, 11008)))

    b, h, t, d = BATCH, 32, 416, 128
    kv_len, frontier = 320, 300
    print("B2/B3: tolerance 2e-2 absolute (bf16 probabilities and outputs; |out| <~ 3)")
    q1 = randn(b, h, 1, d, dtype=bf16)
    kf, vf = randn(b, h, t, d), randn(b, h, t, d)
    k8, ks = quantize_kv(kf)
    v8, vs = quantize_kv(vf)
    ks, vs = ks.half(), vs.half()
    kbf, vbf = kf.to(bf16), vf.to(bf16)
    kpos = torch.arange(kv_len, device=dev)
    mask = torch.where(kpos <= frontier, 0.0, -1e9).float()[None, None, None].expand(
        b, 1, 1, kv_len).contiguous()
    for label, kk, vv, kss, vss in (("int8", k8, v8, ks, vs), ("bf16", kbf, vbf, None, None)):
        args = dict(mask=mask, scale=d ** -0.5, k_scale=kss, v_scale=vss, kv_len=kv_len)
        b2.compare(f"{label} B={b} H={h} T={t} kv_len={kv_len} D={d}",
                   lambda: da.decode_attention(q1, kk, vv, **args),
                   lambda: da.decode_attention_plain(q1, kk, vv, **args),
                   lambda ref: 2e-2, main_shape=(label == "int8"))

    for tq, offset in ((297, 0), (33, 264), (7, 290)):
        qq = randn(b, h, tq, d, dtype=bf16)
        pos = (offset + torch.arange(tq, device=dev, dtype=torch.int32))[None].expand(b, tq)
        for label, kk, vv, kss, vss in (("int8", k8, v8, ks, vs),
                                        ("bf16", kbf, vbf, None, None)):
            args = dict(scale=d ** -0.5, k_scale=kss, v_scale=vss)
            b3.compare(f"{label} tq={tq} offset={offset} Tk={t}",
                       lambda: pa.prefill_attention(qq, kk, vv, pos, **args),
                       lambda: pa.prefill_attention_plain(qq, kk, vv, pos, **args),
                       lambda ref: 2e-2, main_shape=(label == "int8" and tq == 297))
    return [b1, b2, b3]


class plain_path:
    """Route the three kernel wrappers to their plain versions while active, so
    the full-width model can be run once as the kernels' reference."""

    def __enter__(self):
        from myriad_tpu_torch.ops import decode_attention as da
        from myriad_tpu_torch.ops import prefill_attention as pa
        from myriad_tpu_torch.ops import quant

        swaps = [(quant, "int8_weight_only_matmul", quant.int8_weight_only_matmul_plain),
                 (da, "decode_attention", da.decode_attention_plain),
                 (pa, "prefill_attention", pa.prefill_attention_plain)]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, plain in swaps:
            setattr(mod, name, plain)

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def full_slice(dev, seed, checks, card):
    """Phase 3: the full-width main path through Myriad.generate."""
    import numpy as np
    import torch

    from myriad_tpu_torch.generation import GenerationConfig, _prefill
    from myriad_tpu_torch.models.llama import init_cache, serving_cache_dtype
    from myriad_tpu_torch.models.myriad import Myriad

    t0 = time.time()
    model = Myriad.from_config({"arch_preset": "full", "llm_weight_dtype": "int8",
                                "llm_kv_dtype": "int8"}, device=dev, class_names=SCENES)
    model.init_random(seed)
    model.vision_expert.build_text_features()
    torch.cuda.synchronize()
    print(f"full-width Myriad built with random weights (seed {seed}) in "
          f"{time.time() - t0:.1f} s; text features for {SCENES}", flush=True)

    rng = np.random.default_rng(seed)
    size = model.arch.img_size
    samples = {"image": rng.integers(0, 256, size=(BATCH, size, size, 3), dtype=np.uint8),
               "scene": [SCENES[i % len(SCENES)] for i in range(BATCH)],
               "question2": [AQA_QUESTION] * BATCH}
    model.generate(samples, max_new_tokens=4)  # warm-up (cuBLAS/cuDNN set-up)

    for c in checks:
        c.counter.count = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for run in range(3):  # the first run is the counted main-path run
        t0 = time.perf_counter()
        res = model.generate(samples, max_new_tokens=NEW_TOKENS)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            out = res
            for c in checks:
                c.launches = c.counter.count
    launches = {c.name: c.launches for c in checks}
    peak = torch.cuda.max_memory_allocated(dev)
    wall = statistics.median(walls)

    tokens, maps = out["token_ids"], out["ve_anomaly_maps"]
    vocab = model.arch.llama.vocab_size
    cfg = GenerationConfig()
    check(tuple(tokens.shape) == (BATCH, NEW_TOKENS), tokens.shape)
    check(bool(((tokens >= 0) & (tokens < vocab)).all()), "token id out of range")
    # a stop id is never emitted: the step that produces it marks the row done
    # and the row emits pad from then on (tests/test_torch_llama.py pins the rest)
    for row in tokens.tolist():
        check(cfg.eos_token_id not in row and cfg.stop_single not in row,
              "a single stop id was emitted instead of pad")
        check(not any(a == cfg.stop_pair[0] and b == cfg.stop_pair[1]
                      for a, b in zip(row, row[1:])), "the '###' pair was emitted")
    ms = model.arch.map_size
    check(tuple(maps.shape) == (BATCH, ms, ms, 1), maps.shape)
    check(bool(torch.isfinite(maps).all()), "non-finite anomaly map")
    check(float(maps.min()) >= 0.0 and float(maps.max()) <= 1.0, "map outside [0, 1]")
    print(f"generate: tokens {tuple(tokens.shape)} in [0, {vocab}); maps "
          f"{tuple(maps.shape)} in [{float(maps.min()):.4f}, {float(maps.max()):.4f}]")
    print(f"kernel launches in the generate run: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    print(f"throughput: {BATCH / wall:.4f} images/s, median of 3 runs ({BATCH} images, "
          f"{NEW_TOKENS} new tokens; wall s {', '.join(f'{w:.3f}' for w in walls)}, host "
          f"clock after synchronize); peak device memory {peak / 2**30:.2f} GiB; "
          f"card: {card}", flush=True)

    # the kernels' path against the plain path at full width
    with torch.inference_mode():
        def timed(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return res, time.perf_counter() - t

        image = torch.as_tensor(samples["image"], device=dev)
        ve = model.vision_expert
        (maps_k, _), t_ve = timed(lambda: ve.module.zero_shot(
            image, ve._text_feats[ve.scene_ids(samples["scene"])]))
        before, after = model.split_prompt(AQA_QUESTION)
        embeds, t_enc = timed(lambda: model.module.prefill_embeds(
            image, maps_k, before, after, 1, add_bos=False))
        p = embeds.shape[1]
        llama = model.module.llama
        cache_dtype = serving_cache_dtype(model.arch.llama, model.policy.compute_dtype)
        cache = init_cache(llama.config, BATCH, p + NEW_TOKENS, cache_dtype, dev)
        _, t_pre = timed(lambda: _prefill(llama, embeds, cache, 1))
        print(f"stage times (host clock, synchronized, one run each): VE maps {t_ve:.4f} s, "
              f"encode_img + prefix {t_enc:.4f} s, prefill {t_pre:.4f} s, decode loop "
              f"(the rest of the median generate) ~{wall - t_ve - t_enc - t_pre:.4f} s")
        # The int8 path is sensitive by nature: W8A8 re-quantizes every
        # activation row, so a one-ulp change anywhere can flip int8 roundings
        # downstream, and random weights amplify it over 32 layers.  The
        # kernels are therefore held to the plain path's own sensitivity: their
        # logits may move at most twice as far (relative L2) as the plain
        # path's do when its prefix embeddings take N(0, 2^-9) relative noise
        # and are re-rounded to bf16.
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        noise = torch.randn(embeds.shape, generator=g, device=dev) * 2.0 ** -9
        noisy = (embeds.float() * (1.0 + noise)).to(embeds.dtype)

        def prefill(x, chunks):
            cache = init_cache(llama.config, BATCH, p + NEW_TOKENS, cache_dtype, dev)
            return _prefill(llama, x, cache, chunks)[:, -1].float()

        def rel(a, b):
            return ((a - b).norm() / b.norm()).item()

        for label, chunks in (("1 chunk", 1), ("10 chunks", 10)):
            kern = prefill(embeds, chunks)
            with plain_path():
                plain, plain_noisy = prefill(embeds, chunks), prefill(noisy, chunks)
            err, floor = rel(kern, plain), rel(plain_noisy, plain)
            agree = (kern.argmax(-1) == plain.argmax(-1)).float().mean().item()
            print(f"prefill logits ({p} positions, {label}): kernels vs plain rel_l2="
                  f"{err:.4e} max_abs_err={(kern - plain).abs().max().item():.4e}; plain "
                  f"vs plain with noisy input rel_l2={floor:.4e}; tol=2x that; argmax "
                  f"agreement {agree:.3f}")
            check(bool(torch.isfinite(kern).all()), "non-finite prefill logits")
            check(err <= 2.0 * floor, "prefill logits: kernels disagree with the plain path")
        with plain_path():
            plain_tokens, t_plain = timed(
                lambda: model.generate(samples, max_new_tokens=NEW_TOKENS)["token_ids"])
    same = (plain_tokens == tokens).float().mean().item()
    print(f"plain path (no kernels) generate: {BATCH / t_plain:.4f} images/s ({t_plain:.3f} s, "
          f"one run) against the kernels' {BATCH / wall:.4f}")
    print(f"greedy tokens identical to the plain path's: {same:.4f} of {tokens.numel()} "
          f"(reported, not required: random weights leave thin argmax margins)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "myriad_tpu_torch", "csrc")):
        print(f"chip_smoke: {REPO} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off for matmul and "
          f"cuDNN convolutions (cuDNN convs default to TF32)", flush=True)

    from myriad_tpu_torch.ops import _cuda

    t0 = time.time()
    lib_path = _cuda.build()
    _cuda.library()
    print(f"phase 1: kernels built in {time.time() - t0:.1f} s", flush=True)
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas: " + line.split("ptxas info    : ")[-1].strip())

    print("phase 2: kernels against their plain versions", flush=True)
    checks = kernel_checks(dev, args.seed)
    card = _card()
    print("phase 3: full-width Myriad.generate", flush=True)
    full_slice(dev, args.seed, checks, card)
    print(card)
    print(json.dumps({"kernels": [c.record() for c in checks]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
