#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths once on one CUDA card.

    python3 chip_smoke.py [--seed N] [--parent DIR [--parent-kernels B4,B6]]

Phases, each printing its own lines:

1. build the CUDA kernels (myriad_tpu_torch/csrc, one nvcc per source, all
   started together, sm_90a) from the checkout, print the build time and
   each kernel's registers, count the tensor-core instructions (HMMA)
   in B1's, B3's and B5's tensor-core kernels with ``cuobjdump -sass``, and
   report B1's, B2's and B5's cluster launches at the paths' shapes
   (registers, splits, shared memory, how many clusters the card holds at
   once, and for B1 how many blocks an SM holds);
2. hold each kernel of the paths (B1 int8 weight-only matmul, B2 decode
   attention, B3 prefill attention, B4 KV-cache write, B5 int4 weight-only
   matmul, B2' row decode attention, B6 uint8 normalise, B7 streaming sum)
   against its plain PyTorch version on the card, at the paths' shapes, with
   the stated tolerance (B2 also at kv_len 333, at batch 1 at a chat turn's
   kv_len, and at kv_len 8192 at batch 8 and 1; B2' also at kv_len 333 and
   8192; B2, B2' and B3 run twice and must give the same bits), and time
   both, with one PyTorch library call that computes the same function
   where there is one: device time (10 calls
   captured in a CUDA graph, replayed under CUDA events, median of 21
   replays), and the kernel's eager time per call (CUDA events around 10
   back-to-back calls, median of 21), which is the host's time where that is
   the longer; B7's times give the card's measured streaming bandwidth, and
   every bound is printed again at that rate.  B3's speculative verify chunk
   (4 rows, ragged positions), B1 and B5 at 8 and 32 rows at each of the
   three projection shapes (and run twice, the same bits), B1 at a chat
   turn's 132-row delta prefill and at the int8 Q-Former's three shapes at
   81 rows (a chat upload's query stream), B2 and B2' at kv_len 8192, B4's copy (with
   an indexed assignment as its library call), B4's quantize-and-write at a
   greedy and a chat decode step, a prefill chunk and its launch floor (one
   row of 8), and B6 to bf16 are path shapes of their own, with their times
   and bounds under ``shapes`` in the summary; so are the serving engine's
   decode step's B2 (kv_len 416, eight rows masked at frontiers spread over
   64-410; library: SDPA with the same boolean mask) and B4 (t = 1 at those
   eight per-row starts);
3. build Myriad at full width (EVA-ViT-g, Q-Former, ImageBind-huge,
   Vicuna-7B with int8 weights and an int8 KV cache, towers in bf16) with
   random weights drawn from --seed on the card, and run ``generate``
   (zero-shot maps, greedy, 90 new tokens) on 8 uint8 224x224 images and the
   AQA question; check the tokens, the maps and that every kernel of the path
   was launched; compare the prefill logits with the plain path's; profile
   one more generate (device time by kernel, the device's busy share);
4. speculative generate at full width (``llm_spec_k`` = 3, batch 8, 90 new
   tokens): with the prompt-lookup drafts through ``Myriad.generate``, with
   the greedy transcript of phase 3 as oracle drafts, and with the lookup
   run's own transcript as oracle drafts (the acceptance ceiling); gate the
   first verify round's logits against the plain path's;
5. chat at full width (batch 1, three scripted turns, the resident cache),
   with and without speculative decoding; gate turn 2's delta-prefill logits
   against a full re-prefill of the same prompt; then run one more
   speculative generate (prompt-lookup drafts) under ``torch.profiler`` and
   print its device time by kernel and the device's busy share;
6. free that model and build Myriad with int4 LLM weights
   (``llm_weight_dtype: int4``) at full width: greedy generate (batch 8, 90
   tokens, median of 3), one speculative generate (K = 3, prompt-lookup
   drafts) and one chat turn, each through kernel B5 and never B1; profile
   one greedy and one speculative generate and print the stage times; gate
   the first prefill's logits against the plain path's;
7. the opt-in entry points: ``MYRIAD_DECODE_ATTN=row`` greedy generate
   (kernel B2', never B2; the first decode step's logits gated against the
   plain path's), ``device_preprocess(use_pallas=True)`` on the batch's
   images (kernel B6) and the bandwidth probe's CLI
   (``myriad_tpu_torch.tools.bwprobe``, kernel B7, 4 GiB a pass);
8. free that model and run the AQA evaluation entry point
   (``myriad_tpu_torch.evaluate``) in process over a synthetic MVTec-style
   test tree written under build/ (24 PNGs with every row filter: 12 RGB
   900x900 and 12 gray 1024x1024, half of each anomalous, two classes):
   ``eval_configs/myriad.yaml`` at full width with int8 LLM weights and an int8
   KV cache, random weights, ``--bs 8 --greedy --bench``, 90 new tokens; check
   24 rows with the harness's schema, each row's tokens identical to a direct
   ``Myriad.generate`` on the same collated batch, and B1-B4 launched; print
   the ``--bench`` line, its phase means, the PNG decode and resize time per
   image on this host and the peak device memory;
9. on phase 8's model, the continuous-batching engine
   (``myriad_tpu_torch.serving``): (a) 24 requests over 8 slots, four
   arrivals a tick, segment 32, the eval's 297-position prefixes and the
   same cut to 120 and 50 (widths 320, 160 and 64 admit): every request
   finishes, a second run gives the same transcripts bit for bit, B1-B4's
   launches equal what the admission chunks and decode steps imply, and the
   first decode step after a mixed admission is gated against the plain
   path; (b) the same load with K = 3 and the AQA answer corpus as the
   lookup; (c) two held conversations through ``MyriadServing``, a second
   turn each, the frontier after it checked; (d) ``evaluate.run`` with
   ``--engine`` over phase 8's tree: 24 rows and the ``--bench`` line,
   images/s printed beside phase 8's;
11. on phase 8's model, before phase 10 frees it, the vision-expert family:
   (a) ``evaluate.run`` with ``--k_shot 1`` and ``--k_shot 4`` over phase 8's
   tree, whose classes hold 4 and 2 ``train/good`` PNGs (the one-shot
   references; screw's bank is zero-padded at 4): 24 rows each, every row's
   tokens identical to a direct ``Myriad.generate`` with the same bank, the
   served maps the one-shot maps and not the zero-shot ones, every kernel
   launched exactly as often as on phase 8's run, the ``--bench`` line beside
   phase 8's and the bank's build time; (e) ``--engine`` at ``--k_shot 1``:
   launches equal to phase 9's ``--engine`` run's, anomaly scores equal to
   the fixed batches' one-shot ones, outputs compared (reported); (b) the
   ``aprilgan`` expert over mask PNGs written under build/: maps equal to the
   masks resized on the host (difference 0); (c) the ``simplenet`` expert at
   full width (WideResNet-50-2 with seeded random weights, two head npz files
   under build/), called with TF32 on for cuDNN and cuBLAS (it pins fp32
   itself): maps within 1e-4 of the largest against the same expert on the
   CPU in fp32, the expert's time per batch of 8, and what TF32 would move
   the unpinned trunk by (reported); (d) ``adgpt`` (the zero-shot maps, the
   fused generate's tokens) and no expert (zero maps, what ``use_ve: False``
   serves); each generate launching every kernel a third as often as phase
   8's three batches;
10. free that model and train: ``python -m myriad_tpu_torch.train``'s runner
   (``train.build`` and ``runner.train``, ``train.main``'s body) in process on
   ``train_configs/loraadapter_simple_myriad_finetune.yaml`` at full width
   (float Vicuna-7B with LoRA, towers frozen, random weights) over a synthetic
   MVTec train tree under build/ (16 good PNGs, RGB 900x900 and gray
   1024x1024), 2 epochs x 3 steps of 2 images and their 2 NSA twins, 4 loader
   threads, a ring of 1: every loss finite, every frozen tensor bit-identical
   afterwards and without a gradient, every trainable changed; the ring one
   Orbax directory, ``checkpoint_1``, in the JAX runner's layout (the
   trainables as the JAX tree, the optax state, 0-d int64 epoch and step),
   its seconds to write and read and its bytes on disk, with the bytes and
   decoding seconds a JAX-written ring of the same state would take
   (projected from phase 14); a resume from it that restores the trainables
   and Adam's moments bit for bit and continues the step; (c) the trained
   model's greedy generate (batch 8) with its trainables at their initial
   values (16 tokens), then (90 tokens) with the ring merged by
   ``Myriad.load_checkpoint`` (the ``ckpt:`` route): the trainables
   bit-equal to the saved ones, the tokens different, B2, B3 and B4
   launched as the decode steps and prefill chunks imply (bf16 weights: no
   B1); one more step timed by phase (CUDA events)
   with one AdamW update recomputed in fp64, one under ``torch.profiler``
   (top 10 ops by device time), the host's NSA time per twin; then one step
   with int8 LLM weights: W8A8 on ``torch._int_mm`` at every projection, the
   straight-through backward reaching ``expert_adaptor`` across 32 layers,
   one projection's dx against dy @ dequant(W)^T in fp32 (2e-2, bf16);
12. between phases 11 and 10, once phase 8's model is freed: the TPU
   harness's profile (the ``--options`` of ``BENCH_r05.json``'s harness
   command: EVA, Q-Former and ImageBind in int8, int8 LLM weights and KV, 9
   prefill chunks, staged decode) at full width, random weights from --seed
   but for the Q-Former, ``llama_proj`` and the decoder, written as fp32 npz
   under build/ and served through ``weights:`` (quantized on load: no leaf
   missing, every Q-Former payload equal to the npz quantized on the host):
   (b) ``evaluate.run`` over phase 8's tree at phase 8's batch (rows, tokens
   identical to a direct generate, the ``--bench`` line beside phase 8's);
   (c) one generate at the harness's batch of 48 (images/s, median of 3
   after a warm-up, peak memory); (d) a batch-1 chat: the upload's B1
   launches (the Q-Former) and ``torch._int_mm`` calls (EVA, ImageBind, the
   cross-attention's keys and values) equal to the counts the architecture
   gives, ``encode_img`` gated against the plain path, one turn; (e) top-p
   0.9 sampling: a generate (one seed) and a chat turn, each twice,
   identical, and a one-token nucleus equal to the argmax;
13. between phases 12 and 10: the reference's own checkpoint files, written
   from --seed under a temporary directory of build/ (LAVIS
   ``eva_vit_g.pth`` and ``imagebind_huge.pth`` in fp16, the BLIP-2
   Q-Former, MiniGPT-4's ``llama_proj`` and the AnomalyGPT decoder in fp32,
   a bf16 ``checkpoint_1.pth`` of the trainables, and a Vicuna directory of
   fp16 ``*.safetensors`` shards, full width but 2 of its 32 layers (EVA
   at 4 of its 39 blocks), with a 32000-piece ``tokenizer.model``),
   converted by ``python -m
   myriad_tpu_torch.tools.convert_weights all`` and served by
   ``Myriad.from_config`` through the ``weights.yaml`` it writes, ``ckpt:``
   and ``llama_model``: every loaded leaf bit-equal to converting the
   in-memory state dicts (the LLaMA quantized to int8), nothing missing but
   the cut layers, a greedy generate (batch 8, 90 tokens) launching B1-B4
   whose tokens differ from the same seed's model without the files, and the
   prompt's ids surviving decode and re-encode; prints the seconds spent
   writing, converting, loading and generating, the npz bytes and images/s;
14. before phase 10: build the port's zstd decoder (``csrc/zstd_decode.cpp``)
   with this machine's host C++ compiler, restore the committed
   ``tests/orbax_fixture`` ring (written by the JAX package: OCDBT, zstd
   chunks) through the port's own reader and hold every leaf's dtype, shape
   and sha256 and every libzstd frame's decoded sha256 to its
   ``expected.json``; the decoder's MB/s over the fixture's frames repeated
   to 256 MB.

With ``--parent DIR`` (a checkout of another tree, such as the parent
commit's), phase 1 also builds DIR's kernels, compares their SASS with this
tree's function by function, and runs phase 2's checks of the kernels that
``--parent-kernels`` names (all by default) on DIR's package and this
tree's in turns (parent, change, change, parent).

Each path is driven with every launch count set to 0 just before it and read
just after.  The last two lines are a JSON summary of the kernels and the
``{"ok": true, "device": ...}`` result.  Any failed check exits non-zero
before them.  Without a CUDA card, or outside a checkout of the repository,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import functools
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
# the serving profile of eval_configs/myriad.yaml that Myriad.from_config reads
SERVING = {"arch_preset": "full", "llm_weight_dtype": "int8", "llm_kv_dtype": "int8",
           "end_sym": "###"}
SPEC_K = 3
VERIFY_ROWS = BATCH * (SPEC_K + 1)  # rows of a verify round's projections
CHAT_KV_LEN = 512  # a chat turn's decode reads its 256-position cache bucket
CHAT_DELTA_ROWS = 132  # rows of a chat turn's delta prefill at batch 1 (turn 2)
CHAT_QUESTIONS = ["Is there any defect in this image?", "Where is it?",
                  "How severe is it, and what caused it?"]
CHAT_TOKENS = 32
PROBE_GIB = 4  # B7's operand, GiB: well past the 50 MB L2
# the Q-Former's query stream at a batch-1 chat upload: 32 queries and 49
# VEInstructor tokens, the rows of B1 at its three projection shapes
QFORMER_ROWS = 81
QFORMER_SHAPES = ((768, 768), (768, 3072), (3072, 768))
# published H100 SXM peaks (NVIDIA data sheet, dense) for the bounds
PEAK_BYTES_S = 3.35e12
PEAK_BF16_S = 989e12
PEAK_FP32_S = 67e12


def _time_ms(fn, launches: int = 10, repeats: int = 21) -> float:
    """Time of one eager call: CUDA events around ``launches`` back-to-back
    calls, median over ``repeats`` after a warm-up.  Where the device work of
    a call is shorter than the host's time to issue it, this is the host's
    time per call."""
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


def _device_ms(fn, launches: int = 10, repeats: int = 21) -> float:
    """Device time of one call with the host's launch gaps removed:
    ``launches`` calls captured once into a CUDA graph, the graph replayed
    under CUDA events, median over ``repeats`` replays after a warm-up."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def exact(ref) -> float:
    """The tolerance of a kernel that must give its plain version's bits."""
    return 0.0


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


@functools.lru_cache(maxsize=None)
def sass_dump(lib_path) -> str:
    """``cuobjdump -sass`` of a built library (~10 s for the port's: dumped
    once a library)."""
    from myriad_tpu_torch.ops import _cuda

    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr.strip()}")
    return res.stdout


def sass_count(lib_path, kernel: str, opcode: str):
    """(count, first line) of ``opcode`` in the SASS of every instantiation
    of ``kernel`` in the built library, from ``cuobjdump -sass``."""
    fn, count, first = "", 0, None
    for line in sass_dump(lib_path).splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[-1].strip()
        elif kernel in fn and opcode in line:
            count += 1
            first = first or " ".join(line.split())
    return count, first


def cluster_launch_report(lib_path) -> None:
    """Phase 1's lines on B1's, B2's and B5's cluster launches: ptxas's
    report (registers, barriers) of each instantiation, and at the paths'
    shapes the splits (blocks of a cluster), a block's dynamic shared memory
    and how many such clusters the card holds at once (for B1 also how many
    blocks an SM holds: three up to 32 rows, by design)."""
    from myriad_tpu_torch.ops import decode_attention as da
    from myriad_tpu_torch.ops import quant

    entry = ""
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "Used" in line or "spill" in line:
            for name, kernel in (("B1", "int8_matmul_tc_kernel"),
                                 ("B2", "decode_attention_cluster_kernel"),
                                 ("B5", "int4_matmul_tc_kernel")):
                if kernel in entry:
                    print(f"  {name} {entry.split(chr(39))[1]}: "
                          f"{line.split('ptxas info    : ')[-1].strip()}")
    llm = ((4096, 4096), (4096, 11008), (11008, 4096))
    b1_plans = ([(m, k, n) for m in (1, BATCH, VERIFY_ROWS, CHAT_DELTA_ROWS, 240)
                 for k, n in llm] + [(QFORMER_ROWS, k, n) for k, n in QFORMER_SHAPES])
    for m, k, n in b1_plans:
        plan = quant.int8_launch(m, k, n)
        print(f"  B1 launch at M={m} {k}x{n}: grid ({plan['splits']}, {plan['tiles']}) = "
              f"{plan['splits'] * plan['tiles']} blocks of 256 threads, cluster "
              f"({plan['splits']}, 1, 1); dynamic shared memory {plan['smem']} B a block, "
              f"{plan['blocks_per_sm']} blocks an SM; the card holds {plan['clusters']} "
              f"such clusters at once", flush=True)
        check(plan["splits"] == 1 or plan["clusters"] > 0,
              f"the card holds no cluster of B1 at M={m}, {k}x{n}")
        check(m > 32 or plan["blocks_per_sm"] == 3,
              f"B1 at M={m}, {k}x{n}: {plan['blocks_per_sm']} blocks an SM, not 3")
    for m in (1, BATCH, VERIFY_ROWS, 240):
        for k, n in llm:
            plan = quant.int4_launch(m, k, n, quant.INT4_GROUP)
            print(f"  B5 launch at M={m} {k}x{n} group {quant.INT4_GROUP}: grid "
                  f"({plan['splits']}, {plan['tiles']}) = {plan['splits'] * plan['tiles']} blocks "
                  f"of 256 threads, cluster ({plan['splits']}, 1, 1); dynamic shared memory "
                  f"{plan['smem']} B a block; the card holds {plan['clusters']} such clusters "
                  f"at once", flush=True)
            check(plan["splits"] == 1 or plan["clusters"] > 0,
                  f"the card holds no cluster of B5 at M={m}, {k}x{n}")
    for rows, kv_len in ((BATCH, 320), (1, CHAT_KV_LEN), (BATCH, 8192), (1, 8192), (BATCH, 64)):
        plan = da.cluster_launch(rows, 32, kv_len)
        blocks = plan["splits"] * 32 * rows
        print(f"  B2 launch at B={rows} H=32 kv_len={kv_len} int8: grid ({plan['splits']}, 32, "
              f"{rows}) = {blocks} blocks of 128 threads, cluster ({plan['splits']}, 1, 1); "
              f"dynamic shared memory {plan['smem']} B a block; the card holds "
              f"{plan['clusters']} such clusters at once", flush=True)
        check(plan["splits"] == 1 or plan["clusters"] > 0,
              f"the card holds no cluster of B2 at B={rows}, kv_len={kv_len}")


# kernel source of each function name in the library, for the SASS comparison
SASS_TAGS = (("int8_matmul", "B1"), ("decode_attention", "B2/B2'"), ("prefill_attention", "B3"),
             ("kv_", "B4"), ("int4_matmul", "B5"), ("u8_normalize", "B6"), ("stream_sum", "B7"))


def sass_functions(lib_path) -> dict:
    """{function: its SASS lines} of a built library, from ``cuobjdump
    -sass``, with each build's anonymous-namespace tag taken out of the
    names."""
    import re

    anon = re.compile(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_\w*?_cu_[0-9a-f]{8}")
    funcs, name = {}, None
    for line in sass_dump(lib_path).splitlines():
        if "Function :" in line:
            name = anon.sub("ANON", line.split("Function :")[-1].strip())
            funcs[name] = []
        elif name and line.strip().startswith("/*"):
            funcs[name].append(anon.sub("ANON", line.strip()))
    return funcs


def parent_comparison(parent, kernels, seed, lib_path) -> None:
    """``--parent DIR`` (a checkout of another tree, e.g. the parent
    commit's): build DIR's kernels, compare their SASS with this tree's
    function by function, then run phase 2's checks of ``kernels`` (names
    from ``PHASE2``) on DIR's package and this tree's in turns (parent,
    change, change, parent), each in a process of its own, on the same
    card."""
    parent = os.path.abspath(parent)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from myriad_tpu_torch.ops import _cuda; print(_cuda.build())")
    res = subprocess.run([sys.executable, "-c", code, parent], capture_output=True, text=True,
                         timeout=600, cwd=parent)
    check(res.returncode == 0, f"the parent's kernels did not build: {res.stderr[-2000:]}")
    old, new = sass_functions(res.stdout.strip().splitlines()[-1]), sass_functions(lib_path)
    for key, tag in SASS_TAGS:
        names = sorted(n for n in set(old) | set(new) if key in n)
        notes = []
        for n in names:
            if n not in old or n not in new:
                notes.append(f"only in {'parent' if n in old else 'this tree'}: {n[:80]}")
            elif old[n] != new[n]:
                notes.append(f"differs: {n[:80]}")
        print(f"  sass (cuobjdump -sass) against --parent: {tag} ({key}): "
              f"{len(names) - len(notes)} of {len(names)} functions identical"
              + "".join(f"; {x}" for x in notes), flush=True)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke as c; "
            "sys.path.insert(0, sys.argv[2]); import torch; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "c.kernel_checks(torch.device('cuda', 0), int(sys.argv[3]), sys.argv[4].split(','))")
    for which, tree in (("parent", parent), ("change", REPO), ("change", REPO),
                        ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", code, REPO, tree, str(seed),
                              ",".join(kernels)],
                             capture_output=True, text=True, timeout=600, cwd=REPO)
        for line in res.stdout.splitlines():
            if line.startswith("  B"):
                print(f"  [{which}] {line.strip()}", flush=True)
        check(res.returncode == 0, f"phase 2's {', '.join(kernels)} on {tree} failed: "
              f"{res.stderr[-2000:]}")


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_BF16_S,
          bytes_s: float = PEAK_BYTES_S):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of moving ``nbytes`` at the memory rate (the data sheet's,
    unless ``bytes_s`` gives another) and doing ``ops`` at the peak rate of
    their type."""
    t_bytes, t_ops = nbytes / bytes_s * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Check:
    """One kernel's comparisons with its plain version."""

    def __init__(self, name, source, replaces, counter):
        self.name, self.source, self.replaces, self.counter = name, source, replaces, counter
        self.max_err = 0.0
        self.ms = self.plain_ms = self.library_ms = self.bound_ms = self.bound_by = None
        self.eager_ms = None
        self.launches = None
        self.by_path = {}
        self.main = None  # (bytes, operations[, peak]) of the path's shape
        self.bound_measured_ms = None  # bytes at B7's measured bandwidth
        self.measured_bytes_s = None  # B7's: the card's measured streaming bandwidth
        self.shapes = []  # every path shape: its times and bound

    def compare(self, label, kernel, plain, tol_of, *, outputs=None, main=None, library=None,
                shape=None, deterministic=False):
        """Check the kernel against its plain version and time both (and the
        library call, where given).  ``outputs`` returns the (kernel, plain)
        tensors to compare when the calls write in place; ``main`` =
        (bytes, operations[, peak]) marks the path's shape, which supplies
        the JSON summary's times and bound; ``shape`` = (name, (bytes,
        operations[, peak])) records a further path shape under ``shapes``.
        ``deterministic``: a second call on the same inputs must give the
        same bits."""
        import torch

        out, ref = kernel(), plain()
        if outputs is not None:
            out, ref = outputs()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tol_of(ref)
        ok = bool(torch.isfinite(out.float()).all()) and err <= tol
        same = None
        if deterministic:  # in place (``outputs``): the same call again, the same bits
            first = out.clone()
            again = kernel()
            same = torch.equal(first, outputs()[0] if outputs is not None else again)
        self.max_err = max(self.max_err, err)
        eager_ms = _time_ms(kernel)
        ms, plain_ms = _device_ms(kernel), _device_ms(plain)
        lib_ms = _device_ms(library) if library is not None else None
        line = (f"  {self.name} {label}: max_abs_err={err:.3e} tol={tol:.3e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f}")
        if lib_ms is not None:
            line += f" library_ms={lib_ms:.4f}"
        line += f" kernel_eager_ms={eager_ms:.4f}"
        if main is not None:
            self.ms, self.plain_ms, self.library_ms = ms, plain_ms, lib_ms
            self.eager_ms = eager_ms
            self.main = main
            self.bound_ms, self.bound_by = bound(*main)
            line += f" bound_ms={self.bound_ms:.6f} ({self.bound_by}) [path shape]"
        name, work = shape if shape is not None else ("main", main)
        if work is not None:
            bms, by = bound(*work)
            if shape is not None:
                line += f" bound_ms={bms:.6f} ({by}) [path shape: {name}]"
            self.shapes.append({"shape": name, "label": label, "ms": ms, "plain_ms": plain_ms,
                                "library_ms": lib_ms, "eager_ms": eager_ms, "bound_ms": bms,
                                "bound_by": by, "max_abs_err": err, "work": work})
        if deterministic:
            line += f" bit-identical across two runs: {same}"
            ok = ok and same
        print(line + ("" if ok else "  FAILED"), flush=True)
        check(ok, f"{self.name} {label}: kernel disagrees with its plain version"
              + (" or with itself" if deterministic else ""))

    def record(self):
        return {"name": self.name, "route": "cuda", "source": self.source,
                "replaces": self.replaces, "launches": self.launches,
                "max_abs_err": self.max_err, "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms, "bound_by": self.bound_by,
                "library_ms": self.library_ms, "eager_ms": self.eager_ms,
                "bound_ms_at_measured_bandwidth": self.bound_measured_ms,
                "launches_by_path": self.by_path,
                "shapes": [{k: v for k, v in sh.items() if k != "work"} for sh in self.shapes]}


def kernel_checks(dev, seed, only=None):
    """Phase 2: each kernel against its plain version at the paths' shapes,
    in the order of ``PHASE2``.  ``only`` (names from ``PHASE2``, such as
    ("B4", "B6")) runs those kernels' checks alone, to time another tree's
    package beside this one's (``--parent``).  Returns the kernels' checks."""
    import torch

    from myriad_tpu_torch.ops import decode_attention as da
    from myriad_tpu_torch.ops import kv_write as kw
    from myriad_tpu_torch.ops import prefill_attention as pa
    from myriad_tpu_torch.ops import preprocess as pp
    from myriad_tpu_torch.ops import quant
    from myriad_tpu_torch.tools import bwprobe

    g = torch.Generator(device=dev).manual_seed(seed)
    checks = {
        "B1": Check("B1 int8_matmul", "myriad_tpu_torch/csrc/int8_matmul.cu",
                    "myriad_tpu/ops/quant.py:73", quant.counter),
        "B2": Check("B2 decode_attention", "myriad_tpu_torch/csrc/decode_attention.cu",
                    "myriad_tpu/ops/decode_attention.py:31", da.counter),
        "B3": Check("B3 prefill_attention", "myriad_tpu_torch/csrc/prefill_attention.cu",
                    "myriad_tpu/ops/prefill_attention.py:37", pa.counter),
        "B4": Check("B4 kv_write", "myriad_tpu_torch/csrc/kv_write.cu",
                    "myriad_tpu/ops/kv_write.py:56", kw.counter),
        "B5": Check("B5 int4_matmul", "myriad_tpu_torch/csrc/int4_matmul.cu",
                    "myriad_tpu/ops/quant.py:247", quant.counter4),
        "B2'": Check("B2' decode_attention_rows", "myriad_tpu_torch/csrc/decode_attention.cu",
                     "myriad_tpu/ops/decode_attention.py:56", da.counter_rows),
        "B6": Check("B6 u8_normalize", "myriad_tpu_torch/csrc/preprocess.cu",
                    "myriad_tpu/ops/preprocess.py:69", pp.counter),
        "B7": Check("B7 stream_sum", "myriad_tpu_torch/csrc/bwprobe.cu",
                    "tools/bwprobe.py:42", bwprobe.counter),
    }
    inputs = {}  # the attention kernels' caches, built once for B2, B3 and B2'
    ran = []
    for name, run in PHASE2:
        if only is None or name in only:
            run(dev, g, checks[name], inputs)
            ran.append(checks[name])
    inputs.clear()
    measured = checks["B7"].measured_bytes_s
    if measured is not None:
        for c in ran:
            c.bound_measured_ms = bound(*c.main, bytes_s=measured)[0]
            for sh in c.shapes:
                sh["bound_ms_at_measured_bandwidth"] = bound(*sh["work"], bytes_s=measured)[0]
            print(f"  {c.name}: bound {c.bound_ms:.6f} ms at the data sheet's "
                  f"{PEAK_BYTES_S / 1e12:.2f} TB/s, {c.bound_measured_ms:.6f} ms at the "
                  f"measured {measured / 1e12:.4f} TB/s; kernel {c.ms:.4f} ms")
    return ran


def b1_checks(dev, g, b1, inputs):
    """Phase 2's B1 at the int8 projections: q, k, v and o are 4096->4096,
    gate and up 4096->11008, down 11008->4096; a chat turn's delta prefill
    is 132 rows; the int8 Q-Former's 81-row stream at a chat upload takes
    768->768, 768->3072 and 3072->768.  A bf16 output differs by at most
    one rounding of its largest value."""
    import torch

    from myriad_tpu_torch.ops import quant

    bf16 = torch.bfloat16
    print("B1: tolerance 2^-7 * max|plain| (one bf16 ulp at the largest output); runs twice "
          "and must give the same bits; library: torch.matmul on the weight dequantized to "
          "bf16 beforehand (it reads twice the weight bytes)")
    shapes = ([(k, n, (1, BATCH, VERIFY_ROWS, 48) + ((CHAT_DELTA_ROWS,) if k == n else ()))
               for k, n in ((4096, 4096), (4096, 11008), (11008, 4096))]
              + [(k, n, (QFORMER_ROWS,)) for k, n in QFORMER_SHAPES])
    tags = {VERIFY_ROWS: " (verify rows)", CHAT_DELTA_ROWS: " (chat delta)",
            QFORMER_ROWS: " (Q-Former chat upload)"}
    for k, n, rows in shapes:
        w8, scale = quant.quantize_per_channel(_randn(g, dev, k, n) * 0.02)
        w_bf16 = (w8.float() * scale).to(bf16)
        for m in rows:
            x = _randn(g, dev, m, k, dtype=bf16)
            is_main = m == BATCH and (k, n) == (4096, 11008)
            work = (m * k * 2 + k * n + n * 4 + m * n * 2, 2 * m * k * n)
            on_path = m in (BATCH, *tags) and not is_main
            b1.compare(f"M={m} {k}x{n}", lambda: quant.int8_weight_only_matmul(x, w8, scale),
                       lambda: quant.int8_weight_only_matmul_plain(x, w8, scale),
                       lambda ref: 2.0 ** -7 * ref.float().abs().max().item(),
                       library=lambda: torch.matmul(x, w_bf16),
                       main=work if is_main else None,
                       shape=(f"M={m}{tags.get(m, '')} {k}x{n}", work) if on_path else None,
                       deterministic=True)
        del w_bf16


def _randn(g, dev, *shape, dtype=None):
    import torch

    x = torch.randn(*shape, generator=g, device=dev)
    return x if dtype is None else x.to(dtype)


# the attention kernels' cache: B = 8, H = 32, T = 416, D = 128, read to
# kv_len 320 with the frontier at 300; the long cache has 8192 positions
ATT_B, ATT_H, ATT_T, ATT_D = BATCH, 32, 416, 128
KV_LEN, FRONTIER, LONG_T = 320, 300, 8192


def _attention_inputs(inputs, dev, g):
    """The int8 and bf16 caches, the decode query and mask that B2, B3 and
    B2' read, built on first use."""
    import torch

    from myriad_tpu_torch.ops import kv_write as kw

    if "k8" not in inputs:
        b, h, t, d = ATT_B, ATT_H, ATT_T, ATT_D
        bf16 = torch.bfloat16
        q1 = _randn(g, dev, b, h, 1, d, dtype=bf16)
        kf, vf = _randn(g, dev, b, h, t, d), _randn(g, dev, b, h, t, d)
        k8, ks = kw.quantize_kv(kf)
        v8, vs = kw.quantize_kv(vf)
        ks, vs = ks.half(), vs.half()
        kdq, vdq = (k8.float() * ks.float()).to(bf16), (v8.float() * vs.float()).to(bf16)
        kpos = torch.arange(KV_LEN, device=dev)
        mask = torch.where(kpos <= FRONTIER, 0.0, -1e9).float()[None, None, None].expand(
            b, 1, 1, KV_LEN).contiguous()
        inputs.update(q1=q1, k8=k8, v8=v8, ks=ks, vs=vs, kbf=kf.to(bf16), vbf=vf.to(bf16),
                      kdq=kdq, vdq=vdq, mask=mask,
                      kdq_len=kdq[:, :, :KV_LEN].contiguous(),
                      vdq_len=vdq[:, :, :KV_LEN].contiguous())
    return inputs


def _long_cache(inputs, dev, g):
    """An int8 cache of 8192 positions at batch 8, its bf16 dequantization
    and a zero mask, built on first use."""
    import torch

    from myriad_tpu_torch.ops import kv_write as kw

    if "kl8" not in inputs:
        b, h, n, d = ATT_B, ATT_H, LONG_T, ATT_D
        kl8, kls = kw.quantize_kv(_randn(g, dev, b, h, n, d))
        vl8, vls = kw.quantize_kv(_randn(g, dev, b, h, n, d))
        kls, vls = kls.half(), vls.half()
        inputs.update(kl8=kl8, vl8=vl8, kls=kls, vls=vls,
                      kldq=(kl8.float() * kls.float()).to(torch.bfloat16),
                      vldq=(vl8.float() * vls.float()).to(torch.bfloat16),
                      lmask=torch.zeros(b, 1, 1, n, device=dev))
    return inputs


def _decode_bytes(rows, n):
    """Bytes of one int8 decode call: q and out, K and V of n positions with
    their fp16 scales, and the fp32 mask, for `rows` batch rows."""
    h, d = ATT_H, ATT_D
    return 2 * rows * h * d * 2 + 2 * rows * h * n * d + 2 * rows * h * n * 2 + rows * n * 4


def _decode_checks(check, kernel, plain, a, long_rows):
    """B2's or B2''s checks: the cache at kv_len 320 (int8, the path shape,
    and bf16), at 333 (ends inside a key tile and a split), and on the long
    cache at each batch of ``long_rows`` ((rows, kv_len) pairs)."""
    import torch
    import torch.nn.functional as F

    b, h, t, d = ATT_B, ATT_H, ATT_T, ATT_D
    bf16 = torch.bfloat16
    q1, mask = a["q1"], a["mask"]
    for label, kk, vv, kss, vss in (("int8", a["k8"], a["v8"], a["ks"], a["vs"]),
                                    ("bf16", a["kbf"], a["vbf"], None, None)):
        args = dict(mask=mask, scale=d ** -0.5, k_scale=kss, v_scale=vss, kv_len=KV_LEN)
        is_main = label == "int8"
        check.compare(f"{label} B={b} H={h} T={t} kv_len={KV_LEN} D={d}",
                      lambda: kernel(q1, kk, vv, **args), lambda: plain(q1, kk, vv, **args),
                      lambda ref: 2e-2,
                      library=(lambda: F.scaled_dot_product_attention(
                          q1, a["kdq_len"], a["vdq_len"], attn_mask=mask.to(bf16),
                          scale=d ** -0.5)) if is_main else None,
                      main=(_decode_bytes(b, KV_LEN), 4 * b * h * KV_LEN * d) if is_main
                      else None,
                      deterministic=True)
    n = 333  # ends inside a key tile and inside a split
    args = dict(mask=mask[..., :1].expand(b, 1, 1, n).contiguous(), scale=d ** -0.5,
                k_scale=a["ks"], v_scale=a["vs"], kv_len=n)
    check.compare(f"int8 B={b} H={h} T={t} kv_len={n} D={d}",
                  lambda: kernel(q1, a["k8"], a["v8"], **args),
                  lambda: plain(q1, a["k8"], a["v8"], **args),
                  lambda ref: 2e-2, deterministic=True)
    n = LONG_T
    for rows, kv in long_rows:
        qq, kk, vv = q1[:rows], a["kl8"][:rows], a["vl8"][:rows]
        mk = a["lmask"][:rows, ..., :kv].contiguous()
        kdq_kv = a["kldq"][:rows, :, :kv].contiguous()
        vdq_kv = a["vldq"][:rows, :, :kv].contiguous()
        args = dict(mask=mk, scale=d ** -0.5, k_scale=a["kls"][:rows], v_scale=a["vls"][:rows],
                    kv_len=kv)
        work = (_decode_bytes(rows, kv), 4 * rows * h * kv * d)
        where = "chat turn" if kv == CHAT_KV_LEN else f"kv_len {kv}"
        check.compare(f"int8 B={rows} H={h} T={n} kv_len={kv} D={d}",
                      lambda: kernel(qq, kk, vv, **args), lambda: plain(qq, kk, vv, **args),
                      lambda ref: 2e-2,
                      library=lambda: F.scaled_dot_product_attention(
                          qq, kdq_kv, vdq_kv, attn_mask=mk.to(bf16), scale=d ** -0.5),
                      shape=(f"batch {rows}, {where}", work), deterministic=True)


def b2_checks(dev, g, b2, inputs):
    """Phase 2's B2: one launch, the splits of each (b, h) one cluster; also
    on the long cache at batch 8 and 1, and at batch 1 at a chat turn's
    kv_len, the positions read through the cache's strides."""
    from myriad_tpu_torch.ops import decode_attention as da

    print("B2/B3/B2': tolerance 2e-2 absolute (bf16 probabilities and outputs; |out| <~ 3); "
          "library: scaled_dot_product_attention with the additive mask on the cache "
          "dequantized to bf16")
    print("B2: one launch, the splits of each (b, h) one thread-block cluster merged in "
          "distributed shared memory; runs twice and must give the same bits; also on a "
          "cache of 8192 positions at batch 8 and 1, and at batch 1 at a chat turn's kv_len")
    a = _long_cache(_attention_inputs(inputs, dev, g), dev, g)
    _decode_checks(b2, da.decode_attention, da.decode_attention_plain, a,
                   ((ATT_B, LONG_T), (1, LONG_T), (1, CHAT_KV_LEN)))
    _engine_decode_check(b2, a, dev)


# the serving engine's per-row frontiers at a decode step: spread over 64-410
# in one batch of 8, the whole 416-position bucket read (the engine does not stage)
ENGINE_FRONTIERS = (64, 410, 297, 120, 233, 350, 180, 389)


def _engine_decode_check(b2, a, dev):
    """B2 at the engine's decode step: kv_len = the bucket, every row masked at
    its own frontier through the (B, 1, 1, kv_len) mask.  The library call is
    SDPA with the same mask as booleans.  The bound counts what the data
    needs: each row's keys up to its frontier."""
    import torch
    import torch.nn.functional as F

    from myriad_tpu_torch.ops import decode_attention as da
    from myriad_tpu_torch.ops.attention import causal_mask

    b, h, t, d = ATT_B, ATT_H, ATT_T, ATT_D
    front = torch.tensor(ENGINE_FRONTIERS, device=dev, dtype=torch.int32)
    mask = causal_mask(front[:, None], t)
    allowed = mask == 0
    args = dict(mask=mask, scale=d ** -0.5, k_scale=a["ks"], v_scale=a["vs"], kv_len=t)
    keys = int((front.long() + 1).sum())
    work = (2 * b * h * d * 2 + keys * h * (2 * d + 2 * 2) + b * t * 4, 4 * h * d * keys)
    b2.compare(f"int8 B={b} H={h} T={t} kv_len={t} D={d}, per-row frontiers "
               f"{min(ENGINE_FRONTIERS)}-{max(ENGINE_FRONTIERS)} (engine decode)",
               lambda: da.decode_attention(a["q1"], a["k8"], a["v8"], **args),
               lambda: da.decode_attention_plain(a["q1"], a["k8"], a["v8"], **args),
               lambda ref: 2e-2,
               library=lambda: F.scaled_dot_product_attention(
                   a["q1"], a["kdq"], a["vdq"], attn_mask=allowed, scale=d ** -0.5),
               shape=("engine decode, ragged frontiers", work), deterministic=True)


def b3_checks(dev, g, b3, inputs):
    """Phase 2's B3: 16 rows or more on the tensor cores, fewer with the keys
    split over blocks; the 4-row verify chunk with ragged positions is a
    path shape of its own."""
    import torch
    import torch.nn.functional as F

    from myriad_tpu_torch.ops import prefill_attention as pa
    from myriad_tpu_torch.ops.attention import causal_mask

    a = _attention_inputs(inputs, dev, g)
    b, h, t, d = ATT_B, ATT_H, ATT_T, ATT_D
    bf16 = torch.bfloat16
    ragged = torch.tensor([297, 300, 310, 299, 305, 301, 296, 320], device=dev,
                          dtype=torch.int32)
    print("B3: 16 rows or more on the tensor cores, fewer with the keys split over blocks; "
          "the 4-row verify chunk with ragged positions is a path shape of its own")
    for tq, offset in ((297, 0), (33, 264), (7, 290), (SPEC_K + 1, None)):
        qq = _randn(g, dev, b, h, tq, d, dtype=bf16)
        start = ragged if offset is None else torch.full((b,), offset, device=dev,
                                                         dtype=torch.int32)
        pos = (start[:, None] + torch.arange(tq, device=dev, dtype=torch.int32)[None]
               ).contiguous()
        where = "ragged per-row positions" if offset is None else f"offset={offset}"
        # what this run's data needs: each batch row's keys up to its last
        # position, and each query's keys up to its own
        row_keys = int((pos.max(dim=1).values.long() + 1).clamp(max=t).sum())
        pairs = int((pos.long() + 1).clamp(max=t).sum()) * h
        nbytes = 2 * b * h * tq * d * 2 + h * row_keys * (2 * d + 2 * 2) + b * tq * 4
        cmask = causal_mask(pos, t).to(bf16)
        for label, kk, vv, kss, vss in (("int8", a["k8"], a["v8"], a["ks"], a["vs"]),
                                        ("bf16", a["kbf"], a["vbf"], None, None)):
            args = dict(scale=d ** -0.5, k_scale=kss, v_scale=vss)
            is_main = label == "int8" and tq == 297
            is_verify = label == "int8" and offset is None
            b3.compare(f"{label} tq={tq} {where} Tk={t}",
                       lambda: pa.prefill_attention(qq, kk, vv, pos, **args),
                       lambda: pa.prefill_attention_plain(qq, kk, vv, pos, **args),
                       lambda ref: 2e-2,
                       library=(lambda: F.scaled_dot_product_attention(
                           qq, a["kdq"], a["vdq"], attn_mask=cmask, scale=d ** -0.5))
                       if is_main or is_verify else None,
                       main=(nbytes, 4 * d * pairs) if is_main else None,
                       shape=("verify", (nbytes, 4 * d * pairs)) if is_verify else None,
                       deterministic=True)


def b5_checks(dev, g, b5, inputs):
    """Phase 2's B5 at the int4 projections at group 128: q, k, v and o are
    4096->4096, gate and up 4096->11008, down 11008->4096."""
    import torch

    from myriad_tpu_torch.ops import quant

    bf16 = torch.bfloat16
    print("B5: tolerance 2^-7 * max|plain| (the same bf16 dequantized weight, fp32 sums in "
          "another order, one bf16 rounding); runs twice and must give the same bits; "
          "library: torch.matmul on the int4 weight dequantized to bf16 beforehand (it reads "
          "four times the weight bytes)")
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
        w4, s4 = quant.quantize_int4_grouped(_randn(g, dev, k, n) * 0.02)
        w_bf16 = quant.dequant_int4(w4, s4).to(bf16)
        for m in (1, BATCH, VERIFY_ROWS):
            x = _randn(g, dev, m, k, dtype=bf16)
            is_main = m == BATCH and (k, n) == (4096, 11008)
            work = (m * k * 2 + k * n // 2 + s4.numel() * 4 + m * n * 2, 2 * m * k * n)
            name = f"M={m}{' (verify rows)' if m == VERIFY_ROWS else ''} {k}x{n}"
            b5.compare(f"M={m} {k}x{n}", lambda: quant.int4_weight_only_matmul(x, w4, s4),
                       lambda: quant.int4_weight_only_matmul_plain(x, w4, s4),
                       lambda ref: 2.0 ** -7 * ref.float().abs().max().item(),
                       library=lambda: torch.matmul(x, w_bf16),
                       main=work if is_main else None,
                       shape=(name, work) if m > 1 and not is_main else None,
                       deterministic=True)
        del w_bf16


def b2r_checks(dev, g, b2r, inputs):
    """Phase 2's B2': B2's shapes, and the long cache at batch 8 and 1."""
    from myriad_tpu_torch.ops import decode_attention as da

    print("B2': tolerance 2e-2 absolute, as B2; library: scaled_dot_product_attention on the "
          "cache dequantized to bf16")
    _decode_checks(b2r, da.decode_attention_rows, da.decode_attention_rows_plain,
                   _long_cache(_attention_inputs(inputs, dev, g), dev, g),
                   ((ATT_B, LONG_T), (1, LONG_T)))


def b7_checks(dev, g, b7, inputs):
    """Phase 2's B7: a 4 GiB int8 operand of small integers, so that every
    sum is exact; sets ``b7.measured_bytes_s``, the card's measured
    streaming bandwidth."""
    import torch

    from myriad_tpu_torch.tools import bwprobe

    print("B7: exact (tolerance 0: sums of integers in {-1, 0, 1}); library: torch.sum "
          "(dtype float32) over the same operand")
    rows = int(PROBE_GIB * (1 << 30)) // bwprobe.WIDTH // 1024 * 1024
    big = torch.randint(-1, 2, (rows, bwprobe.WIDTH), generator=g, device=dev,
                        dtype=torch.int8)
    b7.compare(f"one operand {rows}x{bwprobe.WIDTH} int8 ({PROBE_GIB} GiB), block 512",
               lambda: bwprobe.stream_sum(big, 1.0, 512),
               lambda: bwprobe.stream_sum_plain(big, 1.0, 512), exact,
               library=lambda: torch.sum(big, dtype=torch.float32),
               main=(big.numel(), big.numel(), PEAK_FP32_S))
    gbps = {"stream_sum (B7)": big.numel() / b7.ms / 1e6,
            "torch.sum": big.numel() / b7.library_ms / 1e6}
    half_x, half_y = big[:rows // 2], big[rows // 2:]
    two_ms = _device_ms(lambda: bwprobe.stream_sum(half_x, 1.0, 512, half_y))
    out2 = bwprobe.stream_sum(half_x, 1.0, 512, half_y)
    check(out2.item() == bwprobe.stream_sum_plain(half_x, 1.0, 512, half_y).item(),
          "B7 two-operand sum disagrees with its plain version")
    gbps[f"stream_sum2 (B7, two {PROBE_GIB / 2:g} GiB operands)"] = big.numel() / two_ms / 1e6
    del big, half_x, half_y
    print("measured streaming bandwidth (device ms from CUDA-graph replay): "
          + ", ".join(f"{k} {v:.1f} GB/s" for k, v in gbps.items()) + f"; card: {_card()}",
          flush=True)
    b7.measured_bytes_s = max(gbps.values()) * 1e9


def b4_checks(dev, g, b4, inputs):
    """Phase 2's B4: the copy (an int8 payload, fp16 scales and a bf16 cache
    at a verify round's 4 positions) and the quantize-and-write at each path
    shape (greedy decode, a chat turn's decode, the verify round, a prefill
    chunk) and at its launch floor (one row of 8), bit-exact."""
    import torch

    from myriad_tpu_torch.ops import kv_write as kw

    bf16 = torch.bfloat16
    b, h, t, d = BATCH, 32, 416, 128

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    # per-row starts include two that clamp (413 and 1000 -> T - t)
    print("B4: bit-exact (tolerance 0): copy mode on an int8 payload, fp16 scales (D=1) "
          "and a bf16 cache, and the fused quantize-and-write, with per-row starts of which "
          "two clamp; library (copy mode, bf16 cache): one indexed assignment; none computes "
          "the fused quantize-and-write")
    starts = torch.tensor([300, 412, 0, 413, 37, 200, 5, 1000], device=dev, dtype=torch.int32)
    tw = SPEC_K + 1
    rows = torch.arange(b, device=dev)[:, None].expand(b, tw)
    cols = starts.long().clamp(0, t - tw)[:, None] + torch.arange(tw, device=dev)[None]
    for label, dtype, dd in (("int8 payload", torch.int8, d), ("fp16 scales", torch.float16, 1),
                             ("bf16 cache", bf16, d)):
        buf = (randn(b, h, t, dd) * 50).clamp(-127, 127).to(dtype)
        # the attention's layout: (B, t, H, D) transposed
        upd = (randn(b, tw, h, dd) * 50).clamp(-127, 127).to(dtype).transpose(1, 2)
        out, ref, lib = buf.clone(), buf.clone(), buf.clone()
        upd_rows = upd.transpose(1, 2).contiguous()

        def assign(lib=lib, upd_rows=upd_rows):
            lib[rows, :, cols] = upd_rows
        is_lib = label == "bf16 cache"
        size = upd.element_size()
        b4.compare(f"copy {label} B={b} H={h} T={t} t={tw} D={dd}",
                   lambda: kw.kv_cache_write(out, upd, starts),
                   lambda: kw.kv_cache_write_plain(ref, upd, starts), exact,
                   outputs=lambda: (out, ref), library=assign if is_lib else None,
                   shape=("copy, bf16 cache, verify round",
                          (2 * b * h * tw * dd * size + b * 4, 0)) if is_lib else None,
                   deterministic=True)
    # (batch rows, heads, written positions, D, label, starts); the launch floor
    # is one row of 8.  Per-row starts where the path has them (a verify round,
    # the engine's decode step); greedy decode and the prefill start every row
    # at one frontier
    engine = torch.tensor(ENGINE_FRONTIERS, device=dev, dtype=torch.int32)
    cases = ((BATCH, h, 1, d, "greedy decode", 300), (1, h, 1, d, "chat decode", 300),
             (BATCH, h, tw, d, "verify round", starts), (BATCH, h, 297, d, "prefill", 0),
             (BATCH, h, 1, d, "engine decode", engine), (1, 1, 1, 8, "launch floor", 300))
    for bq, hq, tq, dq, label, idx in cases:
        k = (randn(bq, tq, hq, dq) * 4).to(bf16).transpose(1, 2)
        v = randn(bq, tq, hq, dq).to(bf16).transpose(1, 2)
        bufs = [torch.randint(-127, 128, (bq, hq, t, dq), generator=g, device=dev,
                              dtype=torch.int8) for _ in range(2)]
        bufs += [torch.rand(bq, hq, t, 1, generator=g, device=dev).half() for _ in range(2)]
        outs, refs = [x.clone() for x in bufs], [x.clone() for x in bufs]
        n = bq * hq * tq
        work = (2 * n * dq * 2 + 2 * n * dq + 2 * n * 2 + (bq * 4 if torch.is_tensor(idx)
                                                           else 0),
                # abs, max, divide, round per element, in fp32
                4 * 2 * n * dq, PEAK_FP32_S)
        is_main = label == "verify round"
        b4.compare(f"quantize-and-write B={bq} H={hq} T={t} t={tq} D={dq} ({label}, "
                   f"{'per-row starts' if torch.is_tensor(idx) else f'start {idx}'})",
                   lambda: kw.kv_quantize_write(*outs, k, v, idx),
                   lambda: kw.kv_quantize_write_plain(*refs, k, v, idx), exact,
                   outputs=lambda: (torch.cat([x.flatten().float() for x in outs]),
                                    torch.cat([x.flatten().float() for x in refs])),
                   main=work if is_main else None,
                   shape=None if is_main else (label, work), deterministic=True)


def b6_checks(dev, g, b6, inputs):
    """Phase 2's B6: the batch's images to fp32 (the path shape) and bf16."""
    import torch

    from myriad_tpu_torch.ops import preprocess as pp

    print("B6: bit-exact (tolerance 0: IEEE divisions on both sides); no library call "
          "computes it in one")
    images = torch.randint(0, 256, (BATCH, 224, 224, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    n_el = images.numel()
    for out_dtype, width in ((torch.float32, 4), (torch.bfloat16, 2)):
        name = f"{BATCH}x224x224x3 -> {str(out_dtype).split('.')[-1]}"
        # divide, subtract, divide per element, in fp32
        work = (n_el * (1 + width), 3 * n_el, PEAK_FP32_S)
        is_main = out_dtype == torch.float32
        b6.compare(name, lambda: pp.u8_normalize_rows(images, out_dtype=out_dtype),
                   lambda: pp.u8_normalize_rows_plain(images, out_dtype=out_dtype), exact,
                   main=work if is_main else None, shape=None if is_main else (name, work),
                   deterministic=True)


# phase 2's checks by kernel, in the order of the summary's kernels line
PHASE2 = (("B1", b1_checks), ("B2", b2_checks), ("B3", b3_checks), ("B4", b4_checks),
          ("B5", b5_checks), ("B2'", b2r_checks), ("B6", b6_checks), ("B7", b7_checks))


class plain_path:
    """Route the kernel wrappers to their plain versions while active, so the
    full-width model can be run once as the kernels' reference."""

    def __enter__(self):
        from myriad_tpu_torch.ops import decode_attention as da
        from myriad_tpu_torch.ops import kv_write as kw
        from myriad_tpu_torch.ops import prefill_attention as pa
        from myriad_tpu_torch.ops import quant

        swaps = [(quant, "int8_weight_only_matmul", quant.int8_weight_only_matmul_plain),
                 (quant, "int4_weight_only_matmul", quant.int4_weight_only_matmul_plain),
                 (da, "decode_attention", da.decode_attention_plain),
                 (da, "decode_attention_rows", da.decode_attention_rows_plain),
                 (pa, "prefill_attention", pa.prefill_attention_plain),
                 (kw, "kv_cache_write", kw.kv_cache_write_plain),
                 (kw, "kv_quantize_write", kw.kv_quantize_write_plain)]
        self.saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, plain in swaps:
            setattr(mod, name, plain)

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def drive(checks, path, fn, needs):
    """Run one path with every launch count set to 0 just before and read
    just after; check that each kernel in ``needs`` was launched."""
    import torch

    for c in checks:
        c.counter.count = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {}
    for c in checks:
        c.by_path[path] = counts[c.name] = c.counter.count
    for name in needs:
        check(counts[name] > 0, f"{name} was not launched on the {path} path")
    return res, wall, counts


def rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def sensitivity_gate(label, kernel_logits, run, embeds, seed):
    """The int8 path is sensitive by nature: W8A8 re-quantizes every
    activation row, so a one-ulp change anywhere can flip int8 roundings
    downstream, and random weights amplify it over 32 layers.  The kernels
    are held to the plain path's own sensitivity: their logits may move at
    most twice as far (relative L2) from the plain path's as the plain path's
    move when its input embeddings take N(0, 2^-9) relative noise and are
    re-rounded to bf16.  ``run(embeds)`` computes the logits."""
    import torch

    g = torch.Generator(device=embeds.device).manual_seed(seed + 1)
    noise = torch.randn(embeds.shape, generator=g, device=embeds.device) * 2.0 ** -9
    noisy = (embeds.float() * (1.0 + noise)).to(embeds.dtype)
    with plain_path():
        plain, plain_noisy = run(embeds), run(noisy)
    err, floor = rel(kernel_logits, plain), rel(plain_noisy, plain)
    agree = (kernel_logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    print(f"{label}: kernels vs plain rel_l2={err:.4e} max_abs_err="
          f"{(kernel_logits - plain).abs().max().item():.4e}; plain vs plain with noisy input "
          f"rel_l2={floor:.4e}; tol=2x that; argmax agreement {agree:.3f}", flush=True)
    check(bool(torch.isfinite(kernel_logits).all()), f"{label}: non-finite logits")
    check(err <= 2.0 * floor, f"{label}: kernels disagree with the plain path")


def check_tokens(tokens, rows, new_tokens, vocab):
    from myriad_tpu_torch.generation import GenerationConfig

    cfg = GenerationConfig()
    check(tuple(tokens.shape) == (rows, new_tokens), tokens.shape)
    check(bool(((tokens >= 0) & (tokens < vocab)).all()), "token id out of range")
    # a stop id is never emitted: the step that produces it marks the row done
    # and the row emits pad from then on (tests/test_torch_llama.py pins the rest)
    for row in tokens.tolist():
        check(cfg.eos_token_id not in row and cfg.stop_single not in row,
              "a single stop id was emitted instead of pad")
        check(not any(a == cfg.stop_pair[0] and b == cfg.stop_pair[1]
                      for a, b in zip(row, row[1:])), "the '###' pair was emitted")


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t


def full_slice(dev, seed, checks, card):
    """Phase 3: the full-width main path through Myriad.generate."""
    import numpy as np
    import torch

    from myriad_tpu_torch.generation import _prefill
    from myriad_tpu_torch.models.llama import init_cache, serving_cache_dtype
    from myriad_tpu_torch.models.myriad import Myriad

    t0 = time.time()
    model = Myriad.from_config(SERVING, device=dev, class_names=SCENES)
    model.init_random(seed)
    model.vision_expert.build_text_features()
    torch.cuda.synchronize()
    print(f"full-width Myriad built with random weights (seed {seed}) in "
          f"{time.time() - t0:.1f} s; text features for {SCENES}", flush=True)

    samples = _samples(seed, model.arch.img_size)
    model.generate(samples, max_new_tokens=4)  # warm-up (cuBLAS/cuDNN set-up)

    torch.cuda.reset_peak_memory_stats(dev)
    names = ["B1 int8_matmul", "B2 decode_attention", "B3 prefill_attention", "B4 kv_write"]
    out, wall0, launches = drive(checks, "aqa_greedy",
                                 lambda: model.generate(samples, max_new_tokens=NEW_TOKENS),
                                 names)
    for c in checks:
        if c.name in names:
            c.launches = c.counter.count
    walls = [wall0] + [timed(lambda: model.generate(samples, max_new_tokens=NEW_TOKENS))[1]
                       for _ in range(2)]
    peak = torch.cuda.max_memory_allocated(dev)
    wall = statistics.median(walls)

    tokens, maps = out["token_ids"], out["ve_anomaly_maps"]
    vocab = model.arch.llama.vocab_size
    check_tokens(tokens, BATCH, NEW_TOKENS, vocab)
    ms = model.arch.map_size
    check(tuple(maps.shape) == (BATCH, ms, ms, 1), maps.shape)
    check(bool(torch.isfinite(maps).all()), "non-finite anomaly map")
    check(float(maps.min()) >= 0.0 and float(maps.max()) <= 1.0, "map outside [0, 1]")
    print(f"generate: tokens {tuple(tokens.shape)} in [0, {vocab}); maps "
          f"{tuple(maps.shape)} in [{float(maps.min()):.4f}, {float(maps.max()):.4f}]")
    print(f"kernel launches in the generate run: {launches}")
    print(f"throughput: {BATCH / wall:.4f} images/s, median of 3 runs ({BATCH} images, "
          f"{NEW_TOKENS} new tokens; wall s {', '.join(f'{w:.3f}' for w in walls)}, host "
          f"clock after synchronize); peak device memory {peak / 2**30:.2f} GiB; "
          f"card: {card}", flush=True)

    # the kernels' path against the plain path at full width
    with torch.inference_mode():
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

        def prefill(chunks):
            def run(x):
                cache = init_cache(llama.config, BATCH, p + NEW_TOKENS, cache_dtype, dev)
                return _prefill(llama, x, cache, chunks)[:, -1].float()
            return run

        for label, chunks in (("1 chunk", 1), ("10 chunks", 10)):
            sensitivity_gate(f"prefill logits ({p} positions, {label})",
                             prefill(chunks)(embeds), prefill(chunks), embeds, seed)
        with plain_path():
            plain_tokens, t_plain = timed(
                lambda: model.generate(samples, max_new_tokens=NEW_TOKENS)["token_ids"])
    same = (plain_tokens == tokens).float().mean().item()
    print(f"plain path (no kernels) generate: {BATCH / t_plain:.4f} images/s ({t_plain:.3f} s, "
          f"one run) against the kernels' {BATCH / wall:.4f}")
    print(f"greedy tokens identical to the plain path's: {same:.4f} of {tokens.numel()} "
          f"(reported, not required: random weights leave thin argmax margins)")
    profile_generate(model, samples, card, wall, "greedy generate (int8)")
    return model, samples, tokens, embeds


def spec_slice(dev, seed, model, checks, card, samples, greedy, embeds):
    """Phase 4: speculative generate at full width, lookup and oracle drafts."""
    import torch

    from myriad_tpu_torch.generation import (GenerationConfig, _lookup_drafts, _prefill,
                                             speculative_generate)
    from myriad_tpu_torch.models.llama import init_cache, set_frontier
    from myriad_tpu_torch.models.myriad import Myriad

    spec = Myriad.from_config({**SERVING, "llm_spec_k": SPEC_K}, device=dev,
                              class_names=SCENES)
    check(spec.spec_k == SPEC_K, "from_config did not read llm_spec_k")
    spec.load_state_dicts(model.module.state_dict(), model.vision_expert.module.state_dict())
    spec.vision_expert.build_text_features()
    warm = spec.generate(samples, max_new_tokens=4)
    check("spec_stats" in warm, "llm_spec_k did not route generate to speculative decoding")
    llama = spec.module.llama
    vocab = spec.arch.llama.vocab_size

    def oracle_generate(drafts):
        """Myriad._generate_fused with ``drafts`` as the oracle drafts."""
        with torch.inference_mode():
            image, question, _, maps, _ = spec.prepare_sample(samples, 1)
            before, after = spec.split_prompt(question)
            x = spec.module.prefill_embeds(image, maps, before, after, 1, add_bos=False)
            tokens, stats = speculative_generate(
                llama, x, config=GenerationConfig(max_new_tokens=NEW_TOKENS), spec_k=SPEC_K,
                oracle_drafts=drafts, cache_dtype="int8", return_stats=True)
        return {"token_ids": tokens, "spec_stats": stats}

    needs = ["B1 int8_matmul", "B3 prefill_attention", "B4 kv_write"]
    runs = [("prompt-lookup drafts (Myriad.generate)", "spec_lookup",
             lambda: spec.generate(samples, max_new_tokens=NEW_TOKENS)),
            ("oracle drafts = phase 3's greedy transcript", "spec_oracle_greedy",
             lambda: oracle_generate(greedy)),
            ("oracle drafts = the lookup run's own transcript", "spec_oracle_self",
             lambda: oracle_generate(own))]
    own = None
    for label, path, fn in runs:
        out, wall, counts = drive(checks, path, fn, needs)
        tokens, stats = out["token_ids"], out["spec_stats"]
        if own is None:
            own, lookup_wall = tokens, wall
        check_tokens(tokens, BATCH, NEW_TOKENS, vocab)
        check(stats["rounds"] > 0 and stats["drafted"] > 0, "no verify round ran")
        same = (tokens == greedy).float().mean().item()
        print(f"speculative generate, {label}: {BATCH / wall:.4f} images/s ({wall:.3f} s, one "
              f"run, host clock after synchronize; {BATCH} images, {NEW_TOKENS} new tokens, "
              f"K={SPEC_K}); spec_stats {stats}, acceptance "
              f"{stats['accepted'] / max(stats['drafted'], 1):.4f}; launches "
              f"{ {n: counts[n] for n in needs} }; tokens identical to phase 3's greedy: "
              f"{same:.4f}, to the lookup run's: {(tokens == own).float().mean().item():.4f} "
              f"(reported, not required); card: {card}", flush=True)

    # the first verify round, kernels against the plain path: the same feed
    # (the kernels' own first token and lookup drafts) on both sides
    with torch.inference_mode():
        before, after = spec.split_prompt(AQA_QUESTION)
        lookup = spec._spec_lookup_ids(after)[None].expand(BATCH, -1)
        p = embeds.shape[1]
        max_len = p + NEW_TOKENS + SPEC_K + 1

        def prefill(x):
            cache = init_cache(llama.config, BATCH, max_len, "int8", dev)
            return cache, _prefill(llama, x, cache, 1)

        _, logits = prefill(embeds)
        last = logits[:, -1].float().argmax(-1)
        prev = torch.full_like(last, -1)
        draft = _lookup_drafts(lookup, prev, last, torch.full_like(last, lookup.shape[1]),
                               SPEC_K).clamp(0, vocab - 1)
        feed = torch.cat([last[:, None], draft], dim=1)

        def verify(x):
            cache, _ = prefill(x)
            set_frontier(cache, torch.full((BATCH,), p, dtype=torch.int32, device=dev))
            return llama(llama.embed(feed), cache).float()

        sensitivity_gate(f"first verify round logits ({BATCH}x{SPEC_K + 1} positions after a "
                         f"{p}-position prefix)", verify(embeds), verify, embeds, seed)
    return spec, lookup_wall


def chat_slice(dev, seed, model, checks, card):
    """Phase 5: three scripted chat turns at full width on the resident cache."""
    import numpy as np
    import torch

    from myriad_tpu_torch.conversation import CONV_VISION, Chat

    rng = np.random.default_rng(seed + 2)
    size = model.arch.img_size
    image = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
    llama = model.module.llama
    vocab = model.arch.llama.vocab_size
    for spec_k in (0, SPEC_K):
        chat = Chat(model, incremental=True, spec_k=spec_k)
        conv = CONV_VISION.copy()
        img_list = []
        _, t_up = timed(lambda: chat.upload_img(image, conv, img_list))
        print(f"chat (spec_k={spec_k}): image uploaded in {t_up:.4f} s (VE maps + encode_img)",
              flush=True)
        needs = ["B1 int8_matmul", "B3 prefill_attention", "B4 kv_write"]
        if spec_k == 0:
            needs.append("B2 decode_attention")
        for turn, question in enumerate(CHAT_QUESTIONS):
            chat.ask(question, conv)
            if turn == 1 and spec_k == 0:
                _chat_delta_gate(chat, conv, img_list, llama, dev, seed)
            (text, tokens), wall, counts = drive(
                checks, f"chat_spec{spec_k}_turn{turn + 1}",
                lambda: chat.answer(conv, img_list, max_new_tokens=CHAT_TOKENS), needs)
            check_tokens(torch.as_tensor(tokens), 1, CHAT_TOKENS, vocab)
            print(f"  turn {turn + 1}: {wall:.4f} s (host clock after synchronize; prefill of "
                  f"{chat._delta_log[-1]} positions at frontier "
                  f"{chat._frontier - chat._delta_log[-1]}, {CHAT_TOKENS} new tokens); launches "
                  f"{counts}; answer {len(text)} chars; card: {card}", flush=True)


def _chat_delta_gate(chat, conv, img_list, llama, dev, seed):
    """Turn 2's delta prefill on a copy of the resident cache (turn 1's decode
    scratch included) against a full re-prefill of the same prompt into a
    fresh cache.  The re-prefill runs as two chunks split at the frontier
    (chunked prefill is exact by construction) so that each row takes the
    projection route it takes on the resident path: in one chunk of more than
    256 rows the delta's rows would go through W8A8 instead of B1, a
    difference of route, not of the cache.  The one-chunk re-prefill is
    printed beside it."""
    import torch

    from myriad_tpu_torch.models.llama import init_cache

    with torch.inference_mode():
        probe = conv.copy()
        probe.append_message(probe.roles[1], None)  # as answer() does
        units, _ = chat._context_units(probe, img_list)
        frontier = chat._frontier
        check(units[:frontier] == chat._units[:frontier] and len(units) > frontier,
              "turn 2 does not extend the cached prompt")
        cache = [{k: (v.clone() if torch.is_tensor(v) else v) for k, v in layer.items()}
                 for layer in chat._cache]
        delta = chat._embed_units(units[frontier:], img_list)
        delta_logits = llama.prefill(delta, cache)[:, -1].float()
        full = chat.get_context_emb(probe, img_list)

        def reprefill(x, split=True):
            fresh = init_cache(llama.config, 1, chat._bucket, chat._cache_dtype(), dev)
            if split:
                llama.prefill(x[:, :frontier], fresh)
                x = x[:, frontier:]
            return llama.prefill(x, fresh)[:, -1].float()

        err = rel(delta_logits, reprefill(full))
        one_chunk = rel(delta_logits, reprefill(full, split=False))
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        noise = torch.randn(full.shape, generator=g, device=dev) * 2.0 ** -9
        with plain_path():
            plain = reprefill(full)
            floor = rel(reprefill((full.float() * (1.0 + noise)).to(full.dtype)), plain)
        print(f"chat turn 2: delta prefill of {len(units) - frontier} positions at frontier "
              f"{frontier} on the resident cache vs a full re-prefill of {len(units)}: "
              f"rel_l2={err:.4e} (split at the frontier), {one_chunk:.4e} (one chunk, "
              f"reported); plain vs plain with noisy input rel_l2={floor:.4e}; tol=2x that",
              flush=True)
        check(bool(torch.isfinite(delta_logits).all()), "chat turn 2: non-finite logits")
        check(err <= 2.0 * floor, "chat turn 2: delta prefill disagrees with a full re-prefill")


KERNEL_OF = {"int8_matmul_tc_kernel": "B1", "decode_attention_cluster_kernel": "B2",
             "prefill_attention_tc_kernel": "B3", "prefill_attention_split_kernel": "B3",
             "prefill_attention_merge_kernel": "B3", "kv_write_kernel": "B4",
             "kv_quantize_write_kernel": "B4", "kv_quantize_write_rows_kernel": "B4",
             "int4_matmul_tc_kernel": "B5",
             "decode_attention_rows_split_kernel": "B2'",
             "decode_attention_rows_merge_kernel": "B2'"}


def profile_generate(model, samples, card, wall_unprofiled, label):
    """One ``model.generate`` under torch.profiler: device time by kernel,
    and the device's busy share of an unprofiled run's wall time.  Only
    device activity is traced, and only the raw events are read."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: model.generate(samples, max_new_tokens=NEW_TOKENS))
    t0 = time.perf_counter()
    # the raw device events, summed by name: key_averages() would first build a
    # Python event tree of every launch (~115,000 a generate), 30-40 s a read
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation():
            us, n = sums.get(e.name(), (0.0, 0))
            sums[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    rows = [(us, n, key) for key, (us, n) in sums.items() if us > 0]
    total = sum(r[0] for r in rows)
    check(total > 0, "the profiler recorded no device time")
    print(f"profile of one {label} ({BATCH} images, {NEW_TOKENS} new tokens): device time "
          f"{total / 1e3:.1f} ms in all; "
          f"profiled wall {wall:.3f} s; device busy {total / 1e6 / wall_unprofiled:.3f} of the "
          f"unprofiled run's {wall_unprofiled:.3f} s; trace read in "
          f"{time.perf_counter() - t0:.1f} s; card: {card}")
    by_kernel = {}
    for us, _, key in rows:
        tag = next((k for name, k in KERNEL_OF.items() if name in key), "other")
        by_kernel[tag] = by_kernel.get(tag, 0.0) + us
    print("  by kernel: " + ", ".join(f"{k} {v / 1e3:.1f} ms ({v / total:.3f})"
                                      for k, v in sorted(by_kernel.items())))
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {us / 1e3:9.1f} ms {us / total:6.3f} {count:7d} calls  {key[:90]}")


def _samples(seed, size, batch=BATCH, scenes=SCENES):
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, size=(batch, size, size, 3), dtype=np.uint8),
            "scene": [scenes[i % len(scenes)] for i in range(batch)],
            "question2": [AQA_QUESTION] * batch}


def int4_slice(dev, seed, checks, card):
    """Phase 6: the int4 serving configuration at full width, through B5."""
    import torch

    from myriad_tpu_torch.conversation import CONV_VISION, Chat
    from myriad_tpu_torch.generation import _prefill
    from myriad_tpu_torch.models.llama import init_cache, serving_cache_dtype
    from myriad_tpu_torch.models.myriad import Myriad

    int4 = {**SERVING, "llm_weight_dtype": "int4"}
    t0 = time.time()
    model = Myriad.from_config(int4, device=dev, class_names=SCENES)
    check(model.arch.llama.weight_dtype == "int4", "from_config did not read int4")
    model.init_random(seed)
    model.vision_expert.build_text_features()
    torch.cuda.synchronize()
    print(f"full-width Myriad with int4 LLM weights built (seed {seed}) in "
          f"{time.time() - t0:.1f} s", flush=True)
    samples = _samples(seed, model.arch.img_size)
    model.generate(samples, max_new_tokens=4)  # warm-up
    vocab = model.arch.llama.vocab_size
    b5, b1 = "B5 int4_matmul", "B1 int8_matmul"

    torch.cuda.reset_peak_memory_stats(dev)
    out, wall0, launches = drive(
        checks, "int4_greedy", lambda: model.generate(samples, max_new_tokens=NEW_TOKENS),
        [b5, "B2 decode_attention", "B3 prefill_attention", "B4 kv_write"])
    check(launches[b1] == 0, f"the int4 greedy path launched B1 {launches[b1]} times")
    for c in checks:
        if c.name == b5:
            c.launches = launches[b5]
    walls = [wall0] + [timed(lambda: model.generate(samples, max_new_tokens=NEW_TOKENS))[1]
                       for _ in range(2)]
    wall = statistics.median(walls)
    peak = torch.cuda.max_memory_allocated(dev)
    check_tokens(out["token_ids"], BATCH, NEW_TOKENS, vocab)
    print(f"int4 generate: launches {launches}")
    profile_generate(model, samples, card, wall0, "int4 greedy generate")
    print(f"int4 throughput: {BATCH / wall:.4f} images/s, median of 3 runs ({BATCH} images, "
          f"{NEW_TOKENS} new tokens; wall s {', '.join(f'{w:.3f}' for w in walls)}, host clock "
          f"after synchronize); peak device memory {peak / 2**30:.2f} GiB; card: {card}",
          flush=True)

    with torch.inference_mode():
        image = torch.as_tensor(samples["image"], device=dev)
        ve = model.vision_expert
        (maps, _), t_ve = timed(lambda: ve.module.zero_shot(
            image, ve._text_feats[ve.scene_ids(samples["scene"])]))
        before, after = model.split_prompt(AQA_QUESTION)
        embeds, t_enc = timed(lambda: model.module.prefill_embeds(
            image, maps, before, after, 1, add_bos=False))
        p = embeds.shape[1]
        llama = model.module.llama
        cache_dtype = serving_cache_dtype(model.arch.llama, model.policy.compute_dtype)
        cache = init_cache(llama.config, BATCH, p + NEW_TOKENS, cache_dtype, dev)
        _, t_pre = timed(lambda: _prefill(llama, embeds, cache, 1))
        del cache
        print(f"int4 stage times (host clock, synchronized, one run each): VE maps {t_ve:.4f} s, "
              f"encode_img + prefix {t_enc:.4f} s, prefill {t_pre:.4f} s (one chunk of "
              f"{BATCH * p} rows: every projection requantized to int8, then W8A8), decode "
              f"loop (the rest of the median generate) ~{wall - t_ve - t_enc - t_pre:.4f} s",
              flush=True)

        def prefill(chunks):
            def run(x):
                cache = init_cache(llama.config, BATCH, p + NEW_TOKENS, cache_dtype, dev)
                return _prefill(llama, x, cache, chunks)[:, -1].float()
            return run

        # one chunk: 2376 rows take the requantize + W8A8 route; ten chunks of
        # <= 240 rows take B5
        for label, chunks in (("1 chunk", 1), ("10 chunks", 10)):
            sensitivity_gate(f"int4 prefill logits ({p} positions, {label})",
                             prefill(chunks)(embeds), prefill(chunks), embeds, seed)

    spec = Myriad.from_config({**int4, "llm_spec_k": SPEC_K}, device=dev, class_names=SCENES)
    spec.load_state_dicts(model.module.state_dict(), model.vision_expert.module.state_dict())
    spec.vision_expert.build_text_features()
    spec.generate(samples, max_new_tokens=4)  # warm-up
    out, wall, launches = drive(checks, "int4_spec_lookup",
                                lambda: spec.generate(samples, max_new_tokens=NEW_TOKENS),
                                [b5, "B3 prefill_attention", "B4 kv_write"])
    check(launches[b1] == 0, f"the int4 speculative path launched B1 {launches[b1]} times")
    check_tokens(out["token_ids"], BATCH, NEW_TOKENS, vocab)
    stats = out["spec_stats"]
    print(f"int4 speculative generate, prompt-lookup drafts: {BATCH / wall:.4f} images/s "
          f"({wall:.3f} s, one run; K={SPEC_K}); spec_stats {stats}; launches {launches}; "
          f"card: {card}", flush=True)
    profile_generate(spec, samples, card, wall,
                     f"int4 speculative generate (prompt-lookup drafts, K={SPEC_K})")
    del spec

    import numpy as np

    chat = Chat(model, incremental=True)
    conv = CONV_VISION.copy()
    img_list = []
    chat.upload_img(np.random.default_rng(seed + 2).integers(
        0, 256, size=(model.arch.img_size, model.arch.img_size, 3), dtype=np.uint8),
        conv, img_list)
    chat.ask(CHAT_QUESTIONS[0], conv)
    (text, tokens), wall, launches = drive(
        checks, "int4_chat_turn1",
        lambda: chat.answer(conv, img_list, max_new_tokens=CHAT_TOKENS),
        [b5, "B2 decode_attention", "B3 prefill_attention", "B4 kv_write"])
    check(launches[b1] == 0, f"the int4 chat turn launched B1 {launches[b1]} times")
    check_tokens(torch.as_tensor(tokens), 1, CHAT_TOKENS, vocab)
    print(f"int4 chat turn 1: {wall:.4f} s (batch 1, prefill of {chat._delta_log[-1]} "
          f"positions, {CHAT_TOKENS} new tokens); launches {launches}; card: {card}", flush=True)
    del chat
    return model, samples


def entry_point_slice(dev, seed, checks, card, model, samples):
    """Phase 7: row decode (B2'), device_preprocess (B6) and the bandwidth
    probe (B7), each through the entry point a user calls."""
    import torch

    from myriad_tpu_torch.generation import _prefill
    from myriad_tpu_torch.models.llama import init_cache, serving_cache_dtype
    from myriad_tpu_torch.ops.preprocess import device_preprocess, u8_normalize_rows_plain
    from myriad_tpu_torch.tools import bwprobe

    names = {c.name: c for c in checks}
    b2r, b2 = "B2' decode_attention_rows", "B2 decode_attention"
    os.environ["MYRIAD_DECODE_ATTN"] = "row"
    try:
        out, wall, launches = drive(
            checks, "row_greedy", lambda: model.generate(samples, max_new_tokens=NEW_TOKENS),
            [b2r])
        check(launches[b2] == 0, f"the row-decode path launched B2 {launches[b2]} times")
        names[b2r].launches = launches[b2r]
        check_tokens(out["token_ids"], BATCH, NEW_TOKENS, model.arch.llama.vocab_size)
        print(f"MYRIAD_DECODE_ATTN=row greedy generate (int4 model): {BATCH / wall:.4f} "
              f"images/s ({wall:.3f} s, one run); launches {launches}; card: {card}",
              flush=True)

        with torch.inference_mode():
            image = torch.as_tensor(samples["image"], device=dev)
            ve = model.vision_expert
            maps, _ = ve.module.zero_shot(image, ve._text_feats[ve.scene_ids(samples["scene"])])
            before, after = model.split_prompt(AQA_QUESTION)
            embeds = model.module.prefill_embeds(image, maps, before, after, 1, add_bos=False)
            p = embeds.shape[1]
            llama = model.module.llama
            cache_dtype = serving_cache_dtype(model.arch.llama, model.policy.compute_dtype)
            bucket = -(-(p + NEW_TOKENS) // 32) * 32
            cache = init_cache(llama.config, BATCH, bucket, cache_dtype, dev)
            first = _prefill(llama, embeds, cache, 1)[:, -1].float().argmax(-1)

            def step(x):
                cache = init_cache(llama.config, BATCH, bucket, cache_dtype, dev)
                _prefill(llama, x, cache, 1)
                return llama(llama.embed(first[:, None]), cache)[:, -1].float()

            sensitivity_gate(f"first row-decode step logits (kv_len {bucket}, B2' vs plain)",
                             step(embeds), step, embeds, seed)
    finally:
        del os.environ["MYRIAD_DECODE_ATTN"]

    image = torch.as_tensor(samples["image"], device=dev)
    normed, wall, launches = drive(
        checks, "device_preprocess",
        lambda: device_preprocess(image, use_pallas=True, out_dtype=torch.bfloat16),
        ["B6 u8_normalize"])
    names["B6 u8_normalize"].launches = launches["B6 u8_normalize"]
    check(torch.equal(normed, u8_normalize_rows_plain(image, out_dtype=torch.bfloat16)),
          "device_preprocess disagrees with the plain normalisation")
    print(f"device_preprocess(use_pallas=True) on {tuple(image.shape)}: {wall * 1e3:.3f} ms "
          f"(host clock, one call); launches {launches}", flush=True)

    def probe():
        return [bwprobe.probe(PROBE_GIB, "int8", 8, impl, 512, dev)
                for impl in ("cuda", "cuda2", "torch")]

    results, wall, launches = drive(checks, "bwprobe", probe, ["B7 stream_sum"])
    names["B7 stream_sum"].launches = launches["B7 stream_sum"]
    for r in results:  # the probe streams ones: every pass sums to a positive total
        check(all(s > 0 for s in r["sums"]), f"bwprobe {r['impl']}: bad sums")
    print(f"bandwidth probe (python -m myriad_tpu_torch.tools.bwprobe, CUDA events over 8 "
          f"passes of {PROBE_GIB} GiB): " + ", ".join(f"{r['impl']} {r['gb_per_s']:.1f} GB/s"
                                          for r in results) + f"; launches {launches}",
          flush=True)


EVAL_CLASSES = (("bottle", 900, 3), ("screw", 1024, 1))  # MVTec's sizes; screw is gray
EVAL_PER_CLASS = 12
# train/good PNGs a class: the one-shot references of phase 11 (screw has
# fewer than 4, so its bank is zero-padded at --k_shot 4)
EVAL_TRAIN_GOOD = {"bottle": 4, "screw": 2}
# --options of phase 8 over eval_configs/myriad.yaml (the serving profile of SERVING)
EVAL_OPTIONS = ["model.llm_weight_dtype=int8", "model.llm_kv_dtype=int8"]


def write_eval_tree(root, seed):
    """A synthetic MVTec AD test tree: ``EVAL_PER_CLASS`` PNGs a class (half
    anomalous, a dark square), each row with a random filter type, and the
    ``DC_MVTEC_test_normal.jsonl`` annotation, with ``EVAL_TRAIN_GOOD``
    normal PNGs a class under ``train/good`` (the one-shot references).
    Returns {class: a file}."""
    import numpy as np

    from myriad_tpu_torch.datasets.png import encode_png

    rng = np.random.default_rng(seed)
    rows, files = [], {}
    for cls, size, channels in EVAL_CLASSES:
        yy, xx = np.mgrid[0:size, 0:size]
        base = np.stack([(xx // 4 + c * 40) % 256 for c in range(channels)], -1) // 2 + 60
        for i in range(EVAL_PER_CLASS):
            anomalous = i % 2 == 1
            sub = "broken_large" if anomalous else "good"
            img = (base + rng.integers(0, 24, base.shape)).astype(np.uint8)
            if anomalous:
                img[size // 3:size // 2, size // 3:size // 2] = 10
            rel = f"mvtec/{cls}/test/{sub}/{i:03d}.png"
            os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
            with open(os.path.join(root, rel), "wb") as f:
                f.write(encode_png(img[..., 0] if channels == 1 else img,
                                   filters=rng.integers(0, 5, size), idat_chunks=3, level=1))
            rows.append({"img_path": rel, "caption": "", "is_anomaly": "1" if anomalous else "0"})
            files.setdefault(cls, os.path.join(root, rel))
        for i in range(EVAL_TRAIN_GOOD[cls]):
            img = (base + rng.integers(0, 24, base.shape)).astype(np.uint8)
            rel = f"mvtec/{cls}/train/good/{i:03d}.png"
            os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
            with open(os.path.join(root, rel), "wb") as f:
                f.write(encode_png(img[..., 0] if channels == 1 else img,
                                   filters=rng.integers(0, 5, size), idat_chunks=3, level=1))
    with open(os.path.join(root, "DC_MVTEC_test_normal.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return files


def _host_ms(fn, repeats=3):
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def eval_slice(dev, seed, checks, card):
    """Phase 8: the AQA evaluation entry point at full width on a synthetic
    tree.  Returns (model, argv, evaluate.run's output, the tree's dataset):
    the later phases' direct generates read that dataset, built once (its
    preload decodes every PNG)."""
    import numpy as np
    import torch

    from myriad_tpu_torch import evaluate
    from myriad_tpu_torch.common.config import Config
    from myriad_tpu_torch.datasets.loaders import DataLoader
    from myriad_tpu_torch.datasets.png import read_png
    from myriad_tpu_torch.processors import functional as F

    root = os.path.join(REPO, "build", "aqa_eval")
    t0 = time.time()
    files = write_eval_tree(root, seed)
    n_images = EVAL_PER_CLASS * len(EVAL_CLASSES)
    print(f"wrote {n_images} PNGs under {root} in {time.time() - t0:.1f} s", flush=True)
    for cls, size, channels in EVAL_CLASSES:
        img = read_png(files[cls])
        check(img.shape == (size, size, 3), f"{files[cls]} decoded to {img.shape}")
        dec = _host_ms(lambda: read_png(files[cls]))
        rsz = _host_ms(lambda: F.center_crop(F.resize_bicubic(img, 224), 224))
        print(f"host, one thread, median of 3: PNG decode {dec:.1f} ms, resize + centre crop to "
              f"224 {rsz:.1f} ms per {size}x{size} {'RGB' if channels == 3 else 'gray'} image",
              flush=True)

    argv = ["--cfg-path", os.path.join(REPO, "eval_configs", "myriad.yaml"),
            "--bs", str(BATCH), "--greedy", "--bench", "--max_new_tokens", str(NEW_TOKENS),
            "--save_path", os.path.join(root, "rows.jsonl"),
            "--options", *EVAL_OPTIONS, f"model.seed={seed}",
            f"datasets.anomaly_detection.build_info.storage={root}"]
    args = evaluate.parse_args(argv)
    cfg = Config(args)
    t0 = time.time()
    model = evaluate.build_model(args, cfg)
    torch.cuda.synchronize()
    check(model.device.type == dev.type, f"evaluate built its model on {model.device}")
    check(model.arch.llama.weight_dtype == "int8" and model.arch.llama.kv_cache_dtype == "int8",
          "the --options did not reach the model")
    print(f"evaluate.build_model: full width, int8 LLM weights and KV, seed {seed}, "
          f"{time.time() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    needs = ["B1 int8_matmul", "B2 decode_attention", "B3 prefill_attention", "B4 kv_write"]
    out, wall, launches = drive(checks, "aqa_eval", lambda: evaluate.run(args, cfg, model), needs)
    peak = evaluate.device_mem_mb(dev)
    rows, bench = out["rows"], out["bench"]
    check(len(rows) == n_images, f"{len(rows)} rows for {n_images} images")
    keys = ["image_id", "image_path", "is_anomaly", "output", "error", "anomaly_score"]
    for i, row in enumerate(rows):
        check(list(row) == keys and row["image_id"] == i and row["error"] in ("0", "1")
              and 0.0 <= float(row["anomaly_score"]) <= 1.0, f"row {i}: {row}")
    check(bench is not None and bench["batches"] == n_images // BATCH - 1,
          "no --bench line for three batches")
    # batches 2-3 took at least their two generates
    check(bench["value"] <= BATCH / bench["phase_means_s"]["dispatch"] * 1.01,
          f"--bench value {bench['value']} is faster than the generates it timed")
    print(f"evaluate.run: {len(rows)} rows in {wall:.3f} s (host clock, synchronized, "
          f"decode and model included); launches {launches}; peak device memory "
          f"{peak:.1f} MiB; card: {card}", flush=True)
    print(f"aqa eval --bench: {json.dumps(bench)}", flush=True)
    print(f"aqa eval phase means (s, batches 2-3): {bench['phase_means_s']}; first batch: "
          + ", ".join(f"{k} {v[0]:.3f}" for k, v in out["phases"].items()), flush=True)

    # the eval's tokens against a direct generate on the same collated batches
    dataset = evaluate.build_dataset(args, cfg.datasets_cfg, root)
    same = 0
    for batch, tokens in zip(DataLoader(dataset, batch_size=BATCH), out["token_ids"]):
        direct = model.generate(batch, max_new_tokens=NEW_TOKENS, do_sample=False)
        direct = direct["token_ids"].cpu().numpy()
        check_tokens(torch.as_tensor(direct), BATCH, NEW_TOKENS, model.arch.llama.vocab_size)
        check(np.array_equal(direct, tokens), "evaluate's tokens differ from a direct generate")
        same += len(tokens)
    check(same == n_images, f"compared {same} of {n_images} rows with a direct generate")
    print(f"tokens of all {same} rows identical to a direct Myriad.generate on the same "
          f"batches", flush=True)
    return model, argv, out, dataset


# phase 9: the engine's load (requests over the eval's slots, arrivals a tick)
# and the prefix lengths that make widths 320, 160 and 64 admit
ENGINE_REQUESTS, ENGINE_SEGMENT, ENGINE_ARRIVALS = 24, 32, 4
ENGINE_WIDTHS, ENGINE_CUTS, ENGINE_ADMIT_CHUNK = (64, 160, 320), (None, 120, 50), 8


def _engine_bucket(spec_k):
    """ServingEngine's bucket rule of MyriadServing: 416 greedy, 448 with K = 3."""
    return -(-(max(ENGINE_WIDTHS) + NEW_TOKENS + 2 * spec_k + 1) // 32) * 32


def _engine_prompts(model, seed, dev):
    """Eight images' AQA prefixes (the eval's 297 positions at full width),
    and the requests: request i takes image i % 8, cut to ENGINE_CUTS[i % 3]."""
    import torch

    samples = _samples(seed + 3, model.arch.img_size)
    ve = model.vision_expert
    scenes = [ve.class_names[i % len(ve.class_names)] for i in range(BATCH)]
    with torch.inference_mode():
        image = torch.as_tensor(samples["image"], device=dev)
        maps, _ = ve.module.zero_shot(image, ve._text_feats[ve.scene_ids(scenes)])
        before, after = model.split_prompt(AQA_QUESTION)
        embeds = model.module.prefill_embeds(image, maps, before, after, 1, add_bos=False)
    prompts = [embeds[i % BATCH, :ENGINE_CUTS[i % 3]] for i in range(ENGINE_REQUESTS)]
    return embeds, prompts, after


def _engine_run(llama, prompts, spec_k=0, lookup=None, profile=False):
    """One run of the engine's schedule: ENGINE_ARRIVALS submits a tick until
    every request is in, ticks until it drains.  Returns (engine, {request id:
    Finished}, [(width, rows) of each admission chunk])."""
    from myriad_tpu_torch.generation import GenerationConfig
    from myriad_tpu_torch.serving import ServingEngine

    eng = ServingEngine(llama, slots=BATCH, bucket=_engine_bucket(spec_k),
                        config=GenerationConfig(max_new_tokens=NEW_TOKENS), cache_dtype="int8",
                        segment=ENGINE_SEGMENT, admit_widths=ENGINE_WIDTHS,
                        max_admit_chunk=ENGINE_ADMIT_CHUNK, spec_k=spec_k, lookup_ids=lookup)
    eng.profile_sync = profile
    chunks, admit = [], eng._admit_rows

    def admit_rows(width, slot_list, *rest):
        chunks.append((width, len(slot_list)))
        return admit(width, slot_list, *rest)
    eng._admit_rows = admit_rows
    done, queue = {}, list(enumerate(prompts))
    while queue or eng.pending:
        for _ in range(ENGINE_ARRIVALS):
            if queue:
                i, x = queue.pop(0)
                eng.submit(x, request_id=i)
        done.update((f.request_id, f) for f in eng.step())
        check(eng.stats["ticks"] < 1000, "the engine did not drain")
    return eng, done, chunks


def _check_engine_launches(counts, chunks, steps, spec_k, layers, label):
    """Every forward of the engine launches B3 (a chunk of several rows) or B2
    (one decode row) once a layer and B4 once a layer; B1 serves the seven
    projections of a layer where the forward has at most 256 rows."""
    from myriad_tpu_torch.ops.quant import SMALL_M

    rows = BATCH * (spec_k + 1)
    small = sum(1 for w, n in chunks if w * n <= SMALL_M) + (steps if rows <= SMALL_M else 0)
    want = {"B1 int8_matmul": layers * 7 * small,
            "B2 decode_attention": 0 if spec_k else layers * steps,
            "B3 prefill_attention": layers * (len(chunks) + (steps if spec_k else 0)),
            "B4 kv_write": layers * (len(chunks) + steps)}
    print(f"  {label}: launches {counts}; expected from {len(chunks)} admission chunks "
          f"{chunks} and {steps} {'rounds' if spec_k else 'steps'}: {want}", flush=True)
    for name, n in want.items():
        check(counts[name] == n, f"{label}: {name} launched {counts[name]} times, not {n}")


def engine_slice(dev, seed, checks, card, model, eval_argv, eval_out):
    """Phase 9: the continuous-batching engine at full width on phase 8's model."""
    import numpy as np
    import torch

    from myriad_tpu_torch import evaluate
    from myriad_tpu_torch.common.config import Config
    from myriad_tpu_torch.generation import GenerationConfig, greedy_generate, trim_stop_ids
    from myriad_tpu_torch.models.llama import set_frontier
    from myriad_tpu_torch.serving import MyriadServing, ServingEngine

    llama = model.module.llama
    vocab, layers = model.arch.llama.vocab_size, model.arch.llama.num_layers
    cfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    needs = ["B1 int8_matmul", "B2 decode_attention", "B3 prefill_attention", "B4 kv_write"]
    embeds, prompts, after = _engine_prompts(model, seed, dev)
    p = embeds.shape[1]
    print(f"engine requests: {ENGINE_REQUESTS} over {BATCH} slots, prefixes of "
          f"{sorted({x.shape[0] for x in prompts})} positions, {ENGINE_ARRIVALS} arrivals a "
          f"tick, segment {ENGINE_SEGMENT}, widths {ENGINE_WIDTHS}, chunks of at most "
          f"{ENGINE_ADMIT_CHUNK}, bucket {_engine_bucket(0)}", flush=True)

    # (a) greedy: launches, determinism, the first step after a mixed admission
    (eng, done, chunks), wall, counts = drive(checks, "engine_greedy",
                                              lambda: _engine_run(llama, prompts, profile=True),
                                              needs)
    st = eng.stats
    check(sorted(done) == list(range(ENGINE_REQUESTS)), f"finished {sorted(done)}")
    for f in done.values():
        check(f.tokens.size <= NEW_TOKENS and f.raw_tokens.size <= NEW_TOKENS
              and bool(((f.raw_tokens >= 0) & (f.raw_tokens < vocab)).all()),
              f"request {f.request_id}: bad tokens")
        check(list(f.tokens) == trim_stop_ids(f.raw_tokens, cfg), "trim disagrees")
    _check_engine_launches(counts, chunks, st["decode_steps"], 0, layers, "engine greedy")
    occupancy = st["live_row_steps"] / max(st["decode_steps"] * BATCH, 1)
    print(f"engine greedy: {ENGINE_REQUESTS / wall:.4f} images/s ({wall:.3f} s, host clock "
          f"after synchronize, profile_sync on; LLM only, embeds made beforehand); stats "
          f"{ {k: (round(v, 4) if isinstance(v, float) else v) for k, v in st.items()} }; "
          f"slot occupancy {occupancy:.4f}; admit {st['admit_wall_s']:.3f} s, decode "
          f"{st['decode_wall_s']:.3f} s; card: {card}", flush=True)
    (_, again, _), wall2 = timed(lambda: _engine_run(llama, prompts))
    same = all(np.array_equal(again[i].raw_tokens, done[i].raw_tokens) for i in done)
    print(f"engine greedy, the same schedule again (profile_sync off): {wall2:.3f} s, "
          f"{ENGINE_REQUESTS / wall2:.4f} images/s; transcripts bit-identical: {same}",
          flush=True)
    check(same, "two runs of one engine schedule gave different transcripts")
    # the same 24 prompts as three fixed batches of one length each, in this call
    solo, fixed_wall = {}, 0.0
    with torch.inference_mode():
        for cut in ENGINE_CUTS:
            toks, t = timed(lambda: greedy_generate(llama, embeds[:, :cut], config=cfg,
                                                    cache_dtype="int8"))
            fixed_wall += t
            for i in range(ENGINE_REQUESTS):
                if ENGINE_CUTS[i % 3] == cut:
                    solo[i] = trim_stop_ids(toks[i % BATCH].cpu().numpy(), cfg)
    agree = sum(list(done[i].tokens) == solo[i] for i in done)
    print(f"the same {ENGINE_REQUESTS} prompts as three fixed batches of 8 through "
          f"greedy_generate: {ENGINE_REQUESTS / fixed_wall:.4f} images/s ({fixed_wall:.3f} s, "
          f"host clock after synchronize) against the engine's {ENGINE_REQUESTS / wall:.4f} and "
          f"{ENGINE_REQUESTS / wall2:.4f}; transcripts equal for {agree} of {ENGINE_REQUESTS} "
          f"requests (reported, not required: B2 reads the whole bucket here and stages there, "
          f"and random weights are chaotic); card: {card}", flush=True)

    # the first decode step after a mixed admission (a width-320 chunk of four
    # and a width-64 chunk of four): kernels against the plain path
    valid = np.array([p, 250, p, 180, 50, 64, 33, 50])
    mixed = torch.zeros((BATCH, max(ENGINE_WIDTHS), embeds.shape[2]), dtype=embeds.dtype,
                        device=dev)
    for i, n in enumerate(valid):
        mixed[i, :n] = embeds[i, :n]

    def first_step(x):
        e = ServingEngine(llama, slots=BATCH, bucket=_engine_bucket(0), config=cfg,
                          cache_dtype="int8", admit_widths=ENGINE_WIDTHS,
                          max_admit_chunk=ENGINE_ADMIT_CHUNK)
        e.submit_group(x[:4], valid[:4])
        e.submit_group(x[4:, :64].contiguous(), valid[4:])
        e._admit_pending()
        state = e._state
        set_frontier(state["cache"], state["length"])
        with torch.inference_mode():
            return llama(llama.embed(state["last"][:, None]), state["cache"])[:, -1].float()

    sensitivity_gate(f"first engine decode step after a mixed admission (frontiers "
                     f"{valid.tolist()}, kv_len {_engine_bucket(0)})", first_step(mixed),
                     first_step, mixed, seed)

    # (b) speculative rounds with the AQA answer corpus as the lookup
    lookup = model._spec_lookup_ids(after).cpu().numpy()
    (eng, done_k, chunks), wall, counts = drive(
        checks, "engine_spec", lambda: _engine_run(llama, prompts, SPEC_K, lookup, True),
        ["B1 int8_matmul", "B3 prefill_attention", "B4 kv_write"])
    st = eng.stats
    check(sorted(done_k) == list(range(ENGINE_REQUESTS)), "speculative engine: not all finished")
    _check_engine_launches(counts, chunks, st["decode_steps"], SPEC_K, layers, "engine spec")
    spec_same = sum(np.array_equal(done_k[i].tokens, done[i].tokens) for i in done)
    print(f"engine spec K={SPEC_K}: {ENGINE_REQUESTS / wall:.4f} images/s ({wall:.3f} s); "
          f"acceptance {st['spec_accepted'] / max(st['spec_drafted'], 1):.4f} "
          f"({st['spec_accepted']} of {st['spec_drafted']}), {st['decode_steps']} rounds, "
          f"occupancy {st['live_row_steps'] / max(st['decode_steps'] * BATCH, 1):.4f}; admit "
          f"{st['admit_wall_s']:.3f} s, decode {st['decode_wall_s']:.3f} s; transcripts equal "
          f"to the greedy engine's for {spec_same} of {ENGINE_REQUESTS} (reported); card: "
          f"{card}", flush=True)

    # (c) two held conversations through the adapter, a second turn each
    serving = MyriadServing(model, slots=BATCH, bucket=576, segment=ENGINE_SEGMENT,
                            max_new_tokens=NEW_TOKENS, admit_widths=ENGINE_WIDTHS)
    turn1 = _samples(seed + 4, model.arch.img_size)
    handles = [serving.submit_held({"image": turn1["image"][i:i + 1],
                                    "scene": [model.vision_expert.class_names[i % 2]],
                                    "question2": [AQA_QUESTION]}) for i in range(2)]
    (first, wall, counts) = drive(checks, "engine_held", serving.drain, needs)
    check(sorted(r["request_id"] for r in first) == handles and all(r["held"] for r in first),
          "held turn 1")
    eng = serving.engine
    text = "###Human: " + CHAT_QUESTIONS[1] + " ###Assistant: "
    delta = len(model.llama_tokenizer(text)["input_ids"][0])
    front1 = {h: int(eng._frontier_host[eng._held[h]]) for h in handles}
    slots = {h: eng._held[h] for h in handles}
    turns = {serving.continue_request(h, text, hold=True): h for h in handles}
    second = serving.drain()
    check(sorted(r["request_id"] for r in second) == sorted(turns), "held turn 2")
    for r in second:
        h = turns[r["request_id"]]
        want = front1[h] + delta + len(r["raw_tokens"])
        got = int(eng._frontier_host[slots[h]])
        print(f"  held conversation {h}: turn 1 frontier {front1[h]}, delta {delta}, "
              f"{len(r['raw_tokens'])} raw tokens -> frontier {got} (want {want}); scene "
              f"{r.get('scene')!r}", flush=True)
        check(got == want, f"held conversation {h}: frontier {got}, not {want}")
        serving.release(r["request_id"])
    check(eng.free_slot_count == BATCH, "release did not free the held slots")
    print(f"engine held conversations: turn 1 {wall:.3f} s (two requests), launches {counts}",
          flush=True)
    del serving, eng

    # (d) the eval entry point with --engine over phase 8's tree
    argv = eval_argv + ["--engine", "--save_path",
                        os.path.join(REPO, "build", "aqa_eval", "engine_rows.jsonl")]
    args = evaluate.parse_args(argv)
    out, wall, counts = drive(checks, "aqa_engine_eval",
                              lambda: evaluate.run(args, Config(args), model), needs)
    rows, bench = out["rows"], out["bench"]
    keys = ["image_id", "image_path", "is_anomaly", "output", "error", "anomaly_score"]
    n_images = len(eval_out["rows"])
    check(sorted(r["image_id"] for r in rows) == list(range(n_images)),
          f"--engine wrote {len(rows)} rows")
    for row in rows:
        check(list(row) == keys and row["error"] in ("0", "1")
              and 0.0 <= float(row["anomaly_score"]) <= 1.0, f"--engine row {row}")
    check(bench is not None and bench["requests"] == n_images and bench["slots"] == BATCH,
          f"--engine --bench line: {bench}")
    fixed = {r["image_id"]: r for r in eval_out["rows"]}
    agree = sum(r["output"] == fixed[r["image_id"]]["output"] for r in rows)
    scores = sum(r["anomaly_score"] == fixed[r["image_id"]]["anomaly_score"] for r in rows)
    print(f"evaluate.run --engine: {len(rows)} rows in {wall:.3f} s; launches {counts}; "
          f"outputs equal to phase 8's for {agree} of {n_images} images, anomaly scores for "
          f"{scores} (reported); card: {card}", flush=True)
    print(f"aqa eval --engine --bench: {json.dumps(bench)}", flush=True)
    print(f"eval images/s: --engine {bench['value']:.4f} against phase 8's fixed batches "
          f"{eval_out['bench']['value']:.4f} (each its own --bench rule); card: {card}",
          flush=True)


# phase 11: the vision-expert family on phase 8's model
SHOT_KS = (1, 4)
SIMPLENET_TOL = 1e-4  # max |card - CPU fp32| over max |CPU fp32| of the SimpleNet maps


def check_same_launches(checks, path, like, share=1):
    """Each kernel launched on ``path`` exactly ``1 / share`` as often as on
    the path ``like`` (``share``: how many of ``path``'s batches ``like``
    ran).  Greedy rows of the random model run to ``NEW_TOKENS`` without a
    stop token, so a path that serves other maps launches the same."""
    for c in checks:
        got, want = c.by_path[path], c.by_path[like]
        check(got * share == want, f"{c.name}: {got} launches on the {path} path, against "
              f"{want} on {like} for {share} batch(es) of the same shape")


def write_mask_tree(root, tree_root, seed):
    """Gray mask PNGs under ``root`` for the eval tree's test images (every
    fourth one missing: a zero map), at the images' sizes.  Returns the
    relative image paths."""
    import numpy as np

    from myriad_tpu_torch.datasets.png import encode_png

    rng = np.random.default_rng(seed + 11)
    with open(os.path.join(tree_root, "DC_MVTEC_test_normal.jsonl")) as f:
        rels = [json.loads(line)["img_path"] for line in f]
    sizes = {cls: size for cls, size, _ in EVAL_CLASSES}
    for i, rel in enumerate(rels):
        if i % 4 == 3:
            continue
        size = sizes[rel.split("/")[1]]
        yy, xx = np.mgrid[0:size, 0:size]
        mask = ((xx + yy + i * 37) % 256).astype(np.uint8)
        mask[rng.integers(0, size, 64), rng.integers(0, size, 64)] = 255
        path = os.path.join(root, os.path.splitext(rel)[0] + ".png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(encode_png(mask, filters=rng.integers(0, 5, size), level=1))
    return rels


def write_simplenet_heads(root, seed, classes, dim=1536, hidden=1024):
    """One random head npz a class in the JAX package's ``save_params``
    layout (Projection ``fc_0``, Discriminator ``block1_fc``, ``block1_bn``,
    ``tail``)."""
    import numpy as np

    rng = np.random.default_rng(seed + 12)
    os.makedirs(root, exist_ok=True)
    for cls in classes:
        def normal(*shape):
            return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
        np.savez(os.path.join(root, f"{cls}.npz"), **{
            "pre_projection/fc_0/kernel": normal(dim, dim),
            "pre_projection/fc_0/bias": np.zeros(dim, np.float32),
            "discriminator/block1_fc/kernel": normal(dim, hidden),
            "discriminator/block1_fc/bias": np.zeros(hidden, np.float32),
            "discriminator/block1_bn/scale": np.ones(hidden, np.float32),
            "discriminator/block1_bn/bias": np.zeros(hidden, np.float32),
            "discriminator/block1_bn/mean": np.zeros(hidden, np.float32),
            "discriminator/block1_bn/var": np.ones(hidden, np.float32),
            "discriminator/tail/kernel": normal(hidden, 1)})


def expert_slice(dev, seed, checks, card, model, eval_argv, eval_out, dataset):
    """Phase 11: one-shot maps, the expert mux and no expert on phase 8's model."""
    import copy

    import numpy as np
    import torch

    from myriad_tpu_torch import evaluate
    from myriad_tpu_torch.common.config import Config
    from myriad_tpu_torch.datasets.cv_ops import resize_linear
    from myriad_tpu_torch.datasets.loaders import DataLoader
    from myriad_tpu_torch.datasets.png import read_png_gray
    from myriad_tpu_torch.models.simplenet import SimpleNetInterface
    from myriad_tpu_torch.models.vision_experts import SimpleNetExpertAdapter

    root = os.path.join(REPO, "build", "aqa_eval")
    needs = ["B1 int8_matmul", "B2 decode_attention", "B3 prefill_attention", "B4 kv_write"]
    ve = model.vision_expert
    keys = ["image_id", "image_path", "is_anomaly", "output", "error", "anomaly_score"]

    # (a) evaluate --k_shot 1 and 4: the bank of train/good references
    shot_rows = {}
    for k in SHOT_KS:
        argv = eval_argv + ["--k_shot", str(k), "--save_path",
                            os.path.join(root, f"rows_k{k}.jsonl")]
        args = evaluate.parse_args(argv)
        cfg = Config(args)
        _, t_bank = timed(lambda: evaluate.setup_vision_expert(model, dataset, root,
                                                               args.round_index, k))
        banks = [tuple(b.shape) for b in ve._ref_bank]
        print(f"k_shot {k}: text features and reference bank built in {t_bank:.3f} s (host "
              f"clock, synchronized; PNG decode and resize of the references included); bank "
              f"per tap {banks[0]} x {len(banks)} taps, classes {ve.class_names}", flush=True)
        out, wall, counts = drive(checks, f"aqa_eval_k{k}",
                                  lambda: evaluate.run(args, cfg, model), needs)
        check_same_launches(checks, f"aqa_eval_k{k}", "aqa_eval")
        rows, bench = out["rows"], out["bench"]
        check(len(rows) == len(eval_out["rows"]), f"k_shot {k}: {len(rows)} rows")
        for i, row in enumerate(rows):
            check(list(row) == keys and row["image_id"] == i
                  and 0.0 <= float(row["anomaly_score"]) <= 1.0, f"k_shot {k} row {row}")
        check(bench is not None, f"k_shot {k}: no --bench line")
        same = 0
        for b, (batch, tokens) in enumerate(zip(DataLoader(dataset, batch_size=BATCH),
                                                out["token_ids"])):
            direct = model.generate(batch, max_new_tokens=NEW_TOKENS, do_sample=False)
            check(np.array_equal(direct["token_ids"].cpu().numpy(), tokens),
                  f"k_shot {k}: evaluate's tokens differ from a direct generate")
            same += len(tokens)
            if b == 0:
                _, _, _, zero, one = model.prepare_sample(batch, 1)
                check(torch.equal(one, direct["ve_anomaly_maps"]),
                      f"k_shot {k}: generate did not serve the one-shot maps")
                apart = (one - zero).abs().max().item()
                check(apart > 1e-3, f"k_shot {k}: one-shot maps equal the zero-shot ones")
        check(same == len(rows), f"k_shot {k}: compared {same} rows")
        shot_rows[k] = rows
        print(f"evaluate.run --k_shot {k}: {len(rows)} rows in {wall:.3f} s; launches {counts}; "
              f"tokens of all {same} rows identical to a direct Myriad.generate with the same "
              f"bank; one-shot maps of batch 1 differ from its zero-shot maps by up to "
              f"{apart:.4f}; card: {card}", flush=True)
        print(f"aqa eval --k_shot {k} --bench: {json.dumps(bench)}", flush=True)
        print(f"eval images/s: --k_shot {k} {bench['value']:.4f} against phase 8's zero-shot "
              f"{eval_out['bench']['value']:.4f} (each its own --bench rule); card: {card}",
              flush=True)

    # (e) --engine at k_shot 1 over the same tree and bank
    argv = eval_argv + ["--k_shot", "1", "--engine", "--save_path",
                        os.path.join(root, "engine_rows_k1.jsonl")]
    args = evaluate.parse_args(argv)
    out, wall, counts = drive(checks, "aqa_engine_eval_k1",
                              lambda: evaluate.run(args, Config(args), model), needs)
    check_same_launches(checks, "aqa_engine_eval_k1", "aqa_engine_eval")
    fixed = {r["image_id"]: r for r in shot_rows[1]}
    check(sorted(r["image_id"] for r in out["rows"]) == sorted(fixed),
          f"--engine --k_shot 1 wrote {len(out['rows'])} rows")
    for r in out["rows"]:
        check(r["anomaly_score"] == fixed[r["image_id"]]["anomaly_score"],
              f"--engine --k_shot 1: image {r['image_id']}'s anomaly score is not the "
              "one-shot maps' of the fixed batches")
    agree = sum(r["output"] == fixed[r["image_id"]]["output"] for r in out["rows"])
    print(f"evaluate.run --engine --k_shot 1: {len(out['rows'])} rows in {wall:.3f} s; launches "
          f"{counts}; anomaly scores equal to the fixed batches' one-shot ones for all; outputs "
          f"equal for {agree} of {len(fixed)} (reported); --bench {json.dumps(out['bench'])}; "
          f"card: {card}", flush=True)
    model.k_shot = 0

    batch = next(iter(DataLoader(dataset, batch_size=BATCH)))
    rels = [ann["img_path"] for ann in dataset.annotation[:BATCH]]

    def generate_with(label, expert, samples):
        model.expert = expert
        try:
            out, wall, counts = drive(checks, label, lambda: model.generate(
                samples, max_new_tokens=NEW_TOKENS, do_sample=False), needs)
        finally:
            model.expert = model.vision_expert
        check_same_launches(checks, label, "aqa_eval", len(eval_out["rows"]) // BATCH)
        check_tokens(out["token_ids"], BATCH, NEW_TOKENS, model.arch.llama.vocab_size)
        print(f"  {label}: generate {wall:.3f} s, launches {counts}", flush=True)
        return out

    # (b) aprilgan: precomputed masks (relative image paths, as the annotation holds them)
    mask_root = os.path.join(REPO, "build", "aqa_masks")
    write_mask_tree(mask_root, root, seed)
    out = generate_with("aprilgan_generate", model.build_expert("aprilgan",
                                                                {"ve_root": mask_root}),
                        dict(batch, img_path=rels))
    want = []
    for rel in rels:
        path = os.path.join(mask_root, os.path.splitext(rel)[0] + ".png")
        want.append(resize_linear(read_png_gray(path), (224, 224)).astype(np.float32) / 255.0
                    if os.path.isfile(path) else np.zeros((224, 224), np.float32))
    err = np.abs(out["ve_anomaly_maps"][..., 0].cpu().numpy() - np.stack(want)).max()
    check(err == 0.0, f"aprilgan maps differ from the host-resized masks by {err}")
    print(f"aprilgan: maps equal the mask PNGs resized on the host (max difference {err}); "
          f"{sum(os.path.isfile(os.path.join(mask_root, os.path.splitext(r)[0] + '.png')) for r in rels)}"
          f" of {BATCH} masks present", flush=True)

    # (c) simplenet at full width: WideResNet-50-2 (random, seeded) and two heads
    heads_root = os.path.join(REPO, "build", "simplenet_heads")
    write_simplenet_heads(heads_root, seed, [cls for cls, _, _ in EVAL_CLASSES])
    expert, t_build = timed(lambda: model.build_expert("simplenet", {"ckpt_root": heads_root}))
    images = torch.as_tensor(batch["image"], device=dev)
    scenes = list(batch["scene"])
    intf = expert.interface
    # with TF32 on for cuDNN and cuBLAS, as a process may leave it (cuDNN's
    # is PyTorch's default): the expert pins fp32 itself (exact_fp32)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        walls = [timed(lambda: expert(images, scenes))[1] for _ in range(4)]
        maps, _ = expert(images, scenes)
        check(torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32,
              "the simplenet expert did not restore the TF32 flags")
        with torch.inference_mode():  # what TF32 does to the trunk (unpinned: reported)
            x = images.float()
            _, l3_tf32 = intf.embedder.backbone(x)
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            _, l3 = intf.embedder.backbone(x)
        tf32_err = ((l3_tf32 - l3).abs().max() / l3.abs().max()).item()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    cpu = SimpleNetExpertAdapter(SimpleNetInterface(
        copy.deepcopy(intf.embedder).to("cpu"),
        {c: copy.deepcopy(h).to("cpu") for c, h in intf.heads.items()}, map_size=intf.map_size))
    ref, t_cpu = timed(lambda: cpu(torch.as_tensor(batch["image"]), scenes)[0])
    rel_err = ((maps.cpu() - ref).abs().max() / ref.abs().max()).item()
    print(f"simplenet: built in {t_build:.3f} s; expert per batch of {BATCH}: "
          f"{statistics.median(walls[1:]) * 1e3:.1f} ms median of 3 after a warm-up (host "
          f"clock, synchronized; the Gaussian smoothing on the host included); maps "
          f"{tuple(maps.shape)} in [{maps.min().item():.3f}, {maps.max().item():.3f}], against "
          f"the CPU fp32 path ({t_cpu:.1f} s): max |diff| / max |CPU| = {rel_err:.3e} "
          f"(tol {SIMPLENET_TOL}; TF32 flags on around the expert's calls, which pin fp32; "
          f"the unpinned trunk's layer3 under TF32 moves by {tf32_err:.3e} of its largest); "
          f"card: {card}", flush=True)
    check(rel_err <= SIMPLENET_TOL, "simplenet maps disagree with the CPU fp32 path")
    generate_with("simplenet_generate", expert, batch)
    del expert, cpu

    # (d) adgpt (zero-shot maps only) and no expert (zeros; what use_ve: False serves)
    with torch.inference_mode():
        zero, _ = ve(images, scenes)
    out = generate_with("adgpt_generate", model.build_expert("adgpt"), batch)
    check(torch.equal(out["ve_anomaly_maps"], zero), "adgpt maps are not the zero-shot maps")
    fused = model.generate(batch, max_new_tokens=NEW_TOKENS, do_sample=False)
    check(torch.equal(out["token_ids"], fused["token_ids"]),
          "adgpt tokens differ from the ImageBind expert's zero-shot generate")
    out = generate_with("no_expert_generate", None, batch)
    check(float(out["ve_anomaly_maps"].abs().max()) == 0.0, "no expert: maps are not zeros")
    print("adgpt: maps equal the zero-shot maps and tokens equal the fused zero-shot "
          "generate's; no expert: zero maps", flush=True)


# phase 12: the TPU harness's serving profile (the --options of BENCH_r05.json's
# harness command): every tower and the LLM in int8, an int8 KV cache, 9
# prefill chunks, staged decode, batch 48
HARNESS_OPTIONS = ["model.vit_weight_dtype=int8", "model.ve_weight_dtype=int8",
                   "model.qformer_weight_dtype=int8", "model.llm_weight_dtype=int8",
                   "model.llm_kv_dtype=int8", "model.llm_prefill_chunks=9",
                   "model.llm_staged_decode=True", "model.llm_cache_granularity=32"]
HARNESS_BATCH = 48
SAMPLE_TOP_P = 0.9  # the JAX demo chat's default


def write_tower_npz(root, seed, dev, arch):
    """The Q-Former tower (with query_tokens and ln_vision), llama_proj and
    the vision expert's decoder as npz files in the JAX ``save_params``
    layout, fp32, drawn from ``seed`` by float modules named as the model's
    own.  Returns ({tower: path}, {tower: the tree written})."""
    import torch
    from torch import nn

    from myriad_tpu_torch.checkpoint import save_params
    from myriad_tpu_torch.convert_from_jax import tree_from_module
    from myriad_tpu_torch.models.imagebind import LinearLayerDecoder
    from myriad_tpu_torch.models.layers import (Dense, LayerNorm, LayerNormFp32, Policy,
                                                init_random_, new_param)
    from myriad_tpu_torch.models.qformer import QFormer

    kw = dict(policy=Policy.fp32(), device=dev)
    towers = nn.Module()  # attribute names as MyriadModule's: the JAX paths follow
    towers.ln_vision = LayerNormFp32(arch.vit_dim, eps=1e-5, **kw)
    towers.qformer = QFormer(hidden_size=arch.qformer_hidden, encoder_dim=arch.vit_dim,
                             num_layers=arch.qformer_layers, num_heads=arch.qformer_heads,
                             intermediate_size=arch.qformer_intermediate, **kw)
    towers.query_tokens = new_param((1, arch.num_query_token, arch.qformer_hidden),
                                    torch.float32, dev)
    towers.llama_proj = Dense(arch.qformer_hidden, arch.llama.hidden_size, **kw)
    ib = arch.imagebind
    decoder = LinearLayerDecoder(ib.vision_embed_dim, num_taps=len(ib.out_layers),
                                 out_dim=ib.out_embed_dim, **kw)
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    init_random_(towers, gen)
    init_random_(decoder, gen)
    with torch.no_grad():  # norms other than ones and zeros, so a misplaced scale shows
        for mod in towers.modules():
            if isinstance(mod, LayerNorm):
                mod.weight.normal_(1.0, 0.1, generator=gen)
                mod.bias.normal_(0.0, 0.1, generator=gen)
    t = tree_from_module(towers)
    trees = {"qformer": {"qformer": t["qformer"], "query_tokens": t["query_tokens"],
                         "ln_vision": t["ln_vision"]},
             "llama_proj": {"llama_proj": t["llama_proj"]},
             "decoder": tree_from_module(decoder)}
    paths = {key: save_params(os.path.join(root, f"{key}.npz"), tree)
             for key, tree in trees.items()}
    del towers, decoder
    return paths, trees


def harness_slice(dev, seed, checks, card, eval_out, dataset):
    """Phase 12: the TPU harness's profile at full width, the Q-Former,
    llama_proj and the decoder loaded through ``weights:`` (quantized on
    load), the rest random from --seed."""
    import numpy as np
    import torch

    from myriad_tpu_torch import evaluate
    from myriad_tpu_torch.common.config import Config
    from myriad_tpu_torch.conversation import CONV_VISION, Chat
    from myriad_tpu_torch.convert_from_jax import state_dict_from_jax
    from myriad_tpu_torch.datasets.loaders import DataLoader
    from myriad_tpu_torch.generation import GenerationConfig, _select_token
    from myriad_tpu_torch.models.myriad import MyriadArch
    from myriad_tpu_torch.ops import quant
    from myriad_tpu_torch.ops.preprocess import u8_normalize

    root = os.path.join(REPO, "build", "aqa_eval")
    argv = ["--cfg-path", os.path.join(REPO, "eval_configs", "myriad.yaml"),
            "--bs", str(BATCH), "--greedy", "--bench", "--max_new_tokens", str(NEW_TOKENS),
            "--save_path", os.path.join(root, "rows_harness.jsonl"),
            "--options", *HARNESS_OPTIONS, f"model.seed={seed}",
            f"datasets.anomaly_detection.build_info.storage={root}"]
    preset = Config(evaluate.parse_args(argv)).model_cfg.get("arch_preset", "full")
    arch = MyriadArch.tiny() if preset == "tiny" else MyriadArch.full()
    t0 = time.time()
    paths, trees = write_tower_npz(os.path.join(REPO, "build", "harness_weights"), seed, dev,
                                   arch)
    sizes = {k: os.path.getsize(p) / 2**20 for k, p in paths.items()}
    print(f"wrote the Q-Former, llama_proj and decoder towers as fp32 npz ("
          + ", ".join(f"{k} {v:.1f} MiB" for k, v in sizes.items())
          + f") in {time.time() - t0:.1f} s", flush=True)

    # (a) the model through evaluate.build_model with the harness's options
    argv += [f"model.weights.{k}={p}" for k, p in paths.items()]
    args = evaluate.parse_args(argv)
    cfg = Config(args)
    t0 = time.time()
    model = evaluate.build_model(args, cfg)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    a = model.arch
    check((a.vit_weight_dtype, a.qformer_weight_dtype, a.imagebind.weight_dtype,
           a.llama.weight_dtype, a.llama.kv_cache_dtype) == ("int8",) * 5
          and model.prefill_chunks == 9 and model.staged_decode
          and model.cache_granularity == 32, "the harness's options did not reach the model")
    report = model.weights_report
    check(report is not None and report["missing"] == []
          and all(report["loaded"].get(k) for k in paths)
          and not any(report["skipped"].get(k) for k in paths),
          f"weights: towers not fully loaded: missing {report and report['missing'][:5]}")
    want = state_dict_from_jax(quant.quantize_tree(trees["qformer"],
                                                   quant.QFORMER_QUANT_PATTERN))
    live = model.module.state_dict()
    n_int8 = 0
    for name, t in want.items():
        check(torch.equal(live[name].cpu(), t.to(live[name].dtype)),
              f"loaded {name} is not the quantized npz leaf")
        n_int8 += name.endswith("w_int8")
    check(n_int8 == 6 * a.qformer_layers + 4 * len(range(0, a.qformer_layers, 2)),
          f"{n_int8} int8 Q-Former projections")
    print(f"evaluate.build_model with the harness's options: towers int8 (EVA, Q-Former, "
          f"ImageBind), int8 LLM and KV, 9 prefill chunks, staged decode; built in "
          f"{t_build:.1f} s with weights: loaded "
          + ", ".join(f"{k} {len(v)} leaves" for k, v in report["loaded"].items())
          + f", missing {len(report['missing'])}; the {n_int8} int8 Q-Former payloads and every "
          f"other leaf equal the npz quantized on the host; card: {card}", flush=True)

    # (b) the eval over phase 8's tree at phase 8's batch
    torch.cuda.reset_peak_memory_stats(dev)
    needs = ["B1 int8_matmul", "B2 decode_attention", "B3 prefill_attention", "B4 kv_write"]
    quant.int_mm_counter.count = 0
    out, wall, launches = drive(checks, "harness_eval", lambda: evaluate.run(args, cfg, model),
                                needs)
    int_mm = quant.int_mm_counter.count
    peak = evaluate.device_mem_mb(dev)
    rows, bench = out["rows"], out["bench"]
    keys = ["image_id", "image_path", "is_anomaly", "output", "error", "anomaly_score"]
    check(len(rows) == len(eval_out["rows"]), f"{len(rows)} rows")
    for i, row in enumerate(rows):
        check(list(row) == keys and row["image_id"] == i and row["error"] in ("0", "1")
              and 0.0 <= float(row["anomaly_score"]) <= 1.0, f"row {i}: {row}")
    check(bench is not None, "no --bench line")
    same = 0
    for batch, tokens in zip(DataLoader(dataset, batch_size=BATCH), out["token_ids"]):
        direct = model.generate(batch, max_new_tokens=NEW_TOKENS, do_sample=False)
        direct = direct["token_ids"].cpu().numpy()
        check_tokens(torch.as_tensor(direct), BATCH, NEW_TOKENS, a.llama.vocab_size)
        check(np.array_equal(direct, tokens), "the harness eval's tokens differ from a direct "
              "generate")
        same += len(tokens)
    check(same == len(rows), f"compared {same} of {len(rows)} rows")
    print(f"evaluate.run, harness profile: {len(rows)} rows in {wall:.3f} s; launches "
          f"{launches}; torch._int_mm calls {int_mm}; peak device memory {peak:.1f} MiB; tokens "
          f"of all {same} rows identical to a direct Myriad.generate; card: {card}", flush=True)
    print(f"aqa eval harness profile --bench: {json.dumps(bench)}", flush=True)
    print(f"eval images/s at batch {BATCH}: harness profile (int8 towers, 9 prefill chunks) "
          f"{bench['value']:.4f} against phase 8's bf16 towers {eval_out['bench']['value']:.4f} "
          f"(each its own --bench rule); card: {card}", flush=True)

    # (c) one generate at the harness's batch of 48
    scenes = [cls for cls, _, _ in EVAL_CLASSES]  # the classes the eval gave the expert
    samples48 = _samples(seed + 48, a.img_size, HARNESS_BATCH, scenes)
    model.generate(samples48, max_new_tokens=NEW_TOKENS)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    res, wall48, launches48 = drive(checks, "harness_b48", lambda: model.generate(
        samples48, max_new_tokens=NEW_TOKENS), needs)
    walls = [wall48] + [timed(lambda: model.generate(samples48, max_new_tokens=NEW_TOKENS))[1]
                        for _ in range(2)]
    peak48 = torch.cuda.max_memory_allocated(dev)
    check_tokens(res["token_ids"], HARNESS_BATCH, NEW_TOKENS, a.llama.vocab_size)
    print(f"harness profile, batch {HARNESS_BATCH}: {HARNESS_BATCH / statistics.median(walls):.4f} "
          f"images/s, median of 3 after a warm-up (wall s {', '.join(f'{w:.3f}' for w in walls)}, "
          f"host clock after synchronize; {NEW_TOKENS} new tokens); launches {launches48}; peak "
          f"device memory {peak48 / 2**30:.2f} GiB; card: {card}", flush=True)
    del res, samples48

    # (d) a batch-1 chat: the upload's B1 launches (Q-Former) and torch._int_mm calls
    rng = np.random.default_rng(seed + 12)
    image = rng.integers(0, 256, size=(a.img_size, a.img_size, 3), dtype=np.uint8)
    Chat(model, incremental=True, spec_k=0).upload_img(image, CONV_VISION.copy(), [])  # warm-up
    chat, conv, img_list = Chat(model, incremental=True, spec_k=0), CONV_VISION.copy(), []
    quant.int_mm_counter.count = 0
    _, wall_up, up = drive(checks, "harness_chat_upload",
                           lambda: chat.upload_img(image, conv, img_list), ["B1 int8_matmul"])
    up_mm = quant.int_mm_counter.count
    n_cross = len(range(0, a.qformer_layers, 2))
    want_b1 = 6 * a.qformer_layers + 2 * n_cross  # q,k,v,o + 2 FFN a layer; q, o a cross
    want_mm = 4 * a.vit_depth + 4 * a.imagebind.vision_num_blocks + 2 * n_cross
    check(up["B1 int8_matmul"] == want_b1 and up_mm == want_mm
          and sum(v for k, v in up.items() if k != "B1 int8_matmul") == 0,
          f"chat upload: B1 {up['B1 int8_matmul']} (want {want_b1}), torch._int_mm {up_mm} "
          f"(want {want_mm}), others {up}")
    print(f"chat upload at batch 1 ({wall_up:.4f} s): B1 launched {want_b1} times (the "
          f"Q-Former's {QFORMER_ROWS}-row query stream: {4 * a.qformer_layers + 2 * n_cross} at "
          f"768x768, {a.qformer_layers} at 768x3072, {a.qformer_layers} at 3072x768) and "
          f"torch._int_mm {want_mm} times (EVA {4 * a.vit_depth}, ImageBind "
          f"{4 * a.imagebind.vision_num_blocks}, cross-attention K/V {2 * n_cross}, 257 rows "
          f"each), as the architecture gives them; card: {card}", flush=True)
    with torch.inference_mode():
        ve = model.vision_expert
        x = u8_normalize(torch.as_tensor(image, device=dev), out_dtype=torch.float32)[None]
        maps = ve(x, ["object"])[0]
        run = lambda inp: model.module.encode_img(inp, maps, 1).float()
        sensitivity_gate("chat upload encode_img (B1 in the Q-Former, W8A8 elsewhere)",
                         run(x), run, x, seed)
    chat.ask(CHAT_QUESTIONS[0], conv)
    (text, tokens), wall_turn, turn = drive(
        checks, "harness_chat_turn", lambda: chat.answer(conv, img_list,
                                                         max_new_tokens=CHAT_TOKENS), needs)
    check_tokens(torch.as_tensor(tokens), 1, CHAT_TOKENS, a.llama.vocab_size)
    print(f"chat turn 1: {wall_turn:.4f} s, launches {turn}; card: {card}", flush=True)

    # (e) top-p sampling: reproducible from its seed
    samples = _samples(seed, a.img_size, BATCH, scenes)
    kw = dict(max_new_tokens=NEW_TOKENS, do_sample=True, top_p=SAMPLE_TOP_P, temperature=1.0,
              seed=seed + 5)
    (s1, wall_s, _) = drive(checks, "harness_sampled_generate",
                            lambda: model.generate(samples, **kw), needs)
    s2 = model.generate(samples, **kw)
    check_tokens(s1["token_ids"], BATCH, NEW_TOKENS, a.llama.vocab_size)
    check(torch.equal(s1["token_ids"], s2["token_ids"]), "sampled generate: the same seed gave "
          "other tokens")
    greedy = model.generate(samples, max_new_tokens=NEW_TOKENS)["token_ids"]
    apart = (s1["token_ids"] != greedy).float().mean().item()
    turns = []
    for _ in range(2):
        c, cv, il = Chat(model, incremental=True, spec_k=0), CONV_VISION.copy(), []
        c.upload_img(image, cv, il)
        c.ask(CHAT_QUESTIONS[0], cv)
        turns.append(c.answer(cv, il, max_new_tokens=CHAT_TOKENS, do_sample=True,
                              top_p=SAMPLE_TOP_P, temperature=1.0)[1])
    check(np.array_equal(turns[0], turns[1]), "sampled chat turn: a second run gave other "
          "tokens")
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn(BATCH, a.llama.vocab_size, generator=g, device=dev) * 3.0
    one = _select_token(logits, GenerationConfig(do_sample=True, top_p=1e-9, temperature=1.0),
                        torch.Generator(device=dev).manual_seed(seed))
    check(torch.equal(one, logits.argmax(-1)), "a one-token nucleus did not give the argmax")
    print(f"top-p {SAMPLE_TOP_P}, T = 1: sampled generate ({wall_s:.3f} s, batch {BATCH}) and "
          f"a sampled chat turn (seeded with 0) each twice: tokens identical; {apart:.3f} of the "
          f"sampled tokens differ from greedy's; a one-token nucleus gives the argmax; card: "
          f"{card}", flush=True)
    del model


# phase 10: stage-2 LoRA fine-tuning over a synthetic MVTec train tree
TRAIN_CLASSES = (("bottle", 900, 3), ("screw", 1024, 1))  # MVTec's sizes; screw is gray
TRAIN_PER_CLASS = 8
TRAIN_CONFIG = os.path.join("train_configs", "loraadapter_simple_myriad_finetune.yaml")
TRAIN_SAMPLES_PER_STEP = 4  # batch_size_train 4: 2 images a step and their 2 NSA twins


def write_train_tree(root, seed):
    """A synthetic MVTec AD train tree: ``TRAIN_PER_CLASS`` good PNGs a class
    (a bright object on a darker ground, so NSA's background test keeps
    patches), each row with a random filter type, and the
    ``DC_MVTEC_train_normal.jsonl`` annotation."""
    import numpy as np

    from myriad_tpu_torch.datasets.png import encode_png

    rng = np.random.default_rng(seed + 10)
    rows = []
    for cls, size, channels in TRAIN_CLASSES:
        yy, xx = np.mgrid[0:size, 0:size]
        disk = (yy - size / 2) ** 2 + (xx - size / 2) ** 2 < (size / 3) ** 2
        for i in range(TRAIN_PER_CLASS):
            img = rng.integers(20, 60, (size, size, channels))
            img[disk] = 210 + (xx[disk, None] // 16 + i * 5) % 40
            rel = f"mvtec/{cls}/train/good/{i:03d}.png"
            os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
            with open(os.path.join(root, rel), "wb") as f:
                img = img.astype(np.uint8)
                f.write(encode_png(img[..., 0] if channels == 1 else img,
                                   filters=rng.integers(0, 5, size), idat_chunks=3, level=1))
            rows.append({"img_path": rel, "caption": "", "is_anomaly": "0"})
    with open(os.path.join(root, "DC_MVTEC_train_normal.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)


def _grad_of_projection(module, store):
    """Keep one frozen projection's dy and dx of the next backward in ``store``."""
    def hook(mod, inputs, output):
        x = inputs[0]
        if x.requires_grad:
            x.register_hook(lambda g: store.__setitem__("dx", g))
            output.register_hook(lambda g: store.__setitem__("dy", g))
    return module.register_forward_hook(hook)


# phase 14: the port's Orbax reader on the committed fixture (tests/orbax_fixture,
# written by tests/make_orbax_fixture.py with the JAX package and libzstd)
ORBAX_FIXTURE = os.path.join(REPO, "tests", "orbax_fixture")
ORBAX_DECODE_BYTES = 256 << 20  # decoded bytes a rate is measured over


def _tensors(tree):
    """The tensors of a restored tree, in order."""
    import torch

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif torch.is_tensor(tree):
        yield tree


def describe_tree(tree, prefix=()):
    """Each array leaf's dotted path, dtype, shape and sha256 of its bytes, in
    ``expected.json``'s order (dict keys sorted; None and empty containers
    left out)."""
    import hashlib

    if isinstance(tree, dict):
        return [d for k in sorted(tree) for d in describe_tree(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [d for i, v in enumerate(tree) for d in describe_tree(v, prefix + (str(i),))]
    if tree is None:
        return []
    import torch

    raw = tree.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return [{"path": ".".join(prefix), "dtype": str(tree.dtype).replace("torch.", ""),
             "shape": list(tree.shape), "sha256": hashlib.sha256(raw).hexdigest()}]


def orbax_slice(card):
    """Phase 14: build the zstd decoder with this machine's host compiler,
    restore the fixture's JAX-written ring (OCDBT, zstd chunks) and hold
    every leaf and every libzstd frame to ``expected.json``; the decoder's
    rate over the fixture's frames repeated to 256 MB.  Returns the rates
    (MB/s decoded, ``normal``: the fp32 frames, ``all``) and the fixture's
    fp32 compression ``ratio``, for phase 10's projection."""
    import hashlib

    import numpy as np

    from myriad_tpu_torch.orbax_format import checkpointer, zstd
    from myriad_tpu_torch.orbax_format.ocdbt import OcdbtReader

    t0 = time.time()
    lib = zstd.build()
    zstd.library()
    print(f"zstd decoder built by {zstd.compiler()} in {time.time() - t0:.1f} s: {lib.name}",
          flush=True)
    with open(os.path.join(ORBAX_FIXTURE, "expected.json")) as f:
        expected = json.load(f)
    path = os.path.join(ORBAX_FIXTURE, expected["checkpoint"])
    t0 = time.perf_counter()
    tree = checkpointer.restore(path)
    t_restore = time.perf_counter() - t0
    got = describe_tree(tree)
    check(got == expected["leaves"],
          f"the fixture's leaves differ from expected.json: "
          f"{[g['path'] for g, e in zip(got, expected['leaves']) if g != e][:3]}")
    frames = {}
    for name, spec in expected["frames"].items():
        with open(os.path.join(ORBAX_FIXTURE, "frames", f"{name}.zst"), "rb") as f:
            frames[name] = f.read()
        out = zstd.decompress(frames[name], spec["size"])
        check(hashlib.sha256(out.tobytes()).hexdigest() == spec["sha256"],
              f"frame {name} decodes to other bytes")
    key = "model.llama_proj.kernel/0.0"
    with OcdbtReader(path) as kv:
        chunk = len(kv.get(key))
    kernel = tree["model"]["llama_proj"]["kernel"]
    ratio = chunk / (kernel.numel() * kernel.element_size())
    print(f"fixture {path}: {len(got)} leaves (fp32, bf16 mu, int32 counts, 0-d int64 epoch "
          f"and step, the MultiSteps containers) restored in {t_restore * 1e3:.1f} ms, each "
          f"sha256 equal to expected.json; {len(frames)} libzstd frames (levels 3, 19) "
          f"bit-exact; the fp32 kernel's chunk {chunk} bytes for "
          f"{kernel.numel() * kernel.element_size()} ({ratio:.4f})", flush=True)

    def rate(names):
        one = b"".join(frames[n] for n in names)
        size = sum(expected["frames"][n]["size"] for n in names)
        reps = -(-ORBAX_DECODE_BYTES // size)
        src = np.frombuffer(one * reps, dtype=np.uint8)
        dst = np.empty(size * reps, dtype=np.uint8)
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            zstd.decompress(src, size * reps, out=dst)
            walls.append(time.perf_counter() - t)
        wall = statistics.median(walls)
        return size * reps / wall / 1e6, size * reps, src.size, walls

    rates = {"ratio": ratio}
    for label, names in (("normal", ("level3_normal", "level19_normal")),
                         ("all", tuple(frames))):
        mb_s, n_out, n_in, walls = rate(names)
        rates[label] = mb_s
        print(f"decoder, {label} frames ({', '.join(names)}) repeated: {n_in} bytes in, "
              f"{n_out} out, median of 3 {mb_s:.1f} MB/s decoded (s "
              f"{', '.join(f'{w:.3f}' for w in walls)}); one host thread; card: {card}",
              flush=True)
    return rates


BEFORE_TOKENS = 16  # of the generate before the merge, compared with the one after


def ckpt_generate(dev, seed, checks, card, model, trainable, before, saved, ckpt):
    """Phase 10 (c): the trained model's greedy generate (batch 8) with its
    trainables at their initial values (16 tokens), then (90 tokens) with the
    ring's directory merged through ``Myriad.load_checkpoint`` (what
    ``ckpt:`` loads): the merged trainables bit-equal to the saved ones, the
    tokens different, and the kernels' launches checked."""
    import torch

    ve = model.vision_expert
    if getattr(ve, "_text_feats", None) is None:
        ve.build_text_features()
    samples = _samples(seed, model.arch.img_size)
    with torch.no_grad():
        for n, p in trainable.items():
            p.copy_(before[n])
    # before the merge, the first BEFORE_TOKENS tokens are enough to differ
    base, wall0 = timed(lambda: model.generate(samples, max_new_tokens=BEFORE_TOKENS))
    t0 = time.perf_counter()
    loaded, skipped = model.load_checkpoint(ckpt)
    t_load = time.perf_counter() - t0
    check(bool(loaded) and not skipped, f"ckpt: loaded {len(loaded)}, skipped {skipped[:3]}")
    for n, p in trainable.items():
        check(torch.equal(p.detach(), saved[n]), f"ckpt: did not load {n} bit for bit")
    names = ["B2 decode_attention", "B3 prefill_attention", "B4 kv_write"]
    out, wall, launches = drive(checks, "train_ckpt_generate",
                                lambda: model.generate(samples, max_new_tokens=NEW_TOKENS),
                                names)
    tokens = out["token_ids"]
    check_tokens(tokens, BATCH, NEW_TOKENS, model.arch.llama.vocab_size)
    differ = (tokens[:, :BEFORE_TOKENS] != base["token_ids"]).float().mean().item()
    check(differ > 0, "the merged trainables did not change the tokens")
    layers = model.arch.llama.num_layers
    writes = 1 if model.arch.llama.kv_cache_dtype == "int8" else 2  # B4 a forward a layer
    b1, b2, b3, b4 = (launches[k] for k in ("B1 int8_matmul", *names))
    check(b1 == 0, f"B1 launched {b1} times on bf16 LLaMA weights")
    check(b2 % layers == 0 and b3 % layers == 0 and b4 == writes * (b2 + b3),
          f"launches B2 {b2}, B3 {b3}, B4 {b4}: not a B2 a layer a decode step, a B3 a "
          f"layer a prefill chunk, and {writes} B4 a layer a forward")
    print(f"ckpt: {ckpt} merged by load_checkpoint in {t_load:.3f} s ({len(loaded)} leaves, "
          f"none skipped), bit-equal to the saved trainables; greedy generate (batch {BATCH}, "
          f"{NEW_TOKENS} tokens, the trained model: bf16 compute over fp32 weights, KV "
          f"{model.arch.llama.kv_cache_dtype or 'bf16'}) "
          f"{wall:.3f} s, before the merge {wall0:.3f} s for {BEFORE_TOKENS} tokens; of "
          f"those, differing after the merge: {differ:.4f}; launches {launches} ({b2 // layers} decode steps and "
          f"{b3 // layers} prefill chunks over {layers} layers); card: {card}", flush=True)


def train_slice(dev, seed, checks, card, orbax_rates=None):
    """Phase 10: ``python -m myriad_tpu_torch.train``'s runner on the repo's
    stage-2 LoRA config at full width, its checkpoint ring (an Orbax
    directory) and resume, a generate served from the ring, one AdamW update
    recomputed in fp64, and one step with int8 LLM weights.  ``orbax_rates``
    (phase 14's) projects what a JAX-written ring would cost."""
    import shutil

    import numpy as np
    import torch

    from myriad_tpu_torch import train
    from myriad_tpu_torch.ops import quant

    root = os.path.join(REPO, "build", "train_data")
    out_dir = os.path.join(REPO, "build", "train_out")
    shutil.rmtree(out_dir, ignore_errors=True)
    held = torch.cuda.memory_allocated(dev)  # what earlier phases still hold
    t0 = time.time()
    write_train_tree(root, seed)
    n_images = TRAIN_PER_CLASS * len(TRAIN_CLASSES)
    print(f"wrote {n_images} train PNGs under {root} in {time.time() - t0:.1f} s", flush=True)
    argv = ["--cfg-path", os.path.join(REPO, TRAIN_CONFIG), "--options",
            f"datasets.anomaly_detection.build_info.storage={root}",
            f"datasets.anomaly_detection.seed={seed}", f"model.seed={seed}",
            "run.max_epoch=2", "run.iters_per_epoch=3", "run.max_checkpoints=1",
            "run.num_workers=4", f"run.output_dir={out_dir}"]
    t0 = time.time()
    runner = train.build(argv)  # train.main is build() then runner.train()
    model = runner.model
    torch.cuda.synchronize()
    check(model.device.type == dev.type, f"train built its model on {model.device}")
    trainable = dict(model.trainable_parameters())
    n_train = sum(p.numel() for p in trainable.values())
    print(f"train.build: {TRAIN_CONFIG} at full width on {model.device} (run.device "
          f"{runner.run_cfg.device!r}), policy {model.policy}, {len(trainable)} trainable tensors, "
          f"{n_train} parameters, in {time.time() - t0:.1f} s", flush=True)
    frozen = [(f"{tag}{n}", p) for mod, tag in ((model.module, ""),
                                                (model.vision_expert.module, "ve."))
              for n, p in mod.named_parameters() if not p.requires_grad]
    t0 = time.time()
    # the snapshot stays on the card (host copies of its 16 GiB took ~11-13 s
    # each way on the card's host); the peak is printed without it as well
    snap = {n: p.detach().clone() for n, p in frozen}
    before = {n: p.detach().clone() for n, p in trainable.items()}
    torch.cuda.synchronize()
    snap_bytes = sum(t.numel() * t.element_size() for t in snap.values())
    print(f"snapshot of {len(frozen)} frozen tensors ({snap_bytes / 2**30:.2f} GiB) on the "
          f"card in {time.time() - t0:.1f} s", flush=True)

    # the ring's saves, timed where the runner makes them
    ring_saves = []
    manager_save = runner.ckpt_manager.save

    def timed_save(tag, state):
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = manager_save(tag, state)
        ring_saves.append(time.perf_counter() - t)
        return path

    runner.ckpt_manager.save = timed_save
    torch.cuda.reset_peak_memory_stats(dev)
    quant.int_mm_counter.count = 0
    _, wall, launches = drive(checks, "train", runner.train, [])
    peak = torch.cuda.max_memory_allocated(dev)
    int_mm = quant.int_mm_counter.count
    losses = runner.losses
    check(len(losses) == 6 and all(np.isfinite(losses)), f"losses {losses}")
    hist = runner.task.timer.history
    iters = [d + s for d, s in zip(hist["data"], hist["step"])]
    rate = TRAIN_SAMPLES_PER_STEP / statistics.median(iters[1:])
    print(f"train: 2 epochs x 3 steps in {wall:.3f} s (the ring's two saves "
          f"{', '.join(f'{t:.3f}' for t in ring_saves)} s of it); losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; launches {launches}, torch._int_mm {int_mm} "
          f"(every projection bf16: no kernel of the port at this width)", flush=True)
    print(f"train samples/s: {rate:.4f} ({TRAIN_SAMPLES_PER_STEP} a step, median of the 5 steps "
          f"after the first; data + step s {', '.join(f'{x:.3f}' for x in iters)}); StepTimer "
          f"means: data {statistics.mean(hist['data']) * 1e3:.1f} ms, step "
          f"{statistics.mean(hist['step']) * 1e3:.1f} ms; peak device memory without the "
          f"{snap_bytes / 2**30:.2f} GiB snapshot {(peak - snap_bytes) / 2**30:.2f} GiB "
          f"({peak / 2**30:.2f} GiB with it), {(peak - snap_bytes - held) / 2**30:.2f} GiB "
          f"above the {held / 2**30:.2f} GiB that earlier phases held; card: {card}",
          flush=True)
    t0 = time.time()
    for n, p in frozen:
        check(p.grad is None and torch.equal(p.detach(), snap[n]),
              f"frozen {n} changed or holds a gradient")
    del snap
    for n, p in trainable.items():
        check(not torch.equal(p.detach(), before[n]), f"trainable {n} did not change")
    print(f"all {len(frozen)} frozen tensors bit-identical after the run and without .grad; "
          f"all {len(trainable)} trainable tensors changed ({time.time() - t0:.1f} s)",
          flush=True)

    # (b) the ring is an Orbax directory in the JAX runner's layout
    from myriad_tpu_torch import checkpoint as ckpt_lib
    from myriad_tpu_torch.convert_from_jax import jax_leaves

    files = sorted(os.listdir(runner.output_dir))
    check(files == ["checkpoint_1", "log.txt"], f"the ring kept {files}")
    ckpt = os.path.join(runner.output_dir, "checkpoint_1")
    disk = _disk_bytes(ckpt)
    t0 = time.perf_counter()
    state = ckpt_lib.load_params(ckpt)
    t_read = time.perf_counter() - t0
    names = {n for _, n, _ in jax_leaves(state["model"])}
    check(names == set(trainable), "the checkpoint's trainables are not the model's")
    check(sorted(state) == ["epoch", "global_step", "model", "optimizer"],
          f"the checkpoint holds {sorted(state)}")
    check((int(state["epoch"]), int(state["global_step"])) == (1, 6),
          "checkpoint epoch / step")
    check(state["epoch"].dtype == torch.int64 and state["epoch"].dim() == 0,
          "epoch is not a 0-d int64 array")
    raw = sum(t.numel() * t.element_size() for t in _tensors(state))
    del state

    # resume into the same model: the trainables are wiped first, so the restore shows
    saved = {n: p.detach().clone() for n, p in trainable.items()}
    opt0 = runner.optimizer
    with torch.no_grad():
        for p in trainable.values():
            p.zero_()
    runner.run_cfg.resume_ckpt_path = ckpt
    runner.run_cfg.max_epoch = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed = type(runner)(cfg=runner.config, task=runner.task, model=model,
                           datasets=runner.datasets, job_id="resumed")
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    for n, p in trainable.items():
        check(torch.equal(p.detach(), saved[n]), f"resume did not restore {n}")
    for key in ("mu", "nu"):
        for n, a, b in zip(opt0.names, getattr(opt0, key), getattr(resumed.optimizer, key)):
            check(a.dtype == b.dtype and torch.equal(a, b), f"resume did not restore {key} {n}")
    check((resumed.start_epoch, resumed.global_step, resumed.optimizer.count) == (2, 6, 6),
          "resume did not continue the step")
    del opt0
    print(f"ring: {files} under {runner.output_dir}, an Orbax directory in the JAX runner's "
          f"layout ({{model, optimizer, epoch, global_step}}, plain zarr, uncompressed): "
          f"{disk} bytes on disk ({raw} of arrays); written in "
          f"{', '.join(f'{t:.3f}' for t in ring_saves)} s, read by load_params in "
          f"{t_read:.3f} s ({raw / t_read / 1e6:.1f} MB/s, page cache warm); resume (read, "
          f"merge, optimizer by name) {t_resume:.3f} s restored the {len(trainable)} trainables "
          f"and Adam's mu and nu bit for bit at epoch {resumed.start_epoch}, global step "
          f"{resumed.global_step}, count {resumed.optimizer.count}", flush=True)
    if orbax_rates:
        mb_s = orbax_rates["normal"]
        print(f"projection, a JAX-written ring of this state (OCDBT, zstd level 1): "
              f"{raw * orbax_rates['ratio']:.0f} bytes at the fixture's fp32 ratio "
              f"{orbax_rates['ratio']:.4f}; decoding its {raw} bytes at phase 14's "
              f"{mb_s:.1f} MB/s over fp32 frames: {raw / mb_s / 1e6:.2f} s (the disk read "
              f"not included); projected, not measured", flush=True)

    # (c) a full-width generate whose trainables come through the ckpt: route
    ckpt_generate(dev, seed, checks, card, model, trainable, before, saved, ckpt)

    # one more step of the resumed runner, timed by phase, after a warm-up
    # step of the same prompt stage (the stage sets the sequence length, and a
    # length's first GEMMs pay the library's set-up); one AdamW update
    # recomputed in fp64 on the host from its gradient and the optimizer state
    opt = resumed.optimizer
    samples = next(resumed.train_loader)
    resumed.train_iteration(samples, np.random.default_rng(seed))
    rng = np.random.default_rng(seed)
    name = next(n for n in opt.names if "lora_a" in n)
    i = opt.names.index(name)
    p = opt.params[i]
    p0, mu0, nu0 = (t.detach().double().cpu() for t in (p, opt.mu[i], opt.nu[i]))
    count = opt.count
    torch.cuda.synchronize()
    t_step = time.perf_counter()
    arrays, static = model.prepare_train_arrays(samples, rng)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.zero_grad()
    ev[0].record()
    loss = model.train_loss(arrays, static)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    loss = float(loss.detach())
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t_step
    fwd, bwd, upd = (ev[k].elapsed_time(ev[k + 1]) for k in range(3))
    g = p.grad.double().cpu()
    k = count + 1
    mu = opt.b1 * mu0 + (1 - opt.b1) * g
    nu = opt.b2 * nu0 + (1 - opt.b2) * g * g
    step = (mu / (1 - opt.b1 ** k)) / (torch.sqrt(nu / (1 - opt.b2 ** k)) + opt.eps)
    expect = p0 - opt.schedule(count) * (step + opt.weight_decay * p0)
    err = ((p.detach().double().cpu() - expect).norm() / expect.norm()).item()
    err_upd = (((p.detach().double().cpu() - p0) - (expect - p0)).norm()
               / (expect - p0).norm()).item()
    check(np.isfinite(loss) and err <= 1e-5, f"AdamW update of {name}: rel {err}")
    print(f"one step (stage {static[0]}, {arrays['text_ids'].shape[0]} sequences of "
          f"{arrays['text_ids'].shape[1] + 1 + model.module.image_tokens(static[0])} + the "
          f"prompt's positions), CUDA events: forward {fwd:.1f} ms, backward {bwd:.1f} ms, "
          f"optimizer {upd:.1f} ms; host clock {t_step * 1e3:.1f} ms with the batch's vision "
          f"expert and host prep (loss {loss:.4f}); AdamW on {name} {tuple(p.shape)} against fp64 "
          f"on the host: rel L2 {err:.3e} (tol 1e-5), of the update alone {err_upd:.3e}; "
          f"card: {card}", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, t_prof = timed(lambda: resumed.train_iteration(samples, np.random.default_rng(seed)))
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((us, e.count, e.key))
    total = sum(r[0] for r in rows)
    check(total > 0, "the profiler recorded no device time")
    print(f"profile of one train step (the same stage): device time {total / 1e3:.1f} ms; "
          f"profiled wall {t_prof:.3f} s; device busy {total / 1e3 / (t_step * 1e3):.3f} of the "
          f"unprofiled step's {t_step:.3f} s; top 10 by device time:")
    for us, n_calls, key in sorted(rows, reverse=True)[:10]:
        print(f"  {us / 1e3:9.1f} ms {us / total:6.3f} {n_calls:6d} calls  {key[:90]}")

    dataset = runner.datasets["anomaly_detection"]["train"]
    images = [dataset._resize_crop(dataset.prepare_img(j)) for j in (0, TRAIN_PER_CLASS)]
    nsa = [_host_ms(lambda j=j, im=im: dataset._twin(j, im))
           for j, im in zip((0, TRAIN_PER_CLASS), images)]
    print(f"host NSA twin (patch_ex + normalise, one thread, median of 3): {nsa[0]:.1f} ms "
          f"bottle, {nsa[1]:.1f} ms screw", flush=True)
    resumed.train_loader.close()

    # one step with int8 LLM weights: the straight-through backward over 32 layers
    cfg = runner.config
    del runner, resumed, model, trainable, before, saved, arrays, loss, opt, p, frozen
    torch.cuda.empty_cache()
    cfg.model_cfg.llm_weight_dtype = "int8"
    t0 = time.time()
    model8 = train.tasks.setup_task(cfg).build_model(cfg, device=dev)
    print(f"int8 model built in {time.time() - t0:.1f} s", flush=True)
    proj = model8.module.llama.model.layers[0].mlp.down_proj
    store = {}
    handle = _grad_of_projection(proj, store)
    arrays, static = model8.prepare_train_arrays(samples, np.random.default_rng(seed))
    quant.int_mm_counter.count = 0

    def int8_step():
        loss = model8.train_loss(arrays, static)
        loss.backward()
        return loss

    loss8, wall8, launches8 = drive(checks, "train_int8", int8_step, [])
    loss8 = float(loss8.detach())
    handle.remove()
    int_mm8 = quant.int_mm_counter.count
    layers = model8.arch.llama.num_layers
    check(int_mm8 == layers * 7, f"torch._int_mm {int_mm8} times for {layers} x 7 projections")
    adaptor = [p.grad for n, p in model8.trainable_parameters() if n.startswith("expert_adaptor")]
    check(np.isfinite(loss8) and all(g is not None and float(g.norm()) > 0
                                            for g in adaptor),
          "int8 step: loss not finite or no gradient at expert_adaptor")
    dy, dx = store["dy"], store["dx"]
    ref = torch.matmul(dy.float().reshape(-1, dy.shape[-1]) * proj.scale,
                       proj.w_int8.float().t())
    err8 = rel(dx.float().reshape(ref.shape), ref)
    check(err8 <= 2e-2, f"int8 down_proj dx against dy @ dequant(W)^T: rel L2 {err8}")
    rows8 = dx.numel() // dx.shape[-1]
    print(f"int8 step ({rows8} rows a projection: W8A8 on torch._int_mm, {int_mm8} calls): "
          f"loss {loss8:.4f}, forward + backward {wall8:.3f} s, launches {launches8}; "
          f"expert_adaptor grad norms {', '.join(f'{float(g.norm()):.3e}' for g in adaptor)}; "
          f"layer 0 down_proj dx against dy @ dequant(W)^T in fp32: rel L2 {err8:.3e} "
          f"(tol 2e-2, bf16); card: {card}", flush=True)
    del model8, arrays, store
    torch.cuda.empty_cache()


# phase 13: the reference's checkpoint files, written from --seed
# the cut depths: a 32-layer fp32 LLaMA npz is 27 GB of disk, and the phase's
# write, convert and load move with the bytes (ImageBind stays whole: the
# converter tells its full config from the tiny one by its 32 vision blocks)
REFERENCE_LLAMA_LAYERS = 2  # of Vicuna-7B's 32
REFERENCE_VIT_BLOCKS = 4  # of EVA-ViT-g's 39
TOKENIZER_PIECES = 32000
# each tower's file (or directory) under the reference's names; the starred
# ones hold their state dict under a 'model' entry
REFERENCE_FILES = {"vit": "eva_vit_g.pth", "qformer": "blip2_pretrained.pth",
                   "llama_proj": "pretrained_minigpt4.pth", "imagebind": "imagebind_huge.pth",
                   "decoder": "pytorch_mvtec_model.pt", "trainables": "checkpoint_1.pth",
                   "llama": "vicuna-7b"}
WRAPPED = ("qformer", "llama_proj", "decoder", "trainables")


def reference_state_dicts(arch, randn, llama_layers=None, vit_blocks=None):
    """The reference's checkpoints of ``arch``'s towers under their own key
    names: LAVIS EVA-ViT-g, the BLIP-2 Q-Former ('Qformer.bert.*' with
    query_tokens and ln_vision), MiniGPT-4's llama_proj, ImageBind-huge, the
    AnomalyGPT decoder, a trainables checkpoint (LoraAdaptorV2,
    VEInstructorV2, VETokenizer) and an HF LLaMA of ``llama_layers`` layers,
    EVA of ``vit_blocks`` blocks (all of them by default).  ``randn(shape)``
    draws each leaf as an fp32 tensor; weights are scaled to 0.02, norms sit
    about 1.  {tower: sd}."""
    def w(*shape, scale=0.02):
        return randn(shape) * scale

    def norm(sd, name, dim):
        sd[name + ".weight"] = 1 + w(dim, scale=0.1)
        sd[name + ".bias"] = w(dim, scale=0.1)

    def lin(sd, name, d_in, d_out, bias=True):
        sd[name + ".weight"] = w(d_out, d_in)
        if bias:
            sd[name + ".bias"] = w(d_out)

    out = {}
    d, p = arch.vit_dim, arch.vit_patch
    hid, n_tok = int(d * arch.vit_mlp_ratio), (arch.img_size // p) ** 2 + 1
    sd = {"patch_embed.proj.weight": w(d, 3, p, p), "patch_embed.proj.bias": w(d),
          "cls_token": w(1, 1, d), "pos_embed": w(1, n_tok, d)}
    for i in range(arch.vit_depth if vit_blocks is None else vit_blocks):
        pre = f"blocks.{i}."
        norm(sd, pre + "norm1", d)
        norm(sd, pre + "norm2", d)
        lin(sd, pre + "attn.qkv", d, 3 * d, bias=False)
        sd[pre + "attn.q_bias"], sd[pre + "attn.v_bias"] = w(d), w(d)
        lin(sd, pre + "attn.proj", d, d)
        lin(sd, pre + "mlp.fc1", d, hid)
        lin(sd, pre + "mlp.fc2", hid, d)
    out["vit"] = sd

    h, inter = arch.qformer_hidden, arch.qformer_intermediate
    sd = {"query_tokens": w(1, arch.num_query_token, h)}
    norm(sd, "ln_vision", d)
    norm(sd, "Qformer.bert.embeddings.LayerNorm", h)
    for i in range(arch.qformer_layers):
        pre = f"Qformer.bert.encoder.layer.{i}."
        for att, kv in (("attention.", h),) + ((("crossattention.", d),) if i % 2 == 0 else ()):
            lin(sd, pre + att + "self.query", h, h)
            lin(sd, pre + att + "self.key", kv, h)
            lin(sd, pre + att + "self.value", kv, h)
            lin(sd, pre + att + "output.dense", h, h)
            norm(sd, pre + att + "output.LayerNorm", h)
        lin(sd, pre + "intermediate_query.dense", h, inter)
        lin(sd, pre + "output_query.dense", inter, h)
        norm(sd, pre + "output_query.LayerNorm", h)
    out["qformer"] = sd

    cfg = arch.llama
    out["llama_proj"] = {}
    lin(out["llama_proj"], "llama_proj", h, cfg.hidden_size)

    ib = arch.imagebind
    dv, dt, ps = ib.vision_embed_dim, ib.text_embed_dim, ib.patch_size
    sd = {"modality_preprocessors.vision.rgbt_stem.proj.1.weight": w(dv, 3, 2, ps, ps),
          "modality_preprocessors.vision.cls_token": w(1, 1, dv),
          "modality_preprocessors.vision.pos_embedding_helper.pos_embed":
              w(1, (ib.img_size // ps) ** 2 + 1, dv),
          "modality_heads.vision.2.weight": w(ib.out_embed_dim, dv),
          "modality_preprocessors.text.token_embedding.weight": w(ib.vocab_size, dt),
          "modality_preprocessors.text.pos_embed": w(1, ib.context_length, dt),
          "modality_heads.text.proj.1.weight": w(ib.out_embed_dim, dt),
          "modality_postprocessors.text.1.log_logit_scale": 2.6593 + w(scale=0.1)}
    norm(sd, "modality_trunks.vision.pre_transformer_layer.0", dv)
    norm(sd, "modality_heads.vision.0", dv)
    norm(sd, "modality_heads.text.proj.0", dt)
    for tower, dim, blocks in (("vision", dv, ib.vision_num_blocks),
                               ("text", dt, ib.text_num_blocks)):
        for i in range(blocks):
            pre = f"modality_trunks.{tower}.blocks.{i}."
            norm(sd, pre + "norm_1", dim)
            norm(sd, pre + "norm_2", dim)
            sd[pre + "attn.in_proj_weight"], sd[pre + "attn.in_proj_bias"] = (
                w(3 * dim, dim), w(3 * dim))
            lin(sd, pre + "attn.out_proj", dim, dim)
            lin(sd, pre + "mlp.fc1", dim, 4 * dim)
            lin(sd, pre + "mlp.fc2", 4 * dim, dim)
    out["imagebind"] = sd
    out["decoder"] = {}
    for i in range(len(ib.out_layers)):
        lin(out["decoder"], f"image_decoder.fc.{i}", dv, ib.out_embed_dim)

    sd = {"expert_adaptor.conv1.weight": w(arch.adaptor_rank, d),
          "expert_adaptor.conv2.weight": w(d, arch.adaptor_rank),
          "VETokenizer.base_prompts": w(9, cfg.hidden_size)}
    for net, head_out, k in (("VEInstructor", h, 1), ("VETokenizer", cfg.hidden_size, 5)):
        for idx, c_in, c_out in zip((0, 3, 6, 9, 12), (1, 4, 16, 64, 256),
                                    (4, 16, 64, 256, 1024)):
            sd[f"{net}.meta_net.{idx}.weight"] = w(c_out, c_in, 3, 3)
            sd[f"{net}.meta_net.{idx}.bias"] = w(c_out)
        sd[f"{net}.meta_net.15.weight"] = w(head_out, 1024, k, k)
        sd[f"{net}.meta_net.15.bias"] = w(head_out)
    out["trainables"] = sd

    e, f = cfg.hidden_size, cfg.intermediate_size
    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, e), "lm_head.weight": w(cfg.vocab_size, e),
          "model.norm.weight": 1 + w(e, scale=0.1)}
    for i in range(cfg.num_layers if llama_layers is None else llama_layers):
        pre = f"model.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[pre + f"self_attn.{name}.weight"] = w(e, e)
        sd[pre + "mlp.gate_proj.weight"], sd[pre + "mlp.up_proj.weight"] = w(f, e), w(f, e)
        sd[pre + "mlp.down_proj.weight"] = w(e, f)
        sd[pre + "input_layernorm.weight"] = 1 + w(e, scale=0.1)
        sd[pre + "post_attention_layernorm.weight"] = 1 + w(e, scale=0.1)
    out["llama"] = sd
    return out


def write_safetensors(path, tensors) -> None:
    """A ``.safetensors`` file (8-byte header length, JSON header, the bytes
    in order) without the safetensors package, which the card lacks."""
    import torch

    names = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}
    header, offset, blobs = {}, 0, []
    for name, t in tensors.items():
        raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int32 fields take ten bytes, as protobuf writes them
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def _field(number: int, value) -> bytes:
    """One protobuf field: bytes are length-delimited, a float fixed32, an
    int a varint."""
    import struct

    if isinstance(value, bytes):
        return _varint(number << 3 | 2) + _varint(len(value)) + value
    if isinstance(value, float):
        return _varint(number << 3 | 5) + struct.pack("<f", value)
    return _varint(number << 3) + _varint(value)


def write_tokenizer_model(path, seed, n_pieces) -> list:
    """A sentencepiece BPE ``tokenizer.model`` in LLaMA's layout: <unk>, <s>,
    </s>, the 256 byte pieces, seeded merges of printable ASCII and '▁'
    (scores falling with their order), then the characters.  Byte fallback
    on, the dummy prefix added.  Returns the pieces."""
    import random

    rng = random.Random(seed)
    chars = ["▁"] + [chr(c) for c in range(33, 127)]
    special = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)] + [
        (f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    n_merges = n_pieces - len(special) - len(chars)
    merged, known = [], set(chars) | {p[0] for p in special}
    while len(merged) < n_merges:
        pool = merged[-2000:] if merged and rng.random() < 0.5 else chars
        piece = rng.choice(pool) + rng.choice(chars if rng.random() < 0.7 else merged or chars)
        if piece not in known and len(piece) <= 12:
            known.add(piece)
            merged.append(piece)
    pieces = special + [(p, -float(i), 1) for i, p in enumerate(merged + chars)]
    body = b"".join(_field(1, _field(1, text.encode()) + _field(2, score) + _field(3, kind))
                    for text, score, kind in pieces)
    trainer = (_field(3, 2) + _field(35, 1) + _field(40, 0) + _field(41, 1) + _field(42, 2)
               + _field(43, -1))
    normalizer = _field(1, b"identity") + _field(3, 1) + _field(4, 0)
    with open(path, "wb") as f:
        f.write(body + _field(2, trainer) + _field(3, normalizer))
    return pieces


def write_reference_tree(root, sds, seed, dtypes=None) -> dict:
    """Write ``reference_state_dicts``'s towers under ``root`` by the
    reference's file names: torch files (``WRAPPED`` under 'model'), the
    LLaMA as an HF directory of two ``*.safetensors`` shards and a
    ``tokenizer.model``.  ``dtypes`` maps a tower to its stored dtype
    (fp32 where absent).  Returns {tower: path}."""
    import torch

    dtypes = dtypes or {}
    os.makedirs(root, exist_ok=True)
    paths = {}
    for tower, sd in sds.items():
        dtype = dtypes.get(tower, torch.float32)
        sd = {k: v.to(dtype) for k, v in sd.items()}
        path = paths[tower] = os.path.join(root, REFERENCE_FILES[tower])
        if tower == "llama":
            os.makedirs(path, exist_ok=True)
            names = list(sd)
            half = len(names) // 2
            for i, part in enumerate((names[:half], names[half:])):
                write_safetensors(os.path.join(path, f"model-0000{i + 1}-of-00002.safetensors"),
                                  {k: sd[k] for k in part})
            write_tokenizer_model(os.path.join(path, "tokenizer.model"), seed, TOKENIZER_PIECES)
        else:
            torch.save({"model": sd} if tower in WRAPPED else sd, path)
    return paths


def _expected_leaves(tower, tree):
    """A converted tower rooted where the model holds it (LLaMA int8 as the
    serving profile quantizes it): (tree, on the vision expert)."""
    from myriad_tpu_torch.ops import quant

    if tower == "qformer":
        rest = ("query_tokens", "ln_vision")
        return dict({"qformer": {k: v for k, v in tree.items() if k not in rest}},
                    **{k: tree[k] for k in rest}), False
    if tower == "llama":
        return {"llama": quant.quantize_tree(tree, mode="int8")}, False
    roots = {"vit": "visual_encoder", "decoder": "image_decoder"}
    tree = {roots[tower]: tree} if tower in roots else tree
    return tree, tower in ("imagebind", "decoder")


def _disk_bytes(path) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def reference_slice(dev, seed, checks, card):
    """Phase 13: the reference's own checkpoint files, written from --seed
    at full width (the LLaMA at REFERENCE_LLAMA_LAYERS of its layers, EVA
    at REFERENCE_VIT_BLOCKS of its blocks),
    converted by ``python -m myriad_tpu_torch.tools.convert_weights all``
    and served through the ``weights.yaml`` it writes, ``ckpt:`` and
    ``llama_model`` (the Vicuna directory's ``tokenizer.model``)."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from myriad_tpu_torch.common import yaml_subset
    from myriad_tpu_torch.convert_from_jax import jax_leaves
    from myriad_tpu_torch.models.myriad import Myriad, MyriadArch
    from myriad_tpu_torch.tokenization import LlamaTokenizer
    from myriad_tpu_torch.tools import convert_weights

    arch = MyriadArch.tiny() if SERVING["arch_preset"] == "tiny" else MyriadArch.full()
    if SERVING.get("llm_vocab_size"):
        arch = dataclasses.replace(arch, llama=dataclasses.replace(
            arch.llama, vocab_size=SERVING["llm_vocab_size"]))
    layers = min(REFERENCE_LLAMA_LAYERS, arch.llama.num_layers)
    blocks = min(REFERENCE_VIT_BLOCKS, arch.vit_depth)
    # fp16 where the reference ships fp16 (EVA-ViT-g, Vicuna) or the bytes
    # are many (ImageBind); a bf16 trainables checkpoint (a bf16 run's)
    dtypes = {"vit": torch.float16, "imagebind": torch.float16, "llama": torch.float16,
              "trainables": torch.bfloat16}
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="reference_", dir=os.path.join(REPO, "build"))
    try:
        t0 = time.time()
        sds = {t: {k: v.to(dtypes.get(t, torch.float32)).cpu() for k, v in sd.items()}
               for t, sd in reference_state_dicts(
                   arch, lambda shape: torch.randn(shape, generator=gen, device=dev),
                   layers, blocks).items()}
        paths = write_reference_tree(os.path.join(root, "src"), sds, seed, dtypes)
        src_bytes = sum(_disk_bytes(p) for p in paths.values())
        t_write = time.time() - t0
        print(f"wrote the reference's files ({', '.join(REFERENCE_FILES.values())}; "
              f"{src_bytes / 2**30:.2f} GiB; LLaMA {layers} of {arch.llama.num_layers} layers, EVA "
              f"{blocks} of {arch.vit_depth} blocks) "
              f"in {t_write:.1f} s", flush=True)

        out = os.path.join(root, "npz")
        t0 = time.time()
        check(convert_weights.main(["all", "--src", os.path.join(root, "src"), "--out", out])
              == 0, "convert_weights all failed")
        t_convert = time.time() - t0
        with open(os.path.join(out, "manifest.json")) as f:
            manifest = json.load(f)
        check(set(manifest) == set(REFERENCE_FILES), f"towers converted: {sorted(manifest)}")
        npz_bytes = sum(os.path.getsize(m["npz"]) for m in manifest.values())
        stanza = yaml_subset.load_file(os.path.join(out, "weights.yaml"))["model"]
        cfg = dict(SERVING, weights=dict(stanza["weights"]), ckpt=stanza["ckpt"],
                   llama_model=paths["llama"])

        model = Myriad.from_config(cfg, device=dev, class_names=SCENES)
        tok = model.llama_tokenizer
        check(isinstance(tok, LlamaTokenizer) and tok.vocab_size == TOKENIZER_PIECES,
              f"llama_model gave {type(tok).__name__}")
        samples = _samples(seed, arch.img_size)
        weights, ckpt = model.weights, model.ckpt_path
        model.weights, model.ckpt_path = {}, ""  # the same seed's model without the files
        model.init_random(seed)
        model.vision_expert.build_text_features()
        bare = model.generate(samples, max_new_tokens=NEW_TOKENS)["token_ids"]
        model.weights, model.ckpt_path = weights, ckpt
        t0 = time.time()
        model.init_random(seed)
        torch.cuda.synchronize()
        t_load = time.time() - t0

        report = model.weights_report
        def in_cut(path):
            parts = path.split("/")
            if path.startswith("llama/model/layers_"):
                return int(parts[2].split("_")[1]) >= layers
            return (path.startswith("visual_encoder/blocks_")
                    and int(parts[1].split("_")[1]) >= blocks)
        cut = [p for p in report["missing"] if not in_cut(p)]
        check(not cut, f"weights missing beyond the cut LLaMA layers and EVA blocks: {cut[:5]}")
        n_cut = len(report["missing"])
        n_leaves = 0
        params = {False: model.module.state_dict(),
                  True: model.vision_expert.module.state_dict()}
        for tower, sd in sds.items():
            tree, on_ve = _expected_leaves(tower, convert_weights.convert_tower(tower, sd))
            for path, name, want in jax_leaves(tree):
                live = params[on_ve][name]
                check(torch.equal(live, want.to(live.device).to(live.dtype)),
                      f"{tower}: loaded {path} differs from the in-memory conversion")
                n_leaves += 1
        del params
        print(f"converted in {t_convert:.1f} s ({npz_bytes / 2**30:.2f} GiB of npz, "
              f"{len(manifest)} towers, {sum(m['params'] for m in manifest.values()) / 1e9:.3f}"
              f"e9 params); loaded through weights:, ckpt: and llama_model in {t_load:.1f} s; "
              f"{n_leaves} leaves bit-equal to converting the in-memory state dicts (LLaMA "
              f"quantized to int8); missing: {n_cut} leaves, all in the cut LLaMA layers "
              f"and EVA blocks",
              flush=True)

        model.vision_expert.build_text_features()
        model.generate(samples, max_new_tokens=4)  # warm-up
        names = ["B1 int8_matmul", "B2 decode_attention", "B3 prefill_attention", "B4 kv_write"]
        res, wall, launches = drive(
            checks, "reference_weights",
            lambda: model.generate(samples, max_new_tokens=NEW_TOKENS), names)
        tokens = res["token_ids"]
        check_tokens(tokens, BATCH, NEW_TOKENS, model.arch.llama.vocab_size)
        changed = (tokens != bare).float().mean().item()
        check(changed > 0, "the loaded weights left the tokens as the random model's")
        for ids in model.split_prompt(AQA_QUESTION):
            ids = ids.tolist()
            text = tok.batch_decode([ids])[0]
            check(tok(text, add_special_tokens=False)["input_ids"] == ids,
                  f"decoding and re-encoding the prompt piece {text!r} changed its ids")
        print(f"generate with the reference's weights: {BATCH / wall:.4f} images/s ({wall:.3f} "
              f"s, one run, batch {BATCH}, {NEW_TOKENS} new tokens); launches {launches}; "
              f"{changed:.4f} of the tokens differ from the same seed's model without the "
              f"files; prompt ids survive decode and re-encode; row 0 decodes to "
              f"{tok.batch_decode(tokens[:1].tolist())[0][:80]!r}", flush=True)
        print(f"phase 13 seconds: write {t_write:.1f}, convert {t_convert:.1f}, load "
              f"{t_load:.1f}, generate {wall:.3f}; npz bytes {npz_bytes}; card: {card}",
              flush=True)
        del model
    finally:
        shutil.rmtree(root, ignore_errors=True)


def say(t_start, title) -> None:
    """A phase's header, with the seconds since the build started."""
    print(f"{title} [{time.time() - t_start:.0f} s]", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--parent", help="a checkout of another tree (e.g. the parent "
                        "commit's): compare its kernels' SASS with this tree's and time its "
                        "kernels beside this tree's before phase 2")
    parser.add_argument("--parent-kernels", default=",".join(n for n, _ in PHASE2),
                        help="the kernels that --parent times, comma-separated "
                        "(default: all, %(default)s)")
    args = parser.parse_args(argv)
    kernels = args.parent_kernels.split(",")
    if any(k not in dict(PHASE2) for k in kernels):
        parser.error(f"--parent-kernels takes names from {[n for n, _ in PHASE2]}")

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

    t0 = t_start = time.time()
    lib_path = _cuda.build()
    _cuda.library()
    print(f"phase 1: kernels built in {time.time() - t0:.1f} s", flush=True)
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas: " + line.split("ptxas info    : ")[-1].strip())
    for name, kernel in (("B1", "int8_matmul_tc_kernel"), ("B3", "prefill_attention_tc_kernel"),
                         ("B5", "int4_matmul_tc_kernel")):
        hmma, first = sass_count(lib_path, kernel, "HMMA")
        print(f"  sass (cuobjdump -sass): {hmma} HMMA instructions in {name}'s {kernel}, all "
              f"instantiations; first: {first}", flush=True)
        check(hmma > 0, f"{name}'s tensor-core kernel has no HMMA instruction")
    cluster_launch_report(lib_path)
    if args.parent:
        parent_comparison(args.parent, kernels, args.seed, lib_path)

    say(t_start, "phase 2: kernels against their plain versions")
    checks = kernel_checks(dev, args.seed)
    card = _card()
    say(t_start, "phase 3: full-width Myriad.generate")
    model, samples, greedy, embeds = full_slice(dev, args.seed, checks, card)
    say(t_start, "phase 4: full-width speculative generate")
    spec, spec_wall = spec_slice(dev, args.seed, model, checks, card, samples, greedy, embeds)
    del model
    say(t_start, "phase 5: full-width chat on the resident cache")
    chat_slice(dev, args.seed, spec, checks, card)
    profile_generate(spec, samples, card, spec_wall,
                     f"speculative generate (prompt-lookup drafts, K={SPEC_K})")
    del spec
    torch.cuda.empty_cache()
    say(t_start, "phase 6: full-width Myriad with int4 LLM weights")
    model4, samples4 = int4_slice(dev, args.seed, checks, card)
    say(t_start, "phase 7: row decode, device_preprocess and the bandwidth probe")
    entry_point_slice(dev, args.seed, checks, card, model4, samples4)
    del model4
    torch.cuda.empty_cache()
    say(t_start, "phase 8: the AQA evaluation entry point at full width")
    model8, eval_argv, eval_out, dataset = eval_slice(dev, args.seed, checks, card)
    say(t_start, "phase 9: the continuous-batching engine at full width")
    engine_slice(dev, args.seed, checks, card, model8, eval_argv, eval_out)
    say(t_start, "phase 11: one-shot maps, the expert mux and no expert on phase 8's model")
    expert_slice(dev, args.seed, checks, card, model8, eval_argv, eval_out, dataset)
    del model8
    torch.cuda.empty_cache()
    say(t_start, "phase 12: the TPU harness's profile (int8 towers, weights:) at full width")
    harness_slice(dev, args.seed, checks, card, eval_out, dataset)
    torch.cuda.empty_cache()
    say(t_start, "phase 13: the reference's checkpoint files, converted and served")
    reference_slice(dev, args.seed, checks, card)
    torch.cuda.empty_cache()
    say(t_start, "phase 14: Orbax checkpoints: the zstd decoder and the JAX-written fixture")
    orbax_rates = orbax_slice(card)
    say(t_start, "phase 10: stage-2 LoRA fine-tuning at full width")
    train_slice(dev, args.seed, checks, card, orbax_rates)
    say(t_start, "all phases done")
    print(card)
    print(json.dumps({"kernels": [c.record() for c in checks]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
