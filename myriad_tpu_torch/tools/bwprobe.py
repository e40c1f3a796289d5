"""Measure the card's device-memory streaming bandwidth (counterpart of
``tools/bwprobe.py``).

    python -m myriad_tpu_torch.tools.bwprobe [--gb 6.5] [--dtype int8] [--iters 8] \\
        [--impl cuda|cuda2|torch] [--block 512] [--device cuda]

A decode step is bound by its bytes over the bandwidth the card sustains,
so this probe streams one multi-GB operand (rows of 4096) per pass and
reports bytes / time per pass:

- ``cuda``: kernel B7 (``csrc/bwprobe.cu``), a grid-summed fp32 reduction,
  one CUDA block per ``--block`` rows, plus a scalar ``c`` per block that
  differs per pass, as the TPU probe's ``_sum_kernel``;
- ``cuda2``: the same over TWO half-size operands in one kernel (the TPU
  probe's ``pallas2``): does a second concurrent stream raise the total?
- ``torch``: one ``torch.sum`` per pass, the library's own streaming
  reduction (the TPU probe's ``xla``), as the yardstick.

On the card the passes are timed with CUDA events; ``--device cpu`` runs
the plain versions on the CPU at a tiny size, timed by the host clock (a
CPU number, not the card's).
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import time
from typing import Optional

import torch

from myriad_tpu_torch.ops import _cuda

WIDTH = 4096  # elements a row, as the TPU probe's lanes
counter = _cuda.LaunchCounter("stream_sum")


def stream_sum_plain(x: torch.Tensor, c: float, block: int,
                     y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of B7: sum(x) (+ sum(y)) + c * (rows // block), fp32,
    over the first (rows // block) * block rows, as the TPU grid reads them."""
    n_blocks = x.shape[0] // block
    rows = n_blocks * block
    total = torch.sum(x[:rows], dtype=torch.float32)
    if y is not None:
        total = total + torch.sum(y[:rows], dtype=torch.float32)
    return total + torch.full((), float(c) * n_blocks, dtype=torch.float32, device=x.device)


def stream_sum(x: torch.Tensor, c: float, block: int,
               y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (rows, W) int8 or bf16 [and y of the same shape] -> a 0-d fp32
    tensor: kernel B7 on the card, the plain version on the CPU."""
    if not x.is_cuda:
        return stream_sum_plain(x, c, block, y)
    rows = x.shape[0]
    _cuda.require(x.dim() == 2 and x.dtype in (torch.int8, torch.bfloat16),
                  f"stream_sum takes a 2-D int8 or bf16 operand, got {x.dtype} {tuple(x.shape)}")
    _cuda.require(block >= 1 and rows % block == 0,
                  f"rows ({rows}) must be a multiple of the block ({block})")
    block_elems = block * x.shape[1]
    _cuda.require(block_elems * x.element_size() % 16 == 0,
                  "a block must be a multiple of 16 bytes")
    _cuda.require(y is None or (y.shape == x.shape and y.dtype == x.dtype
                                and y.device == x.device and y.is_contiguous()),
                  "y must match x")
    _cuda.require(x.is_contiguous(), "stream_sum takes a contiguous operand")
    _cuda.require(x.data_ptr() % 16 == 0 and (y is None or y.data_ptr() % 16 == 0),
                  "operands must be 16-byte aligned")
    n_blocks = rows // block
    partial = torch.empty(n_blocks, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    err = _cuda.library().myriad_stream_sum(
        x.data_ptr(), None if y is None else y.data_ptr(), partial.data_ptr(), out.data_ptr(),
        n_blocks, block_elems, float(c), int(x.dtype == torch.bfloat16),
        _cuda.stream_ptr(x.device))
    _cuda.check(err, "stream_sum")
    counter.count += 1
    return out


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu (host clock: not a card measurement)"
    name = torch.cuda.get_device_name(device)
    smi = shutil.which("nvidia-smi")
    if smi:
        res = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        if res.returncode == 0 and res.stdout.strip():
            return res.stdout.strip().splitlines()[0]
    return name


def probe(gb: float, dtype: str = "int8", iters: int = 8, impl: str = "cuda",
          block: int = 512, device="cuda") -> dict:
    """Stream ``gb`` GiB per pass ``iters`` times; returns the pass time, the
    bytes a pass reads and the rate, and prints one line."""
    dev = torch.device(device)
    dt = getattr(torch, dtype)
    itemsize = torch.empty((), dtype=dt).element_size()
    rows = int(gb * (1 << 30) / (WIDTH * itemsize))
    if impl == "cuda2":  # two half-size operands: the same total traffic
        rows //= 2
    rows -= rows % block
    if rows <= 0:
        raise ValueError(f"--gb {gb} is less than one block of {block} x {WIDTH}")
    x = torch.ones((rows, WIDTH), dtype=dt, device=dev)
    y = torch.ones_like(x) if impl == "cuda2" else None
    nbytes = rows * WIDTH * itemsize * (2 if y is not None else 1)
    if impl == "torch":
        def one(c):
            return torch.sum(x, dtype=torch.float32) + c
    elif impl in ("cuda", "cuda2"):
        def one(c):
            return stream_sum(x, c, block, y)
    else:
        raise ValueError(f"unknown --impl {impl!r}")
    print(f"operand {nbytes / 2**30:.2f} GiB ({'2 x ' if y is not None else ''}{rows}x{WIDTH} "
          f"{dtype}), block {block}x{WIDTH} = {block * WIDTH * itemsize / 2**20:.1f} MB",
          flush=True)

    results = []
    one(0.0).item()  # build and warm up
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            results.append(one(float(i)))
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for i in range(iters):
            results.append(one(float(i)))
        seconds = time.perf_counter() - t0
    per_pass = seconds / iters
    rate = nbytes / per_pass / 1e9
    card = _card(dev)
    print(f"impl={impl}: {iters} passes in {seconds:.4f} s -> {per_pass * 1e3:.4f} ms/pass = "
          f"{rate:.1f} GB/s effective; {card}", flush=True)
    return {"impl": impl, "dtype": dtype, "bytes": nbytes, "ms_per_pass": per_pass * 1e3,
            "gb_per_s": rate, "card": card, "sums": [float(r) for r in results]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gb", type=float, default=6.5)
    p.add_argument("--dtype", default="int8", choices=["int8", "bfloat16"])
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--impl", default="cuda", choices=["cuda", "cuda2", "torch"])
    p.add_argument("--block", type=int, default=512,
                   help="rows per CUDA block; a row is 4096 elements "
                        "(block 512 at int8 = 2 MB)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("bwprobe: no CUDA device (pass --device cpu for the plain version)",
              file=sys.stderr)
        return 2
    probe(args.gb, args.dtype, args.iters, args.impl, args.block, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
