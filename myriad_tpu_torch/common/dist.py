"""Process plumbing for one process on one card (counterpart of
``myriad_tpu/common/dist.py``).

The port trains in one process: rank 0 of a world of 1.  Data parallelism
across cards is not ported; ``init_distributed_mode`` raises when the run
config or the launcher asks for more than one process, or for a device mesh
(``model_shards`` > 1, ``use_mesh``).
"""

from __future__ import annotations

import os


def init_distributed_mode(run_cfg=None) -> None:
    run_cfg = run_cfg or {}
    world = max(int(run_cfg.get("world_size", 1) or 1), int(os.environ.get("WORLD_SIZE", "1")))
    if world > 1:
        raise NotImplementedError(f"world_size={world}: data parallelism across cards is "
                                  "not ported; the port trains in one process")
    if int(run_cfg.get("model_shards", 1) or 1) > 1 or run_cfg.get("use_mesh"):
        raise NotImplementedError(f"model_shards={run_cfg.get('model_shards')}, use_mesh="
                                  f"{run_cfg.get('use_mesh')}: a device mesh is not ported")


def get_rank() -> int:
    return 0


def is_main_process() -> bool:
    return True


def barrier(name: str = "barrier") -> None:
    """A no-op in one process."""
