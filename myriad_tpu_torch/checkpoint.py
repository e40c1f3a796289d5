"""Training checkpoints (counterpart of ``myriad_tpu/checkpoint.py``'s ring and
merge).

``CheckpointManager`` keeps the JAX package's ring rule: a save with an
integer tag (or a string of digits) joins the ring, and past
``max_checkpoints`` the oldest is deleted; other tags ("best") stay.  Each
save is one ``torch.save`` file, ``checkpoint_{tag}.pth``, holding the
trainable parameters by name (``model``), the optimizer's state
(``optimizer``), ``epoch``, ``global_step`` and a ``format`` marker that
tells the port's files from any other ``.pth``.  ``merge_into`` copies a
saved state into live parameters by name with the JAX ``merge_trees`` rule
(strict=False: unknown names and shape mismatches skipped, missing ones
kept, values cast to the parameter's dtype).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Mapping, Tuple

import torch

FORMAT = "myriad_tpu_torch.checkpoint/1"


@torch.no_grad()
def merge_into(params: Mapping[str, torch.Tensor],
               incoming: Mapping[str, torch.Tensor]) -> Tuple[List[str], List[str]]:
    """Copy ``incoming`` into ``params`` where a name and shape match; returns
    (loaded, skipped) names."""
    loaded, skipped = [], []
    for name, value in incoming.items():
        target = params.get(name)
        if target is None:
            skipped.append(name)
        elif tuple(target.shape) != tuple(value.shape):
            logging.warning("shape mismatch at %s: %s vs %s; skipped", name,
                            tuple(target.shape), tuple(value.shape))
            skipped.append(name)
        else:
            target.copy_(value.to(device=target.device, dtype=target.dtype))
            loaded.append(name)
    return loaded, skipped


def load_checkpoint(path: str) -> Dict:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict) or state.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of myriad_tpu_torch's CheckpointManager")
    return state


def is_port_checkpoint(path: str) -> bool:
    """Whether ``path`` is a file that the port's ``CheckpointManager`` wrote."""
    if not os.path.isfile(path):
        return False
    try:
        load_checkpoint(path)
    except Exception:  # any other file: a pickle, an archive, an npz
        return False
    return True


class CheckpointManager:
    """Epoch checkpoints with ring retention (the JAX package's
    ``CheckpointManager`` rule, one ``.pth`` file a save)."""

    def __init__(self, output_dir: str, max_checkpoints: int = -1):
        self.output_dir = output_dir
        self.max_checkpoints = max_checkpoints
        self._saved: List[str] = []
        os.makedirs(output_dir, exist_ok=True)

    def path(self, tag) -> str:
        return os.path.join(self.output_dir, f"checkpoint_{tag}.pth")

    def save(self, tag, state: Dict) -> str:
        """Write ``state`` (tensors, nested dicts and scalars) as
        ``checkpoint_{tag}.pth``; an integer tag joins the ring."""
        path = os.path.abspath(self.path(tag))
        tmp = path + ".tmp"
        torch.save(dict(state, format=FORMAT), tmp)
        os.replace(tmp, path)
        if isinstance(tag, int) or (isinstance(tag, str) and tag.isdigit()):
            self._saved.append(path)
            if self.max_checkpoints > 0 and len(self._saved) > self.max_checkpoints:
                victim = self._saved.pop(0)
                if os.path.exists(victim):
                    os.remove(victim)
        return path
