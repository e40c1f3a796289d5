"""uint8 image normalisation (counterpart of ``myriad_tpu/ops/preprocess.py``).

``u8_normalize`` is the plain version the JAX models call (its XLA path);
the Pallas variant there (``u8_normalize_pallas``) is not on the ported path.
"""

from __future__ import annotations

import torch

# CLIP statistics, copied from myriad_tpu/processors/functional.py (which
# imports PIL); tests/test_torch_myriad.py holds the copies equal.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def u8_normalize(images_u8: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD,
                 out_dtype=torch.float32) -> torch.Tensor:
    """uint8 (..., 3) -> ((x / 255) - mean) / std in ``out_dtype``."""
    x = images_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).to(out_dtype)
