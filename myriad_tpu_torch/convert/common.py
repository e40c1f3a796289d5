"""What every converter shares: a checkpoint leaf as float32 numpy.

The JAX converters cast through ``x.detach().cpu().numpy()``, which numpy
refuses for a bfloat16 tensor (``Got unsupported ScalarType BFloat16``).
The port widens a torch tensor with ``.float()`` first, as the JAX
``checkpoint.load_params`` does; every other dtype converts to the same
bytes as the JAX ``_t``.
"""

from __future__ import annotations

import numpy as np


def f32(x) -> np.ndarray:
    """A torch tensor or array-like as a float32 numpy array (a copy)."""
    if hasattr(x, "detach"):
        t = x.detach().cpu()
        wide = t.float()
        # .float() copies unless the tensor is float32 already
        return wide.numpy() if wide is not t else wide.numpy().copy()
    return np.asarray(x).astype(np.float32)
