"""Terminal chat over the port's Myriad (counterpart of the repository's
``demo.py``): a stdin REPL over ``conversation.Chat``.

    python -m myriad_tpu_torch.demo --image image.npy [--seed 0] \\
        [--options arch_preset=tiny llm_spec_k=3 ...] [--device cuda]

The image is an ``.npy`` HWC uint8 array of the model's image size (the port
reads no image files: PIL is not a dependency).  ``--options`` are the JAX
package's config keys that ``Myriad.from_config`` reads (``arch_preset``,
``llm_weight_dtype``, ``llm_kv_dtype``, ``llm_spec_k``, ...).  No checkpoint
loading is ported, so the weights are random, drawn from ``--seed``.  It runs
on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import ast
import sys
from typing import Dict, Optional, Sequence

import numpy as np


def parse_options(pairs: Optional[Sequence[str]]) -> Dict[str, object]:
    """``key=value`` strings -> a config dict; values are Python literals
    where they parse as one (``3``, ``True``), else strings (``int8``)."""
    cfg: Dict[str, object] = {}
    for pair in pairs or ():
        key, sep, value = pair.partition("=")
        if not sep or not key:
            raise ValueError(f"option {pair!r} is not key=value")
        try:
            cfg[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            cfg[key] = value
    return cfg


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Myriad chat demo (PyTorch port)")
    parser.add_argument("--image", required=True, help=".npy HWC uint8 image to chat about")
    parser.add_argument("--options", nargs="+", help="config overrides, key=value")
    parser.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    parser.add_argument("--max-new-tokens", type=int, default=90)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from myriad_tpu_torch.conversation import CONV_VISION, Chat
    from myriad_tpu_torch.models.myriad import Myriad

    model = Myriad.from_config(parse_options(args.options), device=args.device)
    model.init_random(args.seed)
    image = np.load(args.image)
    size = model.arch.img_size
    if image.dtype != np.uint8 or image.shape != (size, size, 3):
        raise ValueError(f"--image must hold a ({size}, {size}, 3) uint8 array, got "
                         f"{image.dtype} {image.shape}")
    chat = Chat(model)
    conv = CONV_VISION.copy()
    img_list = []
    print(chat.upload_img(image, conv, img_list))
    print("Type a question ('quit' to exit).")
    for line in sys.stdin:
        q = line.strip()
        if not q or q.lower() in ("quit", "exit"):
            break
        chat.ask(q, conv)
        text, _ = chat.answer(conv, img_list, max_new_tokens=args.max_new_tokens)
        print("myriad>", text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
