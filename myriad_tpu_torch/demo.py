"""Terminal chat over the port's Myriad (counterpart of the repository's
``demo.py``, with its command line): a stdin REPL over ``conversation.Chat``.

    python -m myriad_tpu_torch.demo --cfg-path eval_configs/myriad.yaml --image x.png \\
        [--max-new-tokens 90] [--options model.llm_weight_dtype=int8 run.device=cpu ...] \\
        [--seed 0]

The steps are the reference demo's: the YAML is merged with the dotted
``--options`` (``common.config.Config``); the model is ``model.arch``'s,
built by its ``from_config`` on ``run.device`` (the card when unset; ``cpu``
runs it on the CPU), its weights random from ``--seed`` where ``weights:``
and ``ckpt:`` supply none; the image is decoded (PNG; a JPEG raises
``NotImplementedError``) and resized to the model's image size with PIL's
bicubic filter (``processors.functional.pil_resize``); ``Chat`` normalises
it with ``LocImageTrainProcessor(identity=True)``.
"""

from __future__ import annotations

import argparse
import sys

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Myriad chat demo (PyTorch port)")
    parser.add_argument("--cfg-path", required=True, help="path to the configuration YAML")
    parser.add_argument("--image", required=True,
                        help="PNG image to chat about (JPEG decoding is not ported yet)")
    parser.add_argument("--max-new-tokens", type=int, default=90)
    parser.add_argument("--options", nargs="+",
                        help="override settings of the YAML, as dotted key=value pairs "
                             "(model.llm_weight_dtype=int8 run.device=cpu)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights that weights: and ckpt: do not replace")
    args = parser.parse_args(argv)

    from myriad_tpu_torch.common.config import Config, get_model_class
    from myriad_tpu_torch.conversation import CONV_VISION, Chat
    from myriad_tpu_torch.datasets.png import read_png
    from myriad_tpu_torch.processors.blip_processors import LocImageTrainProcessor
    from myriad_tpu_torch.processors.functional import pil_resize

    cfg = Config(args)
    run = cfg.run_cfg if cfg.config.get("run") else {}
    device = torch.device(run.get("device") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the demo runs on the card (run.device is {run.get('device')!r}), "
                           "and torch sees no CUDA device; set run.device: cpu to run it on "
                           "the CPU")
    model = get_model_class(cfg.model_cfg.arch).from_config(cfg.model_cfg, device=device)
    model.init_random(args.seed)
    chat = Chat(model, LocImageTrainProcessor(identity=True))
    conv = CONV_VISION.copy()
    img_list = []
    size = model.arch.img_size
    print(chat.upload_img(pil_resize(read_png(args.image), size, size), conv, img_list))
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
