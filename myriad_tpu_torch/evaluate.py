"""AQA/AD evaluation over the port (counterpart of the repository's
``evaluation_aqa_dataset.py``: the same CLI, jsonl rows and ``--bench`` line).

    python -m myriad_tpu_torch.evaluate --cfg-path eval_configs/myriad.yaml \\
        [--bs 8] [--greedy] [--bench] [--options model.llm_weight_dtype=int8 ...]

Builds the model from ``--cfg-path`` (``common.config.Config``: the YAML, the
port's copies of the default YAMLs, ``--options``), runs batched greedy
decode over the MVTec AD test jsonl and writes one row per image:
{image_id, image_path, is_anomaly, output, error, anomaly_score}.  The
weights are drawn from the model section's ``seed`` (0 when unset), as the
JAX ``from_config`` seeds its initialisation, and the converted towers of
``weights:`` (npz paths; ``q_former_model`` a local BLIP-2 file) and an npz
or port ``ckpt:`` load over them; the towers serve in int8 with
``model.vit_weight_dtype=int8``, ``ve_weight_dtype`` and
``qformer_weight_dtype`` (the TPU harness's profile).

It runs on the card named by the config's ``run.device`` (``cuda`` when
unset; without a card that raises), and ``run.device: cpu`` runs it on the
CPU.  The images are decoded and resized on the host exactly as PIL does
(``datasets.png``, ``processors.functional``) and normalised to float32, as
the JAX harness feeds its towers.  ``--engine`` serves every image as a
request of the continuous-batching engine over ``--bs`` slots
(``serving.MyriadServing``), with the same rows and a ``--bench`` line of its
own.  ``--k_shot`` > 0 serves one-shot maps against a reference bank of
each class's ``train/good`` images (``setup_vision_expert``, the JAX
harness's rule: MVTec's ``{4 * round_index + i:03d}.png``, else the sorted
listing's first).  VisA's JPEGs are not ported and raise.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import deque
from datetime import datetime
from typing import Dict

import numpy as np
import torch

from myriad_tpu_torch.common.config import Config, get_model_class
from myriad_tpu_torch.datasets.anomaly_detection import AnomalyDetectionDataset
from myriad_tpu_torch.datasets.loaders import DataLoader
from myriad_tpu_torch.datasets.png import read_png
from myriad_tpu_torch.models.vision_expert import ReferenceSpec
from myriad_tpu_torch.processors import functional as F

LIVE_TASKS = ("ad", "ad_few", "1cls", "shot")
DEAD_TASKS = ("aqa", "roi", "al", "adroi")  # reference classes missing (SURVEY §2.8)

ANNO_FILES = {
    "ad": {"eval": "DC_MVTEC_test_normal.jsonl"},
    "ad_few": {"eval": "DC_VISA_test_normal.jsonl"},
    "1cls": {"visa": "DC_VISA_test_normal.jsonl", "mvtec": "DC_MVTEC_test_normal.jsonl"},
    "shot": {"visa": "DC_VISA_test_normal.jsonl", "mvtec": "DC_MVTEC_test_normal.jsonl"},
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AQA evaluation (PyTorch port)")
    p.add_argument("--cfg-path", required=True)
    p.add_argument("--task_type", type=str, default="1cls",
                   choices=LIVE_TASKS + DEAD_TASKS)
    p.add_argument("--split", type=str, default="mvtec",
                   choices=["eval", "test", "train", "visa", "mvtec"])
    p.add_argument("--ckpt", type=int, default=-1)
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--round_index", type=int, default=14)
    p.add_argument("--k_shot", type=int, default=0)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--greedy", action="store_true",
                   help="deterministic argmax decode (the default top_p=0.01 sampling "
                        "is routed to the same greedy path)")
    p.add_argument("--max_new_tokens", type=int, default=90)
    p.add_argument("--engine", action="store_true",
                   help="serve the images through the continuous-batching engine, --bs slots")
    p.add_argument("--engine-segment", type=int, default=32)
    p.add_argument("--engine-block", type=int, default=8,
                   help="the JAX engine's block KV layout; not ported: per-row frontiers")
    p.add_argument("--engine-admit-chunk", type=int, default=8)
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="batches generated before the oldest one's rows are written")
    p.add_argument("--bench", action="store_true",
                   help="print a JSON throughput line (images/sec, excluding the first "
                        "batch) after the run")
    p.add_argument("--save_path", type=str, default="")
    p.add_argument("--options", nargs="+")
    return p.parse_args(argv)


def build_dataset(args, ds_cfg, data_root: str) -> AnomalyDetectionDataset:
    if args.task_type in DEAD_TASKS:
        raise SystemExit(
            f"task_type '{args.task_type}' references dataset classes that do "
            "not exist in the reference tree (SURVEY.md §2.8); live types: "
            f"{LIVE_TASKS}"
        )
    ad_cfg = ds_cfg.get("anomaly_detection", {})
    ann = ANNO_FILES[args.task_type][args.split]
    return AnomalyDetectionDataset(
        data_root,
        ve_root=ad_cfg.get("build_info", {}).get("ve_storage", ""),
        ann_paths=[ann],
        img_size=ad_cfg.get("img_size", 224),
        crop_size=ad_cfg.get("crop_size", 224),
        with_mask=ad_cfg.get("with_mask", False),
        is_preload=ad_cfg.get("is_preload", True),
        stage="test",
    )


def load_reference_images(paths, size: int = 224) -> np.ndarray:
    """One-shot reference images as the JAX harness preprocesses them (PIL's
    bicubic resize of the short edge to ``size``, centre crop, CLIP
    normalisation): (K, size, size, 3) float32."""
    return np.stack([F.normalize(F.to_float_hwc(F.center_crop(
        F.resize_bicubic(read_png(p), size), size))) for p in paths])


def setup_vision_expert(model, dataset, data_root: str, round_index: int, k_shot: int) -> None:
    """Point the vision expert at the test set's classes (sorted), build their
    text features once, and build the one-shot reference bank, as the JAX
    harness does (also at ``k_shot = 0``, where generate does not read it):
    per class the first ``ReferenceSpec.effective_k`` of MVTec's names
    ``{4 * round_index + i:03d}.png`` under ``{root}/{mvtec|visa}/{class}/
    train/good`` that exist, else the first of that folder's sorted listing;
    a class without images gets a zero bank."""
    ve = model.vision_expert
    if ve is None:
        return
    classes = sorted({ann["img_path"].split("/")[1] for ann in dataset.annotation})
    ve.class_names = classes
    ve.class_index = {c: i for i, c in enumerate(classes)}
    ve._text_feats = ve._ref_bank = None
    ve.build_text_features()

    spec = ReferenceSpec(round_index=round_index, k_shot=k_shot)
    refs = {}
    ds_name = "visa" if dataset.is_visa else "mvtec"
    for cls in classes:
        good = os.path.join(data_root, ds_name, cls, "train", "good")
        paths = [os.path.join(good, n) for n in spec.mvtec_names()
                 if os.path.isfile(os.path.join(good, n))]
        if not paths and os.path.isdir(good):
            paths = [os.path.join(good, n) for n in sorted(os.listdir(good))[:spec.effective_k]]
        if paths:
            refs[cls] = load_reference_images(paths, model.arch.imagebind.img_size)
    if refs:
        ve.build_reference_bank(refs)


def build_model(args, cfg: Config):
    """The model of ``cfg``'s model section on ``run.device`` (``cuda`` when
    unset), with random weights drawn from its ``seed`` and the configured
    ``weights`` and ``ckpt`` loaded over them."""
    run = cfg.run_cfg if cfg.config.get("run") else {}
    device = torch.device(run.get("device") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluate runs on the card (run.device is "
                           f"{run.get('device')!r}), and torch sees no CUDA device; "
                           "set run.device: cpu to run it on the CPU")
    model_config = cfg.model_cfg
    model_config.round_index = args.round_index
    model_config.k_shot = args.k_shot
    if model_config.get("vit_precision") != "fp32":
        # frozen towers stored in bf16, as the JAX harness serves them
        model_config.setdefault("param_policy", "bf16_params")
    if args.ckpt != -1 and model_config.get("ckpt"):
        parts = model_config.ckpt.split("/")
        parts[-1] = f"checkpoint_{args.ckpt}"
        model_config.ckpt = "/".join(parts)
    model = get_model_class(model_config.arch).from_config(model_config, device=device)
    model.init_random(model_config.get("seed", 0))
    return model


def _save_path(args, cfg: Config) -> str:
    ckpt_name = os.path.basename(str(cfg.model_cfg.get("ckpt", "checkpoint_0")))
    num_ckpt = ckpt_name.split("_")[-1].split(".")[0] or "0"
    prefix = (
        f"results_ckpt{num_ckpt}_training={args.task_type}_split={args.split}"
        f"_kshot={args.k_shot}_roundindex={args.round_index}"
        f"_{datetime.now().strftime('%Y%m%d_%H%M')}"
    )
    return args.save_path or os.path.join(".", f"{prefix}.jsonl")


def device_mem_mb(device) -> float:
    """Peak device memory allocated by torch, MiB (0.0 off the card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated(device) / (1024 * 1024)


def result_row(image_id, img_path: str, is_anomaly, text: str, score=None) -> Dict:
    """One jsonl row: the answer cut at '###', and ``error`` "0" when it says
    Yes of an anomalous image or No of a normal one."""
    text = text.split("###")[0]
    is_anomaly = bool(is_anomaly)
    ok = ("Yes" in text and is_anomaly) or ("No" in text and not is_anomaly)
    item = {"image_id": int(image_id), "image_path": "/".join(img_path.split("/")[-5:]),
            "is_anomaly": is_anomaly, "output": text, "error": "0" if ok else "1"}
    if score is not None:
        item["anomaly_score"] = str(round(float(score), 4))
    return item


def run(args, cfg: Config, model) -> Dict:
    """``main`` after the model is built: the dataset, the vision expert's
    classes, text features and reference bank (``--k_shot`` and
    ``--round_index`` also set on the model), the batched generate loop (or,
    with ``--engine``, ``run_engine``), the jsonl rows and the ``--bench`` line.  Returns {"save_path", "rows",
    "token_ids" (each batch's, real rows only), "bench" (the line's dict, or
    None), "phases" (each batch's phase times, s)}.

    Phases per batch, as the JAX harness splits them: ``collate`` (the loader
    and padding), ``dispatch`` (``model.generate``), ``wait`` (the first host
    copy of the tokens) and ``hflush`` (detokenise and write).  The port's
    generate returns when the card is all but done (its decode loop reads a
    stop flag every step; ``dispatch`` ends with a synchronize for the last
    step), so ``dispatch`` holds the device time, ``wait`` reads about 0, and
    the pipeline of ``--pipeline-depth`` batches overlaps no device work with
    the host's: it only delays the writes.  A batch's completion, from which
    the ``--bench`` line's throughput is taken, is therefore when its tokens
    were ready (the end of its ``dispatch``), not when its rows were written,
    which for the last ``depth`` batches is all at the end."""
    ds_cfg = cfg.datasets_cfg
    data_root = ds_cfg.get("anomaly_detection", {}).get("build_info", {}).get(
        "storage", "./data/EvalADDataset")
    dataset = build_dataset(args, ds_cfg, data_root)
    # the harness's --k_shot and --round_index are the model's, as the JAX
    # harness sets them in the model's config before building it
    model.k_shot, model.round_index = args.k_shot, args.round_index
    setup_vision_expert(model, dataset, data_root, args.round_index, args.k_shot)
    dataloader = DataLoader(dataset, batch_size=args.bs, num_workers=4)
    save_path = _save_path(args, cfg)
    print(f"Results will be saved to {save_path}")
    if args.engine:
        return run_engine(args, model, dataloader, save_path)

    generate_kwargs = {
        "max_new_tokens": args.max_new_tokens,
        "do_sample": not args.greedy,
        "top_p": 0.01,
        "temperature": 1.0,
    }
    t_loop0 = time.time()
    completions = []  # (wall time when the batch's tokens were ready, real images)
    spec_totals = {"accepted": 0, "drafted": 0, "rounds": 0}
    phases = {"collate": [], "dispatch": [], "wait": [], "hflush": []}
    rows, token_batches = [], []

    def flush(writer, samples, outputs, real_bs, t_ready):
        t_w0 = time.time()
        if "spec_stats" in outputs:
            for k in spec_totals:
                spec_totals[k] += int(outputs["spec_stats"][k])
        token_ids = outputs["token_ids"].cpu().numpy()[:real_bs]
        phases["wait"].append(time.time() - t_w0)
        t_h0 = time.time()
        token_batches.append(token_ids)
        output_text = model.llama_tokenizer.batch_decode(np.clip(token_ids, 1, 40000))
        maps = outputs["ve_anomaly_maps"].float().cpu().numpy()
        for ind, text in enumerate(output_text):
            item = result_row(samples["image_id"][ind], samples["img_path"][ind],
                              samples["is_anomaly"][ind], text,
                              maps[ind].max() if maps.size else None)
            writer.write(json.dumps(item) + "\n")
            rows.append(item)
        phases["hflush"].append(time.time() - t_h0)
        completions.append((t_ready, real_bs))

    depth = max(1, args.pipeline_depth)
    pending = deque()  # (samples, outputs, real_bs, time the tokens were ready)
    with open(save_path, "w") as writer:
        t_c0 = time.time()
        for testid, samples in enumerate(dataloader):
            phases["collate"].append(time.time() - t_c0)
            if testid < args.start:
                t_c0 = time.time()
                continue
            # pad a ragged final batch to the batch size by repeating its last sample
            real_bs = len(samples["image_id"])
            if real_bs < args.bs:
                pad = args.bs - real_bs
                for k, v in list(samples.items()):
                    if isinstance(v, np.ndarray):
                        samples[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                    elif isinstance(v, list):
                        samples[k] = v + [v[-1]] * pad
            t_d0 = time.time()
            outputs = model.generate(samples, **generate_kwargs)
            if model.device.type == "cuda":
                torch.cuda.synchronize(model.device)
            t_ready = time.time()
            phases["dispatch"].append(t_ready - t_d0)
            pending.append((samples, outputs, real_bs, t_ready))
            if len(pending) > depth:
                flush(writer, *pending.popleft())
            t_c0 = time.time()
        while pending:
            flush(writer, *pending.popleft())

    n_batches = len(completions)
    print("Device Memory:", device_mem_mb(model.device))
    print("Mean Time: ", (time.time() - t_loop0) / max(n_batches, 1))
    line = None
    if args.bench and n_batches > 2:
        # steady-state throughput between the completion of the first batch
        # and the last, with the JAX harness's first-batch exclusion
        secs = completions[-1][0] - completions[0][0]
        imgs = sum(n for _, n in completions[1:])
        card = (torch.cuda.get_device_name(model.device) if model.device.type == "cuda"
                else "CPU")
        line = {
            "metric": f"images/sec (AQA eval harness, PyTorch port on {card}, "
                      f"{args.max_new_tokens}-token decode"
                      + (f", spec K={model.spec_k}" if model.spec_k else "") + ")",
            "value": round(imgs / max(secs, 1e-9), 4),
            "unit": "images/sec",
            "batches": n_batches - 1,
            "batch_size": args.bs,
            "compile_batch_s": round(completions[0][0] - t_loop0, 2),
            "phase_means_s": {
                k: round(float(np.mean(v[1:])), 3) if len(v) > 1 else 0.0
                for k, v in phases.items()
            },
        }
        if spec_totals["drafted"]:
            line["spec_acceptance"] = round(spec_totals["accepted"] / spec_totals["drafted"], 4)
            line["spec_rounds"] = spec_totals["rounds"]
        print(json.dumps(line))
    return {"save_path": save_path, "rows": rows, "token_ids": token_batches, "bench": line,
            "phases": phases}


def run_engine(args, model, dataloader, save_path: str) -> Dict:
    """The eval through the continuous-batching engine
    (``serving.MyriadServing``, the JAX harness's ``run_engine_eval``): every
    image is a request over ``--bs`` slots, admitted at widths (64, 160, 320),
    speculative when the model's ``spec_k`` is set; rows are written as
    requests finish, with the fixed-batch loop's schema.  The block KV
    layout (``--engine-block``) is not ported: the engine serves per-row
    frontiers, and its line says block 0.  The ``--bench`` line's value
    counts the requests after the first finisher, over the time from it to
    the last.  Returns {"save_path", "rows", "bench", "stats"}."""
    from myriad_tpu_torch.serving import MyriadServing

    spec_k = model.spec_k
    serving = MyriadServing(model, slots=args.bs, segment=args.engine_segment,
                            max_new_tokens=args.max_new_tokens, admit_widths=(64, 160, 320),
                            spec_k=spec_k, max_admit_chunk=args.engine_admit_chunk)
    meta = {}
    t0 = time.time()
    n_submitted = 0
    for samples in dataloader:
        bs = len(samples["image_id"])
        requests = []
        for i in range(bs):
            req = {"image": np.asarray(samples["image"])[i:i + 1]}
            for k in ("scene", "question", "question2", "question3", "img_path"):
                if k in samples:
                    req[k] = [samples[k][i]]
            requests.append(req)
        for i, rid in enumerate(serving.submit_batch(requests, lazy=True)):
            meta[rid] = (samples["image_id"][i], samples["img_path"][i],
                         samples["is_anomaly"][i])
        n_submitted += bs
    if args.engine_block and not spec_k:
        print(f"engine eval: the block KV layout (--engine-block {args.engine_block}) is not "
              "ported; the engine serves per-row frontiers")
    print(f"engine eval: {n_submitted} requests over {args.bs} slots "
          f"(segment {args.engine_segment}, block 0, spec {spec_k})")

    rows, completions = [], []
    with open(save_path, "w") as writer:
        while serving.pending:
            for r in serving.step():
                item = result_row(*meta.pop(r["request_id"]), r["text"], r.get("anomaly_score"))
                writer.write(json.dumps(item) + "\n")
                rows.append(item)
                completions.append(time.time())

    print("Device Memory:", device_mem_mb(model.device))
    stats = serving.stats
    print("Mean Time: ", (time.time() - t0) / max(stats["ticks"], 1))
    line = None
    if args.bench and len(completions) > args.bs:
        # steady state: from the first finisher (the wave that paid the
        # set-up) to the last, as the JAX harness takes it
        secs = completions[-1] - completions[0]
        card = (torch.cuda.get_device_name(model.device) if model.device.type == "cuda"
                else "CPU")
        line = {
            "metric": f"images/sec (AQA eval harness, serving engine, PyTorch port on {card}, "
                      f"{args.max_new_tokens}-token decode"
                      + (f", spec K={spec_k}" if spec_k else "") + ")",
            "value": round((len(completions) - 1) / max(secs, 1e-9), 4),
            "unit": "images/sec",
            "requests": len(completions),
            "slots": args.bs,
            "ticks": stats["ticks"],
            "decode_steps": stats["decode_steps"],
            "slot_occupancy": round(stats["live_row_steps"]
                                    / max(stats["decode_steps"] * args.bs, 1), 3),
            "compile_to_first_s": round(completions[0] - t0, 2),
        }
        if stats["spec_drafted"]:
            line["spec_acceptance"] = round(stats["spec_accepted"] / stats["spec_drafted"], 4)
        print(json.dumps(line))
    return {"save_path": save_path, "rows": rows, "bench": line, "stats": dict(stats)}


def main(argv=None) -> Dict:
    args = parse_args(argv)
    cfg = Config(args)
    return run(args, cfg, build_model(args, cfg))


if __name__ == "__main__":
    main()
