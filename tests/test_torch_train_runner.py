"""``python -m myriad_tpu_torch.train`` on the CPU at tiny size: the runner's
loop, checkpoint ring and resume, the train -> serve loop through ``ckpt:``,
and the entry point's device rule.  No JAX model is compiled here
(tests/test_torch_train.py holds the step itself against the JAX package)."""

import os
import re
import textwrap

import numpy as np
import pytest
import torch

from fixtures import make_ad_dataset
from myriad_tpu_torch import train
from myriad_tpu_torch.datasets import builders
from myriad_tpu_torch.models.myriad import Myriad
import torch_threads  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Shrink:
    """The dataset's 224 images (NSA needs room for its patches) cut to the
    tiny arch's 28, as tests/test_training.py does for the JAX runner."""

    DatasetName = "AnomalyDetection"

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        s = self.ds[i]
        for k in ("image", "aug_image"):
            s[k] = s[k][::8, ::8]
        return s

    def collater(self, samples):
        return self.ds.collater(samples)


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("ad_train")
    make_ad_dataset(str(root), classes=("bottle", "screw"), n_train=4, img_size=64)
    path = root / "train.yaml"
    path.write_text(textwrap.dedent(f"""
        model:
          arch: myriad
          model_type: pretrain_vicuna
          arch_preset: tiny
          image_size: 28
          use_lora: True
          max_txt_len: 16
          end_sym: "###"
          param_policy: fp32
          llm_vocab_size: 300
          prompt_path: "{os.path.join(REPO, 'prompts', 'alignment.txt')}"
          prompt_template: '###Human: {{}} ###Assistant: '
        datasets:
          anomaly_detection:
            seed: 3
            build_info:
              storage: {root}
              ann_paths:
                - DC_MVTEC_train_normal.jsonl
            vis_processor:
              train:
                name: "loc_image_train"
                identity: True
                image_size: 224
            text_processor:
              train:
                name: "blip_caption"
        run:
          task: image_text_pretrain
          lr_sched: "linear_warmup_cosine_lr"
          init_lr: 1e-3
          min_lr: 0
          warmup_lr: 1e-6
          weight_decay: 0.05
          max_epoch: 2
          iters_per_epoch: 2
          batch_size_train: 4
          num_workers: 0
          seed: 42
          output_dir: {root / "out"}
          max_checkpoints: 1
          device: cpu
    """))
    return str(path)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models' ops on one thread: under the suite's parallel workers
    torch's default of a thread a core oversubscribes the host, and the
    spinning threads slow these tests several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def shrink(monkeypatch):
    build = builders.AnomalyDetectionBuilder.build_datasets
    monkeypatch.setattr(builders.AnomalyDetectionBuilder, "build_datasets",
                        lambda self: {"train": _Shrink(build(self)["train"])})


def _trainables(model):
    return {n: p.detach().clone() for n, p in model.trainable_state_dict().items()}


def test_train_main_trains_saves_and_resumes(cfg_path, tmp_path):
    """2 epochs x 2 iterations: finite losses, every trainable moved, the
    frozen parameters untouched and without gradients, one checkpoint kept
    (the ring of 1) holding the trainables; a resume from it restores them bit
    for bit and continues the global step in a third epoch."""
    runner = train.build(["--cfg-path", cfg_path, "--options", f"run.output_dir={tmp_path}"])
    model = runner.model
    before = _trainables(model)
    frozen = {n: p.detach().clone() for n, p in model.module.named_parameters()
              if n not in before}
    runner.train()
    assert runner.global_step == 4 and len(runner.losses) == 4
    assert all(np.isfinite(runner.losses))
    after = _trainables(model)
    assert all(not torch.equal(after[n], before[n]) for n in before)
    for n, p in model.module.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]) and p.grad is None, n
    files = sorted(os.listdir(runner.output_dir))
    assert files == ["checkpoint_1.pth", "log.txt"]
    ckpt = os.path.join(runner.output_dir, "checkpoint_1.pth")
    state = torch.load(ckpt, weights_only=True)
    assert set(state["model"]) == set(model.trainable_names)
    assert (state["epoch"], state["global_step"]) == (1, 4)

    resumed = train.build(["--cfg-path", cfg_path, "--options",
                           f"run.output_dir={tmp_path / 'resumed'}",
                           f"run.resume_ckpt_path={ckpt}", "run.max_epoch=3"])
    for n, t in _trainables(resumed.model).items():
        assert torch.equal(t, after[n]), n
    assert (resumed.start_epoch, resumed.global_step) == (2, 4)
    assert resumed.optimizer.count == 4
    resumed.train()
    assert resumed.global_step == 6 and len(resumed.losses) == 2
    assert all(np.isfinite(resumed.losses))


def test_ckpt_serves_the_trained_trainables(cfg_path, tmp_path):
    """The train -> serve loop: one step, its checkpoint, then
    ``from_config(ckpt=...)`` (seeded random weights, the checkpoint merged
    over them) holds the trained trainables bit for bit."""
    runner = train.main(["--cfg-path", cfg_path, "--options", f"run.output_dir={tmp_path}",
                         "run.max_epoch=1", "run.iters_per_epoch=1"])
    ckpt = os.path.join(runner.output_dir, "checkpoint_0.pth")
    cfg = dict(runner.config.model_cfg, ckpt=ckpt)
    served = Myriad.from_config(cfg, device="cpu")
    served.init_random(cfg.get("seed", 0))
    trained = _trainables(runner.model)
    assert served.trainable_names == runner.model.trainable_names
    for n, t in served.trainable_state_dict().items():
        assert torch.equal(t.detach(), trained[n]), n
    assert not any(p.requires_grad for p in served.module.parameters())


def test_ckpt_that_the_port_did_not_write_raises(tmp_path):
    npz = tmp_path / "trainables.npz"
    np.savez(npz, x=np.zeros(2))
    ref_pth = tmp_path / "checkpoint_4.pth"
    torch.save({"model": {"llama_proj.weight": torch.zeros(2)}, "epoch": 4}, ref_pth)
    orbax_dir = tmp_path / "checkpoint_3"
    orbax_dir.mkdir()
    for value in (str(npz), str(ref_pth), str(orbax_dir)):
        with pytest.raises(NotImplementedError, match=re.escape(f"ckpt={value!r}")):
            Myriad.from_config({"arch_preset": "tiny", "ckpt": value}, device="cpu")


@pytest.mark.parametrize("device,error", [(None, RuntimeError), ("cuda", RuntimeError),
                                          ("tpu", RuntimeError), ("xla", ValueError)])
def test_train_runs_on_the_card_unless_asked_for_the_cpu(cfg_path, device, error):
    """Without ``run.device: cpu`` the entry point goes to the card (``tpu``,
    the JAX package's accelerator, read as cuda) and raises where torch sees
    none; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would train on it")
    option = "run.device=" + ("" if device is None else device)
    with pytest.raises(error, match="cuda" if error is RuntimeError else "xla"):
        train.build(["--cfg-path", cfg_path, "--options", option])


def test_world_size_above_one_and_int4_training_raise(cfg_path, tmp_path):
    with pytest.raises(NotImplementedError, match="world_size=2"):
        train.build(["--cfg-path", cfg_path, "--options", "run.world_size=2"])
    runner = train.build(["--cfg-path", cfg_path, "--options", f"run.output_dir={tmp_path}",
                          "model.llm_weight_dtype=int4"])
    samples = next(runner.train_loader)
    with pytest.raises(NotImplementedError, match="llm_weight_dtype=int4"):
        runner.train_iteration(samples, np.random.default_rng(0))
    runner.train_loader.close()
