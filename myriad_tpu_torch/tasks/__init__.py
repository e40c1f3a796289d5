"""Tasks (counterpart of ``myriad_tpu/tasks``): ``setup_task`` picks the run
config's ``task``."""

from myriad_tpu_torch.tasks.base_task import BaseTask
from myriad_tpu_torch.tasks.image_text_pretrain import ImageTextPretrainTask

TASKS = {"image_text_pretrain": ImageTextPretrainTask}


def setup_task(cfg):
    name = cfg.run_cfg.task
    try:
        return TASKS[name].setup_task(cfg=cfg)
    except KeyError:
        raise KeyError(f"Unknown task '{name}'. Registered: [{', '.join(sorted(TASKS))}]") from None


__all__ = ["BaseTask", "ImageTextPretrainTask", "TASKS", "setup_task"]
