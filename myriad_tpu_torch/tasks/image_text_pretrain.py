"""The image-text pretrain task (counterpart of
``myriad_tpu/tasks/image_text_pretrain.py``): ``BaseTask``'s training, no
evaluation."""

from myriad_tpu_torch.tasks.base_task import BaseTask


class ImageTextPretrainTask(BaseTask):
    pass
