"""The image-text pretrain task (counterpart of
``myriad_tpu/tasks/image_text_pretrain.py``): ``BaseTask``'s training; its
evaluation returns None, so a validation split yields no metrics and no
best checkpoint."""

from myriad_tpu_torch.tasks.base_task import BaseTask


class ImageTextPretrainTask(BaseTask):
    def evaluation(self, model, data_loader):
        return None
