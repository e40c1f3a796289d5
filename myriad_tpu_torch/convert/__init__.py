"""Converters of the reference's torch checkpoints into the JAX package's
parameter layout, which the port's weights loaders read (numpy copies of
``myriad_tpu/convert/``, under the same names): dense kernels (in, out),
conv kernels OIHW -> HWIO, every leaf float32."""

from myriad_tpu_torch.convert.eva import convert_eva_vit_state_dict
from myriad_tpu_torch.convert.imagebind import (convert_anomaly_decoder_state_dict,
                                                convert_imagebind_state_dict)
from myriad_tpu_torch.convert.llama import convert_llama_state_dict
from myriad_tpu_torch.convert.networks import convert_myriad_trainables_state_dict
from myriad_tpu_torch.convert.qformer import convert_qformer_state_dict
from myriad_tpu_torch.convert.simplenet import (convert_simplenet_head_state_dict,
                                                convert_wide_resnet50_state_dict)

__all__ = [
    "convert_llama_state_dict",
    "convert_eva_vit_state_dict",
    "convert_qformer_state_dict",
    "convert_imagebind_state_dict",
    "convert_anomaly_decoder_state_dict",
    "convert_simplenet_head_state_dict",
    "convert_wide_resnet50_state_dict",
    "convert_myriad_trainables_state_dict",
]
