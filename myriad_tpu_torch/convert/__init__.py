"""Converters of the reference's torch checkpoints into the JAX package's
parameter layout, which the port's weights loaders read."""

from myriad_tpu_torch.convert.qformer import convert_qformer_state_dict

__all__ = ["convert_qformer_state_dict"]
