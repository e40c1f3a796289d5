"""Tensor parallelism over ranks: the (data, model) mesh and the sharding
rules (counterpart of ``myriad_tpu/parallel``)."""
