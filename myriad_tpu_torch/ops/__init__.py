"""Numerics and kernel wrappers (counterpart of ``myriad_tpu/ops``)."""
