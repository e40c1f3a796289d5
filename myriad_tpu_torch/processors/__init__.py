"""Host-side image transforms (counterpart of ``myriad_tpu/processors``)."""
