"""Config plumbing (counterpart of ``myriad_tpu/common``)."""
