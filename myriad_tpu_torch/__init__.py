"""myriad_tpu_torch: the PyTorch/CUDA port of ``myriad_tpu`` for one NVIDIA H100.

The package mirrors ``myriad_tpu``'s layout and names.  It imports ``torch``
and numpy and never JAX.  Plain tensor code is PyTorch; every TPU kernel on
the ported path is a CUDA kernel written for Hopper (``csrc/``), built with
``nvcc`` at first use.  Each kernel wrapper takes its plain PyTorch version
for CPU tensors only: a CUDA tensor launches the kernel or raises.
"""
