"""Model modules (counterpart of ``myriad_tpu/models``).

Unlike the JAX package's ``models/__init__``, importing this package
imports no model: each module is imported where it is used.
"""
