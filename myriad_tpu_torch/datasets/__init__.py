"""Image files, datasets and loading (counterpart of ``myriad_tpu/datasets``).

Unlike the JAX package's ``datasets/__init__``, importing this package
imports no dataset: each module is imported where it is used.
"""
