"""Orbax checkpoint directories without orbax, tensorstore or a zstd module:
``zstd`` (the port's own frame decoder, host C++), ``ocdbt`` (a read-only
OCDBT reader), ``zarr`` (zarr v2 arrays) and ``checkpointer`` (``restore``
and ``save`` of a directory)."""
