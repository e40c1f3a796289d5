"""One intra-op thread for torch in a test process and the processes it starts.

The suite runs in several worker processes on a few cores, and each
process's torch would otherwise start one OpenMP thread a core: the tiny
models of the port's tests then spend most of their time with threads of
different processes spinning against each other.  Every ``test_torch_*``
module imports this; the workers import all of them at collection, so the
setting holds in every worker (and, through ``OMP_NUM_THREADS``, in the
subprocesses the tests start).
"""

import os

import torch

torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")
