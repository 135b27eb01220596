"""Caps PyTorch's intra-op threads in the port's test processes.

Every ``tests/test_torch_*.py`` imports this module first (and so do
``torch_parity.py`` and ``torch_library_parity.py``). A test process left
at torch's default pool takes every core of the machine for each CPU
kernel, and several test workers beside one another then thrash: the
chained sharded job took 4.6 s alone and 765 s beside six copies of
itself, against 9.9-11.9 s with one thread a process. ``worker_env``
gives a worker subprocess that a port test spawns the same cap.
"""

import os

import torch

THREADS = 1
_CAP = {"OMP_NUM_THREADS": str(THREADS), "MKL_NUM_THREADS": str(THREADS)}

torch.set_num_threads(THREADS)


def worker_env(env=None) -> dict:
    """A copy of ``env`` (the current environment by default) whose
    processes run torch and OpenMP with ``THREADS`` threads."""
    out = dict(os.environ if env is None else env)
    out.update(_CAP)
    return out
