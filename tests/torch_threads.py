"""Imported by every ``tests/test_torch_*.py``: one intra-op thread for
PyTorch in the test process.

The port's CPU tests run small tensors through many small ops, and the
suite runs in several worker processes at once (``-n 6``). Each process's
default intra-op pool is as wide as the machine, so six pools contend for
the same cores and a tiny op waits on its pool: a tiny-mixtral engine run
took 12 s against 0.2 s with one thread. One thread computes the same
values; only the order of a parallel reduction's partial sums can differ,
inside the tolerances the tests state.
"""

import torch

torch.set_num_threads(1)
