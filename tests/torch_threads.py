"""Caps torch's CPU threads in a process that runs the port's tests;
every ``tests/test_torch_*.py`` imports it.

The suite runs in several worker processes at once (``pytest -n 6`` on an
8-core host). At torch's default of one thread per core, each worker's
operations spread over every core while the other workers' do too, and
the threads' spin-waiting then costs more than they give: with 6
workers, the port's test files took 317.8 s at the default and 126.4 s
with 2 threads per worker (CHANGES.md, PR 8). Only the order of float32
reductions inside an operation depends on the count.
"""

import torch

THREADS = 2

torch.set_num_threads(THREADS)
