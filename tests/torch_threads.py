"""PyTorch's CPU threads for the port's tests, imported first by every
tests/test_torch_*.py: two a process (`torch.set_num_threads`), and
OMP_NUM_THREADS=2 for the processes the tests start (gloo ranks, CLI
subprocesses) unless the environment sets it.

The suite runs in several pytest workers at once (pytest-xdist), and
PyTorch's default of one OpenMP thread a core in every worker left six
workers' spinning thread pools fighting over the host's cores: the port's
six slowest files took 1486 s of pytest time together with the default and
227 s with two threads a process (same six files, six workers, 8 CPUs).
The tests' tensors are small, so a thread or two a process loses little
when a file runs alone."""

import os

import torch

THREADS = 2

os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
torch.set_num_threads(THREADS)
