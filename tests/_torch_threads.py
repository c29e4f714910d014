"""Shares the CPU's cores among pytest-xdist workers for PyTorch.

PyTorch starts one intra-op thread per core in every process, so under
`pytest -n N` there are N times as many busy threads as cores, and a small
op waits on threads that the other workers hold: the streaming mixer's
(32, 3, 2048) depthwise products take hundreds of times longer than on one
thread. Each worker takes its share of the cores instead (one thread at
-n 6 on 8 cores); a run without xdist keeps PyTorch's default.
"""

import os

import torch


def share_cores():
  workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
  if workers > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
