"""Starting the ranks of a multi-device run.

  * `run_ranks(fn, world_size, backend, device, *args)` spawns `world_size`
    processes (the "spawn" start method), joins them into one process group
    at a free port of this host (`socket.bind(("", 0))`, so concurrent runs
    never collide), calls `fn(rank, world_size, device, *args)` in each and
    returns each rank's result, in rank order. A rank that raises fails the
    whole run: the others are stopped and the error is raised here.
  * `init_from_env(backend)` joins the process group that `torchrun` set up
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).

The backend is the caller's explicit choice: "nccl" needs a card per rank,
"gloo" runs on the CPU and also takes CUDA tensors, so ranks that share one
card run over gloo (NCCL refuses two ranks on one card). `default_backend`
picks "nccl" when every rank has a card of its own, else "gloo".
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


def free_port() -> int:
  """A TCP port of this host that no one listens on now."""
  with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
    s.bind(("", 0))
    return s.getsockname()[1]


def default_backend(world_size: int, device: Any = None) -> str:
  """"nccl" when `device` is CUDA and every rank has a card of its own,
  else "gloo"."""
  device = torch.device("cuda" if device is None else device)
  if (device.type == "cuda" and torch.cuda.is_available()
      and torch.cuda.device_count() >= world_size):
    return "nccl"
  return "gloo"


def _rank_device(device: Any, rank: int) -> torch.device:
  device = torch.device(device)
  if device.type == "cuda":
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
  return device


def _child(rank, world_size, backend, device, port, num_threads, fn, args,
           results):
  try:
    if num_threads:
      torch.set_num_threads(num_threads)
    device = _rank_device(device, rank)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world_size)
    try:
      out = fn(rank, world_size, device, *args)
    finally:
      dist.destroy_process_group()
    results.put((rank, True, out))
  except BaseException:  # pylint: disable=broad-except
    results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, backend: str, device: Any,
              *args, num_threads: Optional[int] = None,
              timeout: float = 600.0) -> List[Any]:
  """Runs `fn(rank, world_size, device, *args)` on `world_size` spawned
  ranks; returns their results (picklable: numpy arrays, numbers, dicts) in
  rank order. `device` "cuda" gives rank r cuda:{r % cards}.
  `num_threads` sets each rank's PyTorch threads. Raises RuntimeError with
  the first failing rank's traceback, or on `timeout` seconds."""
  ctx = multiprocessing.get_context("spawn")
  results = ctx.Queue()
  port = free_port()
  procs = [ctx.Process(target=_child, daemon=True, args=(
      r, world_size, backend, str(device), port, num_threads, fn, args,
      results)) for r in range(world_size)]
  for p in procs:
    p.start()
  outs: List[Any] = [None] * world_size
  pending = set(range(world_size))
  deadline = time.monotonic() + timeout
  try:
    while pending:
      try:
        rank, ok, out = results.get(timeout=1.0)
      except queue.Empty:
        # A rank that died without reporting (a crash) fails the run.
        dead = [r for r in pending if procs[r].exitcode not in (None, 0)]
        if dead:
          raise RuntimeError(f"ranks {dead} exited with codes "
                             f"{[procs[r].exitcode for r in dead]}") from None
        if time.monotonic() > deadline:
          raise RuntimeError(f"ranks {sorted(pending)} timed out after "
                             f"{timeout} s") from None
        continue
      if not ok:
        raise RuntimeError(f"rank {rank} failed:\n{out}")
      outs[rank] = out
      pending.discard(rank)
  finally:
    for p in procs:
      p.join(timeout=30)
      if p.is_alive():
        p.kill()
        p.join()
  return outs


def init_from_env(backend: Optional[str] = None, device: Any = None) -> int:
  """Joins `torchrun`'s process group (if it is not joined yet) from RANK,
  WORLD_SIZE and MASTER_ADDR/MASTER_PORT; sets this rank's card from
  LOCAL_RANK when `device` is CUDA. Returns the world size (1 without
  torchrun's variables). A failed join raises."""
  world_size = int(os.environ.get("WORLD_SIZE", "1"))
  if world_size == 1 or dist.is_initialized():
    return dist.get_world_size() if dist.is_initialized() else 1
  if backend is None:
    backend = default_backend(world_size, device)
  if torch.device("cuda" if device is None else device).type == "cuda":
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local % torch.cuda.device_count())
  dist.init_process_group(backend, init_method="env://")
  return world_size
