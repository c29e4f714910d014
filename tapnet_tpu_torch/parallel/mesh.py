"""The (data, model) grid of ranks over `torch.distributed` (port of
tapnet_tpu/parallel/mesh.py).

The JAX package runs one jit over a device mesh and lets GSPMD insert the
collectives. Here every rank is a process of the default process group, and
the collectives are explicit:

  * axis "data": batch parallelism; the gradients are averaged over every
    rank before the optimizer reads them;
  * axis "model": the query axis of the tracking tensors is split here.

`make_mesh(model_parallel)` lays the ranks out as JAX lays out its devices:
rank r sits at data index r // model_parallel and model index
r % model_parallel. Each row (the ranks of one data index: the "model" axis)
and each column (the "data" axis) is a subgroup, made with `dist.new_group`
on every rank in the same order.

Every sharded computation of the port computes the unsharded one's
function. The collectives that a gradient passes through (`all_gather`) are
autograd functions whose backward sums the cotangents of every rank, so the
sum over ranks of each rank's gradient of its share of the loss is the
gradient of the whole loss. The losses follow one convention: a rank's loss
is its share such that the global loss is the mean over ranks
(`Mesh.size()` times its sum over the global normaliser), so the optimizer
reads the mean of the ranks' gradients.

The collectives used exist in every PyTorch this package supports (2.11 and
later): `dist.all_gather` with a list, `dist.all_reduce`, `dist.broadcast`
and `dist.broadcast_object_list`. gloo takes CUDA tensors for all of them,
which lets ranks that share one card run over it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
QUERY_KEYS = ("query_points", "target_points", "occluded")


class _AllGather(torch.autograd.Function):
  """[P, ...] stack of every rank's `x` in the group, in rank order; the
  backward sums each rank's cotangent of this rank's slice. Unlike
  `torch.distributed.nn.functional.all_gather`, whose backward takes a
  reduce-scatter or an all-to-all, it needs only `all_reduce`, which gloo
  takes for CUDA tensors too."""

  @staticmethod
  def forward(ctx, x, group, size, index):
    ctx.group, ctx.index = group, index
    # A gather moves bytes: 16-bit floats go as bytes, which every backend
    # takes.
    raw = x.contiguous()
    if raw.dtype in (torch.bfloat16, torch.float16):
      raw = raw.view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(size)]
    dist.all_gather(parts, raw, group=group)
    return torch.stack(parts).view(x.dtype)

  @staticmethod
  def backward(ctx, g):
    g = g.contiguous().clone()
    dist.all_reduce(g, group=ctx.group)
    return g[ctx.index], None, None, None


class Mesh:
  """A (data, model) grid over the default process group's ranks."""

  def __init__(self, model_parallel: int = 1):
    if not dist.is_available() or not dist.is_initialized():
      raise RuntimeError(
          "a Mesh needs an initialized torch.distributed process group: "
          "start the ranks with tapnet_tpu_torch.parallel.launch.run_ranks "
          "or under torchrun (launch.init_from_env)")
    n = dist.get_world_size()
    if n % model_parallel != 0:
      raise ValueError(
          f"{n} devices not divisible by model_parallel={model_parallel}")
    self.rank = dist.get_rank()
    self._shape = {DATA_AXIS: n // model_parallel, MODEL_AXIS: model_parallel}
    self._index = {DATA_AXIS: self.rank // model_parallel,
                   MODEL_AXIS: self.rank % model_parallel}
    self._groups: Dict[Optional[str], Any] = {None: dist.group.WORLD}
    # Every rank makes every group, in the same order.
    rows = [list(range(d * model_parallel, (d + 1) * model_parallel))
            for d in range(n // model_parallel)]
    cols = [list(range(m, n, model_parallel)) for m in range(model_parallel)]
    for axis, layout in ((MODEL_AXIS, rows), (DATA_AXIS, cols)):
      for ranks in layout:
        group = dist.new_group(ranks)
        if self.rank in ranks:
          self._groups[axis] = group

  def size(self, axis: Optional[str] = None) -> int:
    """Ranks along `axis`; None: all ranks."""
    if axis is None:
      return self._shape[DATA_AXIS] * self._shape[MODEL_AXIS]
    return self._shape[axis]

  def index(self, axis: Optional[str] = None) -> int:
    """This rank's index along `axis`; None: its rank."""
    return self.rank if axis is None else self._index[axis]

  def group(self, axis: Optional[str] = None):
    return self._groups[axis]

  def device(self, device: Optional[Any] = None) -> torch.device:
    """This rank's device: "cuda" (or None) means cuda:{rank % cards}."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
      if not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available; pass device='cpu' to run on the "
            "CPU.")
      device = torch.device("cuda", self.rank % torch.cuda.device_count())
    return device

  def all_gather(self, x: torch.Tensor,
                 axis: Optional[str] = None) -> torch.Tensor:
    """[P, ...]: `x` of every rank along `axis`, in index order. Carries
    gradients (the backward sums the ranks' cotangents)."""
    size = self.size(axis)
    if size == 1:
      return x[None]
    return _AllGather.apply(x, self.group(axis), size, self.index(axis))

  def all_sum(self, x: torch.Tensor,
              axis: Optional[str] = None) -> torch.Tensor:
    """The sum of `x` over the ranks along `axis`, as a new tensor without
    gradient."""
    x = x.detach().clone()
    if self.size(axis) > 1:
      dist.all_reduce(x, group=self.group(axis))
    return x

  def all_mean(self, x: torch.Tensor,
               axis: Optional[str] = None) -> torch.Tensor:
    return self.all_sum(x, axis) / self.size(axis)

  def mean_(self, tensors: Sequence[torch.Tensor]) -> None:
    """Replaces every tensor by its mean over all ranks, in place; one
    all_reduce per dtype."""
    def op(buf):
      dist.all_reduce(buf)
      buf.div_(self.size())

    self._flat_(tensors, op)

  def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrites every tensor with rank `src`'s, in place; one broadcast per
    dtype."""
    self._flat_(tensors, lambda buf: dist.broadcast(buf, src))

  def broadcast_object(self, obj: Any, src: int = 0) -> Any:
    """Rank `src`'s picklable `obj` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]

  def _flat_(self, tensors, op) -> None:
    if self.size() == 1:
      return
    groups: Dict[Any, List[torch.Tensor]] = {}
    for t in tensors:
      groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
      with torch.no_grad():
        buf = torch.cat([t.reshape(-1) for t in group])
        op(buf)
        offset = 0
        for t in group:
          t.copy_(buf[offset:offset + t.numel()].view_as(t))
          offset += t.numel()


def make_mesh(model_parallel: int = 1) -> Mesh:
  """A ("data", "model") mesh over every rank of the process group."""
  return Mesh(model_parallel)


def shard(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = DATA_AXIS,
          dim: int = 0) -> torch.Tensor:
  """This rank's equal part of `x` along `dim`, split over `axis` (None:
  every rank)."""
  p = mesh.size(axis)
  n = x.shape[dim]
  if n % p:
    raise ValueError(
        f"dim {dim} of length {n} not divisible by mesh axis {axis!r} ({p})")
  return x.narrow(dim, mesh.index(axis) * (n // p), n // p)


def gather(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = DATA_AXIS,
           dim: int = 0) -> torch.Tensor:
  """The inverse of `shard`: every rank's part concatenated along `dim`.
  Carries gradients."""
  parts = mesh.all_gather(x, axis)
  return torch.cat(list(parts.unbind(0)), dim=dim)


def inference_shardings(mesh: Mesh):
  """Where offline inference splits its tensors, as (axis, dim) pairs for
    (video [B, T, ...], queries [B, N, 3], outputs [B, N, ...]): frames over
    "data" for the backbone, queries over "data" for the refinement, and the
    outputs query-split until they are gathered. The "model" axis, if any,
    repeats the work."""
  del mesh
  return (DATA_AXIS, 1), (DATA_AXIS, 1), (DATA_AXIS, 1)


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
  """This rank's part of a global host batch: the batch axis over "data",
  and the query axis of `query_points`, `target_points` and `occluded` over
  "model"; a nested sub-batch (BootsTAP's "labeled") by leaf name."""
  out = {}
  for key, value in batch.items():
    if isinstance(value, Mapping):
      out[key] = shard_batch(value, mesh)
      continue
    value = shard(value, mesh, DATA_AXIS, 0)
    if key in QUERY_KEYS:
      value = shard(value, mesh, MODEL_AXIS, 1)
    out[key] = value.contiguous()
  return out
