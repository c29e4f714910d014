"""RoboTAP motion clustering: factorize tracks into rigid-motion groups
(port of tapnet_tpu/robotap/clustering.py).

Each cluster k gets a per-frame 3x4 camera/object transform
(Gram-Schmidt-orthonormalized, 4-DoF by default: depth + 2D translation +
in-plane rotation) and each point a 3D location; points are assigned to the
cluster whose rigid motion best reprojects their 2D track. The cluster count
is searched by recursive split-and-delete: three parameter copies (base /
fork1 / fork2) are optimized jointly, each candidate split (replace cluster
i by its two forks) or deletion is scored, and the best is applied with
parameter surgery.

As in the JAX version, the parameters are an explicit tuple of tensors, so
the surgery is plain tensor work. Its random draws are the port's own (the
JAX package's PRNG streams cannot be reproduced), so every function that
draws takes its draws as arguments (`loss_fn` the sample permutations and
the out-of-bounds noise, `_surgery_split` its noise), and
`compute_clusters` takes them from a draws object (`GeneratorDraws`: torch
Generators). The candidate
losses of a step are scored together: each candidate's error columns are
gathered from the base and fork errors (`_candidate_columns`, built with
`_splice` and `_drop`), and one batched `assignment_loss` scores them all.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


class ClusterParams(NamedTuple):
  """Learnable state. cat_pred_*: [P_feat, K] coefficient banks mapping point
  features to per-cluster 3D points; mat_pred_*: [F_feat, K*12] mapping frame
  features to per-cluster transforms."""

  point_state: Tensor  # [N, 64]
  centroids: Tensor  # [T*3, 384]
  point_w1: Tensor  # [384, 64]
  point_mlp: Tuple  # residual MLP weights
  frame_state: Tensor  # [T, 64]
  frame_conv: Tensor  # [128, 64] grouped temporal smoothing kernel
  frame_mlp: Tuple
  cat_pred_base: Tensor
  cat_pred_fork1: Tensor
  cat_pred_fork2: Tensor
  mat_pred_base: Tensor
  mat_pred_fork1: Tensor
  mat_pred_fork2: Tensor


def param_leaves(params: ClusterParams) -> List[Any]:
  """The leaves in the JAX tree's order (fields in order, MLPs expanded)."""
  leaves = []
  for v in params:
    leaves.extend(v if isinstance(v, tuple) else [v])
  return leaves


def params_from_leaves(leaves: Sequence[Any]) -> ClusterParams:
  leaves = list(leaves)
  out = []
  for name in ClusterParams._fields:
    if name in ("point_mlp", "frame_mlp"):
      out.append(tuple(leaves[:5]))
      del leaves[:5]
    else:
      out.append(leaves.pop(0))
  return ClusterParams(*out)


def params_to_numpy(params: ClusterParams) -> ClusterParams:
  """The parameters as float32 numpy arrays (the JAX tree's leaves)."""
  return params_from_leaves(
      [np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v,
                  np.float32) for v in param_leaves(params)])


def params_from_numpy(params, device=None,
                      dtype=torch.float32) -> ClusterParams:
  """ClusterParams of `dtype` tensors on `device` from any tree of arrays
  with the same fields (a JAX ClusterParams, or `params_to_numpy`'s)."""
  return params_from_leaves(
      [torch.tensor(np.asarray(v), device=device, dtype=dtype)
       for v in param_leaves(ClusterParams(*params))])


class _ClipGradIdentity(torch.autograd.Function):
  """Identity whose incoming gradient is clipped to [-100, 100]."""

  @staticmethod
  def forward(ctx, x):  # pylint: disable=arguments-differ
    return x.view_as(x)

  @staticmethod
  def backward(ctx, g):  # pylint: disable=arguments-differ
    return torch.clamp(g, -100, 100)


@functools.lru_cache(maxsize=None)
def _basis(device: torch.device) -> Tuple[Tensor, Tensor]:
  """([1, 1, 0], [0, 0, 1]) on `device`, made once (a tensor built from a
  list is a blocking host-to-device copy on every call)."""
  return (torch.tensor([1.0, 1.0, 0.0], device=device),
          torch.tensor([0.0, 0.0, 1.0], device=device))


def _rsqrt_norm(v: Tensor) -> Tensor:
  return torch.rsqrt(torch.clamp(torch.sum(torch.square(v), -1, keepdim=True),
                                 min=1e-12))


def make_projection_matrix(pred_mat: Tensor, fourdof: bool = True) -> Tensor:
  """[K_or_T, K*12] raw params -> [*, K, 3, 4] orthonormalized transforms."""
  pred_mat = pred_mat.reshape(tuple(pred_mat.shape[:-1]) + (-1, 3, 4))
  pred_mat = _ClipGradIdentity.apply(pred_mat)
  mask, z = _basis(pred_mat.device)
  if fourdof:
    orth1 = torch.ones_like(pred_mat[..., 0:1, :-1]) * z
    orth2 = pred_mat[..., 1:2, :-1] * mask
  else:
    orth1 = pred_mat[..., 0:1, :-1]
    orth1 = orth1 * _rsqrt_norm(orth1)
    orth2 = pred_mat[..., 1:2, :-1]
    orth2 = orth2 - orth1 * torch.sum(orth2 * orth1, -1, keepdim=True)
  orth2 = orth2 * _rsqrt_norm(orth2)
  orth3 = pred_mat[..., 2:3, :-1]
  if fourdof:
    orth3 = orth3 * mask
  else:
    orth3 = orth3 - orth1 * torch.sum(orth3 * orth1, -1, keepdim=True)
  orth3 = orth3 - orth2 * torch.sum(orth3 * orth2, -1, keepdim=True)
  orth3 = orth3 * _rsqrt_norm(orth3)
  cross = torch.linalg.cross(orth1, orth2, dim=-1)
  orth3 = orth3 * torch.sign(torch.sum(cross * orth3, -1, keepdim=True))
  orth = torch.cat([orth3, orth2, orth1], dim=-2)
  return torch.cat([orth, pred_mat[..., -1:]], dim=-1)


def project(pred_mat: Tensor, pos_pred: Tensor, cam_focal_length: float,
            noise: Tensor):
  """Project per-cluster 3D points through per-frame transforms; depth is
  clamped to [0.5, 2] with `noise` (standard normal, [N, F, K, 1]) injected
  out of range to push the optimizer back in bounds."""
  pos_h = torch.cat([pos_pred[..., :3], torch.ones_like(pos_pred[..., :1])],
                    dim=-1)
  pred_pos = torch.einsum("fkoi,nki->nfko", pred_mat, pos_h)
  z = pred_pos[..., 2:3]
  depth = torch.clamp(z + 1.0, 0.5, 2.0)
  oob = torch.relu(z - 2.0) + torch.relu(0.5 - z)
  pred_xy = pred_pos[..., 0:2] * cam_focal_length / depth
  pred_xy = pred_xy + 0.1 * noise * oob
  return pred_xy, depth[..., 0]


def _standardize(x: Tensor, axis: int = 0, eps: float = 1e-5) -> Tensor:
  mean = torch.mean(x, dim=axis, keepdim=True)
  var = torch.var(x, dim=axis, keepdim=True, unbiased=False)
  return (x - mean) * torch.rsqrt(var + eps)


def _truncated_normal(generator: torch.Generator, shape) -> Tensor:
  out = torch.empty(shape)
  torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
  return out


def _mlp_init(generator, sizes):
  return tuple(_truncated_normal(generator, (a, b)) / np.sqrt(a)
               for a, b in sizes)


def init_params(
    generator: torch.Generator,
    pts: Tensor,  # [N, T, 2] normalized
    vis: Tensor,  # [N, T]
    num_cats: int = 1,
) -> ClusterParams:
  """Initializes the optimization state (centroid features from random
  track exemplars, as in the reference's centroid_init), drawn from a CPU
  `generator` with the JAX version's distributions, on pts' device."""
  n, t = pts.shape[:2]
  flat_pts = (pts * vis[..., None]).reshape(n, -1)

  idx = torch.randint(0, n, (384,), generator=generator).to(pts.device)
  centroids = torch.cat([flat_pts[idx], vis[idx] * 100.0], dim=1).T
  point_feat = 3 * 64
  tn = lambda *shape: _truncated_normal(generator, shape)
  cat_base = tn(point_feat * n, num_cats)
  params = ClusterParams(
      point_state=torch.zeros((n, 64)),
      centroids=centroids,
      point_w1=tn(384, 64) / np.sqrt(384),
      point_mlp=_mlp_init(
          generator, [(64, 64), (64, 32), (32, 64), (64, 32), (32, 64)]),
      frame_state=tn(t, 64),
      frame_conv=tn(128, 64) / np.sqrt(128),
      frame_mlp=_mlp_init(
          generator, [(64, 128), (128, 64), (64, 128), (128, 64), (64, 128)]),
      cat_pred_base=cat_base,
      # Forks start as near-copies of the base (reference:
      # tapir_clustering.py:191-200) so split candidates begin plausible.
      cat_pred_fork1=cat_base + tn(point_feat * n, num_cats) * 1e-4,
      cat_pred_fork2=cat_base + tn(point_feat * n, num_cats) * 1e-4,
      mat_pred_base=tn(128, num_cats * 12),
      mat_pred_fork1=tn(128, num_cats * 12),
      mat_pred_fork2=tn(128, num_cats * 12),
  )
  return params_from_leaves([v.to(device=pts.device, dtype=torch.float32)
                             for v in param_leaves(params)])


def _point_features(params: ClusterParams, pts: Tensor, vis: Tensor) -> Tensor:
  """Per-point embedding from soft distances to track centroids."""
  n, t = pts.shape[:2]
  flat = (pts * vis[..., None]).reshape(n, -1)
  time_weight = torch.abs(params.centroids[t * 2:, :]) / 100.0
  centroids = params.centroids[: t * 2, :]
  vis_tile = torch.repeat_interleave(vis, 2, dim=-1).reshape(n, -1)
  tw_tile = torch.repeat_interleave(time_weight, 2, dim=0)

  dists = torch.square(flat * vis_tile) @ torch.square(tw_tile)
  dists = dists - 2 * (flat * vis_tile) @ (centroids * tw_tile)
  dists = dists + torch.square(vis_tile) @ torch.square(centroids * tw_tile)
  dists = torch.exp(-dists * 10.0)
  dists = dists / torch.clamp(dists.sum(-1, keepdim=True), min=1e-8)

  state = params.point_state + dists @ params.point_w1
  state = _standardize(state)
  w = params.point_mlp
  state = torch.relu(state @ w[0])
  state = state + torch.relu(_standardize(state @ w[1])) @ w[2]
  state = state + torch.relu(_standardize(state @ w[3])) @ w[4]
  return state  # [N, 64]


def _frame_features(params: ClusterParams,
                    sequence_boundaries: Sequence[Tuple[int, int]]) -> Tensor:
  """Per-frame embedding, temporally smoothed within each sequence."""
  kernel = params.frame_conv  # [128, 64]
  k = kernel.shape[0]
  # A grouped (per-channel) temporal conv, SAME padding as XLA pads it.
  weight = kernel.T[:, None, :]  # [64, 1, 128]
  chunks = []
  for lo, hi in sequence_boundaries:
    seg = params.frame_state[lo:hi].T[None]  # [1, 64, t]
    seg = torch.nn.functional.pad(seg, ((k - 1) // 2, k // 2))
    chunks.append(torch.nn.functional.conv1d(
        seg, weight, groups=weight.shape[0])[0].T)
  state = torch.cat(chunks, dim=0)
  state = _standardize(state)
  w = params.frame_mlp
  state = torch.relu(state @ w[0])
  state = state + _standardize(torch.relu(state @ w[1])) @ w[2]
  state = state + _standardize(torch.relu(state @ w[3])) @ w[4]
  return state * 0.01  # [T, 128]


def _predict_joint(params, pts, vis, sequence_boundaries, fourdof,
                   variants: int = 3):
  """The first `variants` of (base, fork1, fork2) side by side: pos_pred
  [N, variants * K, 3] and pred_mat [T, variants * K, 3, 4], the base's K
  clusters first. Each cluster's column is computed on its own, so side by
  side is a third of the launches of one variant at a time."""
  point_state = _point_features(params, pts, vis)  # [N, 64]
  frame_state = _frame_features(params, sequence_boundaries)  # [T, 128]
  n = pts.shape[0]
  banks = [(params.cat_pred_base, params.mat_pred_base),
           (params.cat_pred_fork1, params.mat_pred_fork1),
           (params.cat_pred_fork2, params.mat_pred_fork2)][:variants]
  cat = torch.cat([c for c, _ in banks], dim=-1).reshape(n, 64, 3, -1)
  pos = torch.einsum("niok,ni->nko", cat, point_state) * 0.01
  mats = make_projection_matrix(
      frame_state @ torch.cat([m for _, m in banks], dim=-1), fourdof)
  return pos, mats


def _predict(params, pts, vis, sequence_boundaries, fourdof):
  """Returns per-variant (pos_pred [N, K, 3], pred_mat [T, K, 3, 4])."""
  pos, mats = _predict_joint(params, pts, vis, sequence_boundaries, fourdof)
  k = params.cat_pred_base.shape[-1]
  return tuple((pos[:, i * k:(i + 1) * k], mats[:, i * k:(i + 1) * k])
               for i in range(3))


def get_err(pts: Tensor, vis: Tensor, pred_xy: Tensor) -> Tensor:
  """Summed-over-frames squared reprojection error, [N, K]."""
  diff = pts[:, :, None, :] - pred_xy
  return torch.sum(torch.sum(torch.square(diff), -1) * vis[:, :, None], dim=1)


def assignment_loss(err_summed: Tensor, sum_vis: Tensor, use_em: bool,
                    em_variance: float = 1e-4) -> Tensor:
  """Min-over-clusters (hard) or EM soft-assignment negative log-likelihood
  of errors [..., N, K] (a loss per leading index)."""
  if not use_em:
    return torch.sum(torch.amin(err_summed, dim=-1), dim=-1) / sum_vis
  err_n = err_summed - torch.amin(err_summed, dim=-1, keepdim=True)
  err_exp = torch.exp(-err_n / em_variance)
  k = err_exp.shape[-1]
  wts = torch.full(err_exp.shape[:-2] + (1, k), 1.0 / k,
                   device=err_exp.device)
  for _ in range(3):
    w = err_exp * wts / torch.sum(err_exp * wts, dim=-1, keepdim=True)
    wts = torch.clamp(w.sum(-2, keepdim=True), min=1e-8)
    wts = wts / wts.sum(-1, keepdim=True)
  # logsumexp with weights b = wts, its shift held out of the gradient.
  a = -err_summed / em_variance
  amax = torch.amax(a, dim=-1, keepdim=True).detach()
  ll = torch.log(torch.sum(wts * torch.exp(a - amax), dim=-1)) + amax[..., 0]
  return -torch.sum(ll, dim=-1) / sum_vis * em_variance


def _splice(base, fork1, fork2, i, chunk=1):
  """Candidate split: cluster i replaced by its fork1/fork2 copies."""
  return torch.cat(
      [
          base[..., : i * chunk],
          fork1[..., i * chunk : (i + 1) * chunk],
          fork2[..., i * chunk : (i + 1) * chunk],
          base[..., (i + 1) * chunk :],
      ],
      dim=-1,
  )


def _drop(base, i, chunk=1):
  return torch.cat([base[..., : i * chunk], base[..., (i + 1) * chunk :]],
                   dim=-1)


@functools.lru_cache(maxsize=None)
def _candidate_columns(num_cats: int, delete_mode: bool, device=None) -> Tensor:
  """[num_cats, C] columns of each candidate: of the base errors (delete
  mode: cluster i dropped), or of [base, fork1, fork2] errors side by side
  (split mode: cluster i replaced by its forks)."""
  cols = torch.arange(num_cats, device=device)
  if delete_mode:
    return torch.stack([_drop(cols, i) for i in range(num_cats)])
  return torch.stack([_splice(cols, cols + num_cats, cols + 2 * num_cats, i)
                      for i in range(num_cats)])


def _top_k_smallest(losses: Tensor, k: int) -> Tensor:
  """The k smallest losses, lowest index first among ties (lax.top_k of
  the negated losses)."""
  return losses[torch.argsort(losses, stable=True)[:k]]


def loss_fn(
    params: ClusterParams,
    pts: Tensor,
    vis: Tensor,
    pts_idx: Tensor,
    fr_idx: Tensor,
    noise: Tensor,
    num_cats: int,
    delete_mode: bool,
    sequence_boundaries,
    final_num_cats: int,
    use_em: bool,
    fourdof: bool,
    cam_focal_length: float,
):
  """Split/delete search loss (reference: tapir_clustering.py:257-334), on
  the sampled points `pts_idx` and frames `fr_idx` (the first point_sample
  and frame_sample entries of random permutations), with the out-of-bounds
  `noise` [len(pts_idx), len(fr_idx), num_cats, 1] (standard normal, one
  draw for every variant). Returns (loss, the candidates' losses)."""
  variants = 1 if delete_mode else 3
  pos, mats = _predict_joint(params, pts, vis, sequence_boundaries, fourdof,
                             variants)
  pts_s = pts[pts_idx][:, fr_idx]
  vis_s = vis[pts_idx][:, fr_idx]
  sum_vis = torch.sum(vis_s)
  # Every variant projects with the same noise, as JAX's one key gives it.
  pred, _ = project(mats[fr_idx], pos[pts_idx], cam_focal_length,
                    noise.repeat(1, 1, variants, 1))
  err = get_err(pts_s, vis_s, pred)  # [N_s, variants * num_cats]
  cols = _candidate_columns(num_cats, delete_mode, pts.device)
  candidates = err[:, cols]  # [N_s, num_cats, C]
  losses = assignment_loss(candidates.transpose(0, 1), sum_vis, use_em=use_em)
  if delete_mode:
    k = min(num_cats, num_cats - final_num_cats + 3)
    return torch.mean(_top_k_smallest(losses, k)), losses
  return torch.amin(losses), losses


def surgery_noise(generator: torch.Generator,
                  params: ClusterParams) -> Tuple[Tensor, ...]:
  """_surgery_split's draws, on the generator's device: standard normals of
  the grown cat and mat banks' shapes, for fork1 and fork2 of each."""
  cat_shape = (params.cat_pred_base.shape[0], params.cat_pred_base.shape[1] + 1)
  mat_shape = (params.mat_pred_base.shape[0],
               params.mat_pred_base.shape[1] + 12)
  draw = lambda shape: torch.randn(shape, generator=generator,
                                   device=generator.device)
  return (draw(cat_shape), draw(cat_shape), draw(mat_shape), draw(mat_shape))


def _surgery_split(params: ClusterParams, i: int,
                   noise: Sequence[Tensor]) -> ClusterParams:
  """Apply the chosen split: base cluster i <- fork1_i, append fork2_i; the
  forks restart from the new base plus 1e-6 x `noise` (`surgery_noise`)."""

  def fork(base, f1, f2, chunk, n1, n2):
    lb, ub = i * chunk, (i + 1) * chunk
    base = base.detach().clone()
    base[:, lb:ub] = f1[:, lb:ub]
    base = torch.cat([base, f2[:, lb:ub]], dim=-1)
    return base, base + n1.to(base.device) * 1e-6, base + n2.to(base.device) * 1e-6

  cpb, cpf1, cpf2 = fork(params.cat_pred_base, params.cat_pred_fork1,
                         params.cat_pred_fork2, 1, noise[0], noise[1])
  mpb, mpf1, mpf2 = fork(params.mat_pred_base, params.mat_pred_fork1,
                         params.mat_pred_fork2, 12, noise[2], noise[3])
  return params._replace(
      cat_pred_base=cpb, cat_pred_fork1=cpf1, cat_pred_fork2=cpf2,
      mat_pred_base=mpb, mat_pred_fork1=mpf1, mat_pred_fork2=mpf2)


def _surgery_delete(params: ClusterParams, i: int) -> ClusterParams:
  drop = lambda v, chunk: _drop(v.detach(), i, chunk).clone()
  return params._replace(
      cat_pred_base=drop(params.cat_pred_base, 1),
      cat_pred_fork1=drop(params.cat_pred_fork1, 1),
      cat_pred_fork2=drop(params.cat_pred_fork2, 1),
      mat_pred_base=drop(params.mat_pred_base, 12),
      mat_pred_fork1=drop(params.mat_pred_fork1, 12),
      mat_pred_fork2=drop(params.mat_pred_fork2, 12),
  )


# The JAX package's optimizer, optax.chain(clip_by_global_norm(1e-3),
# adam(5e-2, b1=0.9, b2=0.99)), with optax's arithmetic.
MAX_NORM, LEARNING_RATE, ADAM_B1, ADAM_B2, ADAM_EPS = 1e-3, 5e-2, 0.9, 0.99, 1e-8


def flatten(leaves: Sequence[Tensor]) -> Tensor:
  return torch.cat([v.reshape(-1) for v in leaves])


def unflatten(flat: Tensor, like: Sequence[Tensor]) -> List[Tensor]:
  """Views of `flat` with the shapes of `like`, in order."""
  parts = torch.split(flat, [v.numel() for v in like])
  return [p.view(v.shape) for p, v in zip(parts, like)]


def optimizer_init(params: ClusterParams) -> Dict[str, Any]:
  n = sum(v.numel() for v in param_leaves(params))
  zeros = lambda: torch.zeros(n, device=params.point_state.device,
                              dtype=params.point_state.dtype)
  return dict(count=0, mu=zeros(), nu=zeros())


@torch.no_grad()
def optimizer_update(grads: Sequence[Tensor], state: Mapping[str, Any],
                     lr_mul: float):
  """(updates, new state): the clipped Adam step scaled by -lr * lr_mul, as
  one flat tensor in leaf order (`unflatten` splits it). The moments are
  flat too, so a step is a handful of launches whatever the leaf count, and
  nothing waits on the device (the clip is a select)."""
  g = flatten(grads)
  # optax's global norm sums each leaf, then the leaves; one flat sum
  # differs from it in rounding only.
  g_norm = torch.sqrt(torch.sum(torch.square(g)))
  g = torch.where(g_norm < MAX_NORM, g, (g / g_norm) * MAX_NORM)
  mu = (1 - ADAM_B1) * g + ADAM_B1 * state["mu"]
  nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state["nu"]
  count = state["count"] + 1
  c1 = float(np.float32(1 - np.float32(ADAM_B1) ** np.float32(count)))
  c2 = float(np.float32(1 - np.float32(ADAM_B2) ** np.float32(count)))
  updates = ((mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)) * -LEARNING_RATE
  return updates * lr_mul, dict(count=count, mu=mu, nu=nu)


class GeneratorDraws:
  """compute_clusters' random draws, from torch Generators seeded by `seed`:
  the initial parameters on the CPU (`init_params`), every step's sampled
  points and frames and out-of-bounds noise (`step`) and the surgery noise
  (`surgery`) on `device`, and the final assignment's noise (`final`) from
  `seed` + 1. Another object with these four methods (a test's replay of
  the JAX package's own draws) may take its place."""

  def __init__(self, seed: int, device):
    self.seed = seed
    self.device = device
    self.generator = torch.Generator(device=device).manual_seed(seed)

  def init_params(self, pts: Tensor, vis: Tensor) -> ClusterParams:
    return init_params(torch.Generator().manual_seed(self.seed), pts, vis,
                       num_cats=1)

  def step(self, n: int, t: int, point_sample: int, frame_sample: int,
           num_cats: int) -> Tuple[Tensor, Tensor, Tensor]:
    g, dev = self.generator, self.device
    pts_idx = torch.randperm(n, generator=g, device=dev)[:point_sample]
    fr_idx = torch.randperm(t, generator=g, device=dev)[:frame_sample]
    noise = torch.randn((point_sample, frame_sample, num_cats, 1),
                        generator=g, device=dev)
    return pts_idx, fr_idx, noise

  def surgery(self, params: ClusterParams) -> Tuple[Tensor, ...]:
    return surgery_noise(self.generator, params)

  def final(self, shape) -> Tensor:
    return torch.randn(shape, device=self.device, generator=torch.Generator(
        device=self.device).manual_seed(self.seed + 1))


def _filter_points(tree, keep):
  if isinstance(tree, Mapping):
    return type(tree)((k, _filter_points(v, keep)) for k, v in tree.items())
  if isinstance(tree, tuple) and hasattr(tree, "_fields"):
    return type(tree)(*(_filter_points(v, keep) for v in tree))
  if isinstance(tree, (list, tuple)):
    return type(tree)(_filter_points(v, keep) for v in tree)
  if hasattr(tree, "shape") and math.prod(tree.shape) > 0:
    return tree[:, keep]
  return tree


def compute_clusters(
    separation_tracks_dict: Mapping[str, np.ndarray],
    separation_visibility_dict: Mapping[str, np.ndarray],
    demo_episode_ids: Sequence[str],
    separation_video_shapes: Mapping[str, Sequence[int]],
    query_features=None,
    final_num_cats: int = 15,
    max_num_cats: int = 25,
    low_visibility_threshold: float = 0.1,
    use_em: bool = False,
    fourdof: bool = True,
    cam_focal_length: float = 1.0,
    iters_before_split: int = 500,
    point_sample: int = 2048,
    frame_sample: int = 1024,
    verbose: bool = True,
    device: Optional[Any] = None,
    draws=None,
) -> Dict[str, Any]:
  """End-to-end clustering over (possibly multiple) episodes of tracks.

  The optimization runs on `device` (None: the CUDA card; raises without
  one), its random draws from `draws` (default `GeneratorDraws(42, device)`,
  as the JAX version starts from PRNGKey(42)).

  Returns a dict with "classes" (argmin-error cluster per point),
  "sum_error" and "num_steps" alongside the filtered inputs.
  """
  from tapnet_tpu_torch.inference import resolve_device

  device = resolve_device(device)
  tracks = np.concatenate(
      [separation_tracks_dict[k] for k in demo_episode_ids], axis=1)
  visibility = np.concatenate(
      [separation_visibility_dict[k] for k in demo_episode_ids], axis=1)
  enough = visibility.mean(-1) > low_visibility_threshold
  tracks, visibility = tracks[enough], visibility[enough]
  separation_tracks_dict = {
      k: v[enough] for k, v in separation_tracks_dict.items()}
  separation_visibility_dict = {
      k: v[enough] for k, v in separation_visibility_dict.items()}
  if query_features is not None:
    query_features = _filter_points(query_features, enough)

  boundaries, cur = [], 0
  for k in demo_episode_ids:
    t = separation_video_shapes[k][0]
    boundaries.append((cur, cur + t))
    cur += t
  boundaries = tuple(boundaries)

  shp = separation_video_shapes[demo_episode_ids[0]]
  pts = torch.tensor((tracks / np.array([shp[2], shp[1]])).astype(np.float32),
                     device=device)
  vis = torch.tensor(visibility.astype(np.float32), device=device)
  n, t = pts.shape[:2]
  point_sample, frame_sample = min(point_sample, n), min(frame_sample, t)

  draws = draws or GeneratorDraws(42, device)
  params = draws.init_params(pts, vis)
  opt_state = optimizer_init(params)

  num_iters = (
      max_num_cats + (max_num_cats - final_num_cats) - 1
  ) * iters_before_split
  num_cats = 1
  delete_mode = False
  loss_ma = 0.0
  num_since_fork = 0

  for step in range(num_iters):
    if step % iters_before_split == iters_before_split - 1:
      target = int(torch.argmin(loss_ma)) if torch.is_tensor(loss_ma) else 0
      if delete_mode:
        num_cats -= 1
        if verbose:
          print(f"deleting {target}; num_cats={num_cats}")
        params = _surgery_delete(params, target)
        if num_cats <= final_num_cats:
          # Done deleting; finish with plain (split-mode) optimization.
          delete_mode = False
      else:
        num_cats += 1
        if verbose:
          print(f"splitting {target}; num_cats={num_cats}")
        params = _surgery_split(params, target, draws.surgery(params))
        delete_mode = num_cats == max_num_cats
      opt_state = optimizer_init(params)
      loss_ma = 0.0
      num_since_fork = 0

    lr_mul = min(1.0, (num_since_fork + 1) / 20.0)
    frac = step / max(num_iters, 1)
    lr_mul *= 0.5 ** sum(frac > f for f in (0.25, 0.5, 0.75))
    leaves = [v.detach().requires_grad_(True) for v in param_leaves(params)]
    pts_idx, fr_idx, noise = draws.step(n, t, point_sample, frame_sample,
                                        num_cats)
    loss, losses = loss_fn(
        params_from_leaves(leaves), pts, vis, pts_idx, fr_idx, noise,
        num_cats=num_cats, delete_mode=delete_mode,
        sequence_boundaries=boundaries, final_num_cats=final_num_cats,
        use_em=use_em, fourdof=fourdof, cam_focal_length=cam_focal_length)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    updates, opt_state = optimizer_update(grads, opt_state, lr_mul)
    params = params_from_leaves(unflatten(
        flatten([v.detach() for v in leaves]) + updates, leaves))
    loss_ma = 0.9 * loss_ma + 0.1 * losses.detach()
    num_since_fork += 1
    if verbose and step % 100 == 0:
      print(f"step {step} loss {float(loss):.6f} num_cats {num_cats}")

  # Final hard assignment by total reprojection error.
  with torch.no_grad():
    pos, mats = _predict_joint(params, pts, vis, boundaries, fourdof, 1)
    pred, _ = project(mats, pos, cam_focal_length,
                      draws.final((n, t, pos.shape[1], 1)))
    sum_error = get_err(pts, vis, pred).cpu().numpy()
  return {
      "classes": np.argmin(sum_error, axis=-1),
      "sum_error": sum_error,
      "num_steps": num_iters,
      "separation_visibility": separation_visibility_dict,
      "separation_tracks": separation_tracks_dict,
      "query_features": query_features,
      "demo_episode_ids": list(demo_episode_ids),
  }
