"""Track visualization + camera-motion (homography) estimation (the port's
own copy of tapnet_tpu/utils/viz.py; numpy, with matplotlib and cv2
imported lazily).

Capability parity with the reference suite (tapnet/utils/viz_utils.py):
point-splat videos, matplotlib track plots, mp4 writing, and the
"rainbow" pipeline (DLT homography, RANSAC, canonical points, per-frame
homographies, tail plotting).

Differences by design:
  * `paint_point_track` splats all points of a frame in one vectorized
    accumulation instead of a per-point Python loop.
  * RANSAC evaluates a whole batch of 4-point hypotheses at once (vmapped
    SVD + inlier count + argmax) instead of a sequential while-loop — the
    accelerator-friendly formulation — then refits on the inliers.
  * Videos are written with OpenCV (mediapy is not a dependency).
  * Every random draw comes from a generator the caller can pass:
    `plot_tracks`' colour permutation (`rng`, where the JAX version draws
    from numpy's global state) and `compute_canonical_points`' re-seeding
    (`rng`, where the JAX version falls back to numpy's global state).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

# A numpy random source: a Generator or a legacy RandomState (whose draws
# equal those of numpy's global state after `np.random.seed` of the seed).
Rng = Union[np.random.Generator, np.random.RandomState]

Array = np.ndarray


# --------------------------------------------------------------------- colors


def get_colors(
    num_colors: int, seed: Optional[int] = None
) -> List[Tuple[int, int, int]]:
  """Distinct track colors: a vectorized HSV hue wheel, shuffled.

  Evenly-spaced hues at high saturation/value, computed with the piecewise
  hue->RGB triangle formula over the whole wheel at once, then shuffled so
  neighboring track indices get visually distant colors. Pass `seed` for a
  deterministic palette.
  """
  h6 = 6.0 * np.arange(num_colors, dtype=np.float64) / max(num_colors, 1)
  hue_rgb = np.stack(
      [
          np.clip(np.abs(h6 - 3.0) - 1.0, 0.0, 1.0),
          np.clip(2.0 - np.abs(h6 - 2.0), 0.0, 1.0),
          np.clip(2.0 - np.abs(h6 - 4.0), 0.0, 1.0),
      ],
      axis=-1,
  )
  sat, val = 0.92, 0.98
  rgb = np.round(255.0 * val * (1.0 - sat * (1.0 - hue_rgb))).astype(int)
  np.random.default_rng(seed).shuffle(rgb, axis=0)
  return [tuple(c) for c in rgb]


# ------------------------------------------------------------------ splatting


def paint_point_track(
    frames: Array,
    point_tracks: Array,
    visibles: Array,
    colormap: Optional[List[Tuple[int, int, int]]] = None,
) -> Array:
  """Render tracked points as soft dots onto video frames.

  Args:
    frames: [T, H, W, 3] uint8.
    point_tracks: [N, T, 2] (x, y) raster coordinates.
    visibles: [N, T] bool.
    colormap: optional per-point RGB colors.

  Returns:
    [T, H, W, 3] uint8 video with points rendered.
  """
  num_points, num_frames = point_tracks.shape[:2]
  if colormap is None:
    colormap = get_colors(num_points)
  colors = np.asarray(colormap, np.float32)  # [N, 3]
  height, width = frames.shape[1:3]

  # Floor of 1: tiny frames would round to radius 0, making the soft-disc
  # profile divide by zero (NaN icon -> black output).
  radius = max(1, int(round(min(height, width) * 0.015)))
  diam = radius * 2 + 1
  # Soft disc profile.
  dy = np.arange(diam)[:, None] - radius
  dx = np.arange(diam)[None, :] - radius
  base_icon = 1.0 - np.clip(
      ((dy**2 + dx**2) - (radius**2) / 2.0) / (radius * 2 * 0.15), 0, 1
  )

  # Canvas pad: icon extends radius+1 past the floor cell; clipped points can
  # sit at exactly x == width, so pad by radius+2 to keep slices in range.
  pad = radius + 2
  out = []
  for t in range(num_frames):
    canvas = np.pad(
        frames[t].astype(np.float32), [(pad, pad), (pad, pad), (0, 0)]
    )
    alpha_acc = np.zeros(canvas.shape[:2] + (1,), np.float32)
    color_acc = np.zeros_like(canvas)
    for i in range(num_points):
      if not visibles[i, t]:
        continue
      x = np.clip(point_tracks[i, t, 0], 0.0, width) + pad
      y = np.clip(point_tracks[i, t, 1], 0.0, height) + pad
      x0, y0 = int(np.floor(x)), int(np.floor(y))
      fx, fy = x - x0, y - y0
      # Bilinearly shift the icon to the subpixel position.
      icon = np.zeros((diam + 1, diam + 1), np.float32)
      icon[:-1, :-1] += base_icon * (1 - fy) * (1 - fx)
      icon[1:, :-1] += base_icon * fy * (1 - fx)
      icon[:-1, 1:] += base_icon * (1 - fy) * fx
      icon[1:, 1:] += base_icon * fy * fx
      ys = slice(y0 - radius, y0 + radius + 2)
      xs = slice(x0 - radius, x0 + radius + 2)
      a = icon[..., None]
      color_acc[ys, xs] += a * colors[i]
      alpha_acc[ys, xs] = np.maximum(alpha_acc[ys, xs], a)
      canvas[ys, xs] = (1 - a) * canvas[ys, xs] + a * colors[i]
    out.append(
        np.clip(canvas[pad:-pad, pad:-pad], 0, 255).astype(np.uint8)
    )
  return np.stack(out)


# ------------------------------------------------------------------ plotting


def _render_figure(fig) -> Array:
  fig.canvas.draw()
  w, h = fig.get_size_inches() * fig.get_dpi()
  buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
  return buf.reshape(int(h), int(w), 4)[..., :3].copy()


def plot_tracks(
    rgb: Array,
    points: Array,
    occluded: Array,
    gt_points: Optional[Array] = None,
    gt_occluded: Optional[Array] = None,
    trackgroup: Optional[Array] = None,
    point_size: int = 20,
    rng: Optional[Rng] = None,
) -> Array:
  """Matplotlib scatter of tracks per frame (predictions as dots, optional
  ground truth as diamonds). The track groups' colours are permuted with
  `rng` (default a fresh `np.random.default_rng()`). Returns [T, H, W, 3]
  uint8."""
  import matplotlib

  matplotlib.use("Agg")
  import matplotlib.pyplot as plt

  disp = []
  cmap = plt.cm.hsv
  z_list = (
      np.arange(points.shape[0])
      if trackgroup is None
      else np.asarray(trackgroup)
  )
  rng = np.random.default_rng() if rng is None else rng
  z_list = rng.permutation(np.max(z_list) + 1)[z_list]
  colors = cmap(z_list / (np.max(z_list) + 1))
  dpi = 64

  points = np.clip(points, 0.0, [rgb.shape[2], rgb.shape[1]])
  if gt_points is not None:
    gt_points = np.clip(gt_points, 0.0, [rgb.shape[2], rgb.shape[1]])

  for i in range(rgb.shape[0]):
    fig = plt.figure(
        figsize=(rgb.shape[2] / dpi, rgb.shape[1] / dpi),
        dpi=dpi,
        frameon=False,
        facecolor="w",
    )
    ax = fig.add_subplot()
    ax.axis("off")
    ax.imshow(rgb[i] / 255.0)
    colalpha = np.clip(
        np.concatenate([colors[:, :-1], 1 - occluded[:, i : i + 1]], 1), 0, 1
    )
    ax.scatter(points[:, i, 0], points[:, i, 1], s=point_size, c=colalpha)
    if gt_points is not None:
      colalpha = np.clip(
          np.concatenate(
              [colors[:, :-1], 1 - gt_occluded[:, i : i + 1]], 1
          ),
          0,
          1,
      )
      ax.scatter(
          gt_points[:, i, 0],
          gt_points[:, i, 1],
          s=point_size + 6,
          c=colalpha,
          marker="D",
      )
    fig.subplots_adjust(top=1, bottom=0, right=1, left=0, hspace=0, wspace=0)
    disp.append(_render_figure(fig))
    plt.close(fig)
  return np.stack(disp)


def plot_tracks_grid(
    rgb: Array,
    points: Array,
    occluded: Array,
    gt_points: Optional[Array] = None,
    gt_occluded: Optional[Array] = None,
    trackgroup: Optional[Array] = None,
    rng: Optional[Rng] = None,
) -> Array:
  """2x2 grid of track plots, splitting track groups across panels; the
  panels draw their colours from `rng` in turn."""
  rng = np.random.default_rng() if rng is None else rng
  if trackgroup is None:
    trackgroup = np.arange(points.shape[0])
  else:
    trackgroup = np.asarray(trackgroup)
  groups = np.array_split(np.unique(trackgroup), 4)
  panels = []
  for g in groups:
    valid = np.isin(trackgroup, g)
    remap = np.searchsorted(g, trackgroup[valid])
    panels.append(
        plot_tracks(
            rgb,
            points[valid],
            occluded[valid],
            None if gt_points is None else gt_points[valid],
            None if gt_occluded is None else gt_occluded[valid],
            remap,
            rng=rng,
        )
    )
  top = np.concatenate(panels[0:2], axis=2)
  bottom = np.concatenate(panels[2:4], axis=2)
  return np.concatenate([top, bottom], axis=1)


def write_video(path: str, frames: Array, fps: int = 5) -> None:
  """Write [T, H, W, 3] uint8 frames to an mp4 via OpenCV."""
  import cv2

  h, w = frames.shape[1:3]
  writer = cv2.VideoWriter(
      path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
  )
  for frame in frames:
    writer.write(frame[..., ::-1])  # RGB -> BGR
  writer.release()


def write_visualization(
    video: Array,
    points: Array,
    occluded: Array,
    visualization_path: Sequence[str],
    gt_points: Optional[Array] = None,
    gt_occluded: Optional[Array] = None,
    trackgroup: Optional[Array] = None,
    rng: Optional[Rng] = None,
) -> None:
  """Render and write one mp4 per batch element; the plots draw their
  colours from `rng` in turn."""
  rng = np.random.default_rng() if rng is None else rng
  for i in range(video.shape[0]):
    frames = plot_tracks(
        video[i],
        points[i],
        occluded[i],
        gt_points[i] if gt_points is not None else None,
        gt_occluded[i] if gt_occluded is not None else None,
        trackgroup[i] if trackgroup is not None else None,
        rng=rng,
    )
    write_video(visualization_path[i], frames)


# ------------------------------------------------------- homography pipeline


def estimate_homography(targ_pts, src_pts, mask=None) -> Array:
  """DLT homography from point correspondences (weighted least squares via
  SVD of the 2N x 9 constraint matrix).

  Pure numpy: this is host-side analytics; accelerator dispatch would only
  add compile latency. Supports a leading batch of correspondence sets.
  """
  targ_pts = np.asarray(targ_pts, np.float64)
  src_pts = np.asarray(src_pts, np.float64)
  if mask is None:
    mask = np.ones_like(targ_pts[..., 0])
  mask = np.asarray(mask, np.float64)
  tx, ty = targ_pts[..., 0], targ_pts[..., 1]
  sx, sy = src_pts[..., 0], src_pts[..., 1]
  one = np.ones_like(tx)
  zero = np.zeros_like(tx)
  row_x = np.stack(
      [sx, sy, one, zero, zero, zero, -tx * sx, -tx * sy, -tx], axis=-1
  )
  row_y = np.stack(
      [zero, zero, zero, sx, sy, one, -ty * sx, -ty * sy, -ty], axis=-1
  )
  a = np.concatenate(
      [row_x * mask[..., None], row_y * mask[..., None]], axis=-2
  )
  _, _, vt = np.linalg.svd(a, full_matrices=a.shape[-2] <= 8)
  return vt[..., -1, :].reshape(a.shape[:-2] + (3, 3))


def apply_homography(homog, pts):
  """Transform [..., 2] points by a homography, sign-safe perspective divide."""
  homog = np.asarray(homog)
  pts = np.asarray(pts)
  pts_h = np.concatenate([pts, np.ones_like(pts[..., :1])], axis=-1)
  out = pts_h @ np.swapaxes(homog, -1, -2)
  denom = np.maximum(1e-12, np.abs(out[..., -1:])) * np.sign(out[..., -1:])
  return out[..., :2] / denom


def compute_inliers(homog, thresh, targ_pts, src_pts):
  """Returns (inlier mask, squared errors, transformed source points)."""
  tformed = apply_homography(homog, src_pts)
  err = np.sum(np.square(np.asarray(targ_pts) - tformed), axis=-1)
  return err < thresh * thresh, err, tformed


def ransac_homography(
    targ_pts,
    src_pts,
    vis,
    thresh: float = 4.0,
    num_hypotheses: int = 128,
    seed: int = 0,
):
  """Batched-hypothesis RANSAC.

  Samples `num_hypotheses` visible 4-subsets (Gumbel top-k for weighted
  sampling without replacement), fits all homographies with one batched SVD,
  counts inliers for all at once, picks the best, and refits on its inliers.

  Returns:
    (final_homog [3, 3], inlier mask [N]).
  """
  targ_pts = np.asarray(targ_pts)
  src_pts = np.asarray(src_pts)
  vis = np.asarray(vis, np.float64)
  n = targ_pts.shape[0]
  rng = np.random.RandomState(seed)

  logp = np.where(vis > 0, np.log(np.maximum(vis, 1e-12)), -np.inf)
  gumbel = -np.log(-np.log(rng.random((num_hypotheses, n)) + 1e-12) + 1e-12)
  subsets = np.argsort(-(logp[None] + gumbel), axis=-1)[:, :4]  # [K, 4]

  homogs = estimate_homography(targ_pts[subsets], src_pts[subsets])
  # Batched inliers: [K, N].
  pts_h = np.concatenate([src_pts, np.ones_like(src_pts[:, :1])], axis=-1)
  out = np.einsum("kij,nj->kni", homogs, pts_h)
  denom = np.maximum(1e-12, np.abs(out[..., -1:])) * np.sign(out[..., -1:])
  tformed = out[..., :2] / denom
  err = np.square(targ_pts[None] - tformed).sum(-1)
  inliers = (err < thresh * thresh) & (vis > 0)[None]
  best = np.argmax(inliers.sum(-1))

  final = estimate_homography(
      targ_pts, src_pts, inliers[best].astype(np.float64)
  )
  final_inliers, _, _ = compute_inliers(final, thresh, targ_pts, src_pts)
  return final, final_inliers


def maybe_ransac_homography(
    targ_pts, targ_occ, src_pts, src_occ, thresh: float = 4.0, seed: int = 0
):
  """RANSAC when enough covisible points exist, else identity."""
  vis = np.logical_and(
      np.logical_not(np.asarray(targ_occ)), np.logical_not(np.asarray(src_occ))
  )
  if np.sum(vis) > 4:
    homog, _ = ransac_homography(targ_pts, src_pts, vis, thresh, seed=seed)
  else:
    homog = np.eye(3)
  inliers, err, tformed = compute_inliers(homog, thresh, targ_pts, src_pts)
  return homog, inliers, tformed, err


def compute_canonical_points(
    all_tformed,
    occ,
    err,
    inner_thresh,
    outer_thresh,
    required_inlier_frac,
    rng: Optional[Rng] = None,
):
  """Average per-track canonical positions over non-outlier frames; tracks
  with too few inliers are re-seeded from a random visible frame, drawn from
  `rng` (default a fresh `np.random.default_rng()`)."""
  rng = np.random.default_rng() if rng is None else rng
  all_tformed = np.asarray(all_tformed)
  occ = np.asarray(occ).astype(bool)
  err = np.asarray(err)

  definite_outliers = occ | (err > outer_thresh)
  maybe_inliers = (~occ) & (err < inner_thresh)
  frac_inliers = maybe_inliers.sum(0) / np.maximum(1.0, (~occ).sum(0))
  invalid = frac_inliers < required_inlier_frac

  keep = ~definite_outliers
  canonical = np.einsum("tnc,tn->nc", all_tformed, keep.astype(
      all_tformed.dtype
  )) / np.maximum(1.0, keep.sum(0))[:, None]

  # Re-seed invalid tracks from a random visible frame (0 if none).
  vis = (~occ).astype(np.int64)
  pick = np.floor(rng.random(vis.shape[1]) * vis.sum(0))
  order = np.cumsum(vis, axis=0) * vis - occ.astype(np.int64)
  hit = order == pick[None, :]
  frame_idx = (hit * np.arange(vis.shape[0])[:, None]).sum(0)
  random_pts = np.take_along_axis(
      all_tformed, frame_idx[None, :, None], axis=0
  )[0]
  canonical = np.where(invalid[:, None], random_pts, canonical)
  return canonical, invalid


def get_homographies_wrt_frame(
    pts,
    occ,
    image_dimensions,
    reference_frame: Optional[int] = None,
    thresh: float = 0.07,
    outlier_point_threshold: float = 0.95,
    num_refinement_passes: int = 2,
    verbose: bool = False,
):
  """Per-frame homographies to a canonical (reference) frame.

  Initializes with per-frame RANSAC against running canonical points
  (frames after the reference first, then before), then refines each frame's
  homography against the global canonical estimate.

  Args:
    pts: [N, T, 2] (x, y) raster tracks.
    occ: [N, T] occlusion (1 = occluded).
    image_dimensions: (width, height); points normalized internally.
    reference_frame: canonical frame (default middle).
    thresh: inlier threshold in normalized units.
    outlier_point_threshold: min inlier fraction for a canonical point.
    num_refinement_passes: global refinement sweeps.
    verbose: print progress.

  Returns:
    (homogs [T, 3, 3], err [N, T], canonical_pts [N, 2]) — inv(H_i) @ H_j
    maps background points from frame j to frame i.
  """
  pts = np.transpose(np.asarray(pts), (1, 0, 2)) / np.asarray(
      image_dimensions
  )
  occ = np.transpose(np.asarray(occ))
  outer_thresh = 2.0 * thresh
  t = pts.shape[0]
  if reference_frame is None:
    reference_frame = t // 2

  canonical = pts[reference_frame]
  canonical_invalid = occ[reference_frame]
  all_tformed = np.zeros_like(pts)
  all_invalid = np.ones_like(occ)
  all_err = np.zeros(occ.shape)
  all_tformed[reference_frame] = canonical
  all_invalid[reference_frame] = canonical_invalid
  homogs: List = [None] * t
  homogs[reference_frame] = np.eye(3)
  rng = np.random.RandomState(0)

  frame_order = list(range(reference_frame + 1, t)) + list(
      range(reference_frame - 1, -1, -1)
  )
  for i in frame_order:
    if verbose:
      print(f"Initial RANSAC frame {i}...")
    h, _, tformed, err = maybe_ransac_homography(
        canonical, canonical_invalid, pts[i], occ[i], thresh=thresh, seed=i
    )
    all_tformed[i] = np.asarray(tformed)
    all_invalid[i] = occ[i]
    all_err[i] = np.asarray(err)
    homogs[i] = np.asarray(h)
    canonical, canonical_invalid = compute_canonical_points(
        all_tformed, all_invalid, all_err, thresh, outer_thresh,
        outlier_point_threshold, rng,
    )

  for sweep in range(num_refinement_passes):
    for fr in [reference_frame] + frame_order:
      if verbose:
        print(f"Refinement pass {sweep} frame {fr}...")
      _, err, _ = compute_inliers(homogs[fr], thresh, canonical, pts[fr])
      invalid = canonical_invalid | (np.asarray(err) > thresh * thresh)
      invalid = invalid | occ[fr].astype(bool)
      h = estimate_homography(
          canonical, pts[fr], np.asarray(~invalid, np.float32)
      )
      h = np.asarray(h)
      if fr == reference_frame and sweep != num_refinement_passes - 1:
        # Pin the reference frame's scale: fold its inverse into all frames.
        inv_h = np.linalg.inv(h)
        for fr2 in range(t):
          homogs[fr2] = inv_h @ homogs[fr2]
          _, _, tf2 = compute_inliers(
              homogs[fr2], thresh, canonical, pts[fr2]
          )
          all_tformed[fr2] = np.asarray(tf2)
        h = np.eye(3)
        canonical, _ = compute_canonical_points(
            all_tformed, all_invalid, all_err, thresh, outer_thresh,
            outlier_point_threshold, rng,
        )
      _, err, tformed = compute_inliers(h, thresh, canonical, pts[fr])
      all_tformed[fr] = np.asarray(tformed)
      all_err[fr] = np.asarray(err)
      homogs[fr] = h
      canonical, canonical_invalid = compute_canonical_points(
          all_tformed, all_invalid, all_err, thresh, outer_thresh,
          outlier_point_threshold, rng,
      )

  scaler = np.array(list(image_dimensions) + [1.0])
  homogs = np.stack(homogs, axis=0) @ np.diag(1.0 / scaler)
  return homogs, all_err.T, canonical


def plot_tracks_tails(
    rgb,
    points,
    occluded,
    homogs,
    point_size: int = 12,
    linewidth: float = 1.5,
) -> Array:
  """Rainbow tracks: each frame shows points plus camera-motion-compensated
  tails through all previous frames. Returns [T, H, W, 3] uint8."""
  import matplotlib

  matplotlib.use("Agg")
  import matplotlib.collections
  import matplotlib.pyplot as plt

  disp = []
  cmap = plt.cm.hsv
  z = np.arange(points.shape[0])
  colors = cmap(z / (np.max(z) + 1))
  dpi = 64
  wh = np.array([rgb.shape[2], rgb.shape[1]])
  points = np.clip(points, 0.0, wh)

  for i in range(rgb.shape[0]):
    fig = plt.figure(
        figsize=(rgb.shape[2] / dpi, rgb.shape[1] / dpi),
        dpi=dpi,
        frameon=False,
        facecolor="w",
    )
    ax = fig.add_subplot()
    ax.axis("off")
    ax.imshow(rgb[i] / 255.0)
    colalpha = np.concatenate(
        [colors[:, :-1], 1 - occluded[:, i : i + 1]], axis=1
    )
    ax.scatter(points[:, i, 0], points[:, i, 1], s=point_size, c=colalpha)

    reference = points[:, i]
    reference_occ = occluded[:, i : i + 1]
    inv_h_i = np.linalg.inv(homogs[i])
    for j in range(i - 1, -1, -1):
      transf = np.asarray(
          apply_homography(inv_h_i @ homogs[j], points[:, j])
      )
      segs = np.stack([transf, reference], axis=1)
      oob = (segs < 1.0) | (segs > wh)
      oob = np.logical_or(oob[:, 0], oob[:, 1])
      oob = np.logical_or(oob[:, 0:1], oob[:, 1:2])
      segs = np.clip(segs, 1.0, wh - 1)
      colalpha2 = np.concatenate(
          [
              colors[:, :-1],
              (1 - occluded[:, j : j + 1]) * (1 - reference_occ) * (1 - oob),
          ],
          axis=1,
      )
      ax.add_collection(
          matplotlib.collections.LineCollection(
              segs, color=np.clip(colalpha2, 0, 1), linewidth=linewidth
          )
      )
      reference_occ = occluded[:, j : j + 1]
      reference = transf

    fig.subplots_adjust(top=1, bottom=0, right=1, left=0, hspace=0, wspace=0)
    disp.append(_render_figure(fig))
    plt.close(fig)
  return np.stack(disp)
