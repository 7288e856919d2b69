"""The vKITTI3D frame cell's frozen inputs, its embedder's weights and
the embedder's operation count.

- `synthetic_street`, `write_vkitti_frame`: copies of the program's
  street-frame generator as it stood when the cell was defined
  (`superpoint_graph_tpu_torch/data/synthetic.py`), so that a seed gives
  the same frames, byte for byte, whatever the program's copy becomes;
- `draw_embedder`: the LocalEmbedder's weights from the run's seed, drawn
  as harness/weights.py draws the SPG model's, in the reference's layout
  (reference/ssp.py::embedder_specs);
- `embedder_flops`: the matrix-product operations of embedding n voxels.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ..reference.ssp import embedder_specs, n_global
from .flops import _mlp

# a street frame's parts: (vKITTI class, share of the points); the
# remainder of the budget goes to don't-care points (13)
_STREET_PARTS = ((4, 0.24), (0, 0.12), (3, 0.18), (1, 0.10), (2, 0.06),
                 (5, 0.03), (6, 0.01), (7, 0.01), (8, 0.02), (9, 0.02),
                 (11, 0.08), (12, 0.04), (10, 0.04))
# class colours, vKITTI ids 0..13
_STREET_RGB = np.array(
    [[110, 130, 70], [40, 110, 30], [80, 160, 60], [170, 150, 130],
     [90, 90, 95], [180, 180, 180], [230, 200, 40], [60, 60, 60],
     [130, 130, 130], [150, 80, 160], [200, 60, 50], [40, 60, 200],
     [220, 220, 230], [120, 170, 230]])


def _box_surface(rng, n, center, size):
    """n points on the faces of an axis-aligned box."""
    p = rng.rand(n, 3) - 0.5
    face = rng.randint(0, 6, n)
    p[np.arange(n), face // 2] = np.where(face % 2, 0.5, -0.5)
    return p * size + center


def synthetic_street(rng: np.random.RandomState, n_points: int,
                     length: float = 10.0, noise: float = 0.01):
    """A vKITTI3D-like street frame, `length` m along x: a road (|y| < 4),
    terrain verges, building facades at |y| = 8, guard rails, trees,
    bushes, poles with signs and lights, small objects, cars, vans and
    trucks: surfaces, as a stereo or lidar frame sees them, and
    don't-care points on a backdrop beyond the far end. Returns (xyz f32
    [n, 3], rgb u8 [n, 3], labels int32 [n]: the raw vKITTI class ids
    0..13)."""
    parts = []
    budget = n_points
    for label, share in _STREET_PARTS:
        n = int(share * n_points)
        budget -= n
        u = rng.rand(n, 3)
        x = u[:, 0] * length
        if label == 4:  # road
            p = np.stack([x, (u[:, 1] - 0.5) * 8, 0.005 * u[:, 2]], 1)
        elif label == 0:  # verges, gently sloped
            y = np.where(u[:, 1] < 0.5, -4 - 4 * u[:, 2], 4 + 4 * u[:, 2])
            p = np.stack([x, y, 0.05 * (np.abs(y) - 4)], 1)
        elif label == 3:  # facades
            side = np.where(u[:, 1] < 0.5, -8.0, 8.0)
            p = np.stack([x, side, 6 * u[:, 2]], 1)
        elif label == 5:  # guard rails
            side = np.where(u[:, 1] < 0.5, -4.3, 4.3)
            p = np.stack([x, side, 0.4 + 0.4 * u[:, 2]], 1)
        elif label in (1, 2):  # tree crowns on trunks, bushes
            k = max(1, int(length / (6 if label == 1 else 4)))
            c = np.stack([rng.rand(k) * length,
                          rng.choice([-1, 1], k) * (5 + 2 * rng.rand(k)),
                          np.full(k, 4.0 if label == 1 else 0.5)], 1)
            r = 1.5 if label == 1 else 0.5
            d = rng.randn(n, 3)  # the crowns' and bushes' outer shells
            d *= (r * (0.9 + 0.1 * u[:, :1])) / np.linalg.norm(
                d, axis=1, keepdims=True)
            p = c[rng.randint(0, k, n)] + d
            if label == 1:  # a fifth of the points on the trunks
                t = rng.rand(n) < 0.2
                p[t, 2] = 2.5 * u[t, 2]
                p[t, :2] = c[rng.randint(0, k, int(t.sum())), :2] + \
                    0.15 * rng.randn(int(t.sum()), 2)
        elif label in (6, 7, 8):  # signs, lights, poles at the kerb
            k = max(1, int(length / 10))
            c = np.stack([rng.rand(k) * length, rng.choice([-4.6, 4.6], k)],
                         1)[rng.randint(0, k, n)]
            if label == 8:
                p = np.stack([c[:, 0] + 0.08 * rng.randn(n),
                              c[:, 1] + 0.08 * rng.randn(n), 4 * u[:, 2]], 1)
            else:
                size = [0.05, 0.6, 0.6] if label == 6 else [0.3, 0.3, 0.9]
                p = _box_surface(rng, n, np.zeros(3), size)
                p[:, :2] += c
                p[:, 2] += 2.5 if label == 6 else 4.0
        else:  # cars (11), vans (12), trucks (10), misc (9): boxes
            size = {11: [4.2, 1.8, 1.5], 12: [5.0, 2.0, 2.2],
                    10: [8.0, 2.5, 3.2], 9: [0.6, 0.6, 0.8]}[label]
            k = max(1, int(length / (8 if label == 11 else 15)))
            c = np.stack([rng.rand(k) * length,
                          rng.choice([-2.0, 2.0], k) if label != 9
                          else rng.choice([-7.0, 7.0], k),
                          np.full(k, size[2] / 2)], 1)
            p = _box_surface(rng, n, c[rng.randint(0, k, n)], size)
        parts.append((p, np.full(n, label)))
    u = rng.rand(budget, 3)  # a backdrop across the street's far end
    p = np.stack([length + 2 + 0.5 * u[:, 0], (u[:, 1] - 0.5) * 16,
                  8 * u[:, 2]], 1)
    parts.append((p, np.full(budget, 13)))
    xyz = np.concatenate([q for q, _ in parts]).astype(np.float32)
    labels = np.concatenate([lab for _, lab in parts]).astype(np.int32)
    xyz += rng.randn(*xyz.shape).astype(np.float32) * noise
    rgb = _STREET_RGB[labels] + rng.randn(len(labels), 3) * 12
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    perm = rng.permutation(len(xyz))
    return xyz[perm], rgb[perm], labels[perm]


def write_vkitti_frame(path: Path, rng: np.random.RandomState,
                       n_points: int) -> np.ndarray:
    """`path` (.npy) holding a `synthetic_street` frame as vKITTI3D stores
    one, float32 rows [x y z r g b label]; returns the raw labels."""
    xyz, rgb, labels = synthetic_street(rng, n_points)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.hstack([xyz, rgb.astype(np.float32),
                             labels[:, None].astype(np.float32)]))
    return labels


def draw_embedder(cfg: dict, seed: int, device) -> dict:
    """{name: float32 tensor on `device`} for the embedder of `cfg` (a
    configuration's "embedder" entry), from `seed`: one normal draw cut
    into every parameter and batch-norm statistic, scaled as
    harness/weights.py scales the SPG model's."""
    specs = embedder_specs(cfg)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out = {}
    for (name, shape, kind), part in zip(specs, torch.split(flat, sizes)):
        x = part.reshape(shape)
        if kind == "weight":
            x = x / math.sqrt(math.prod(shape[1:]))
        elif kind == "stn_proj":
            x = x * (0.1 / math.sqrt(shape[1]))
        elif kind in ("bias", "bn_bias", "bn_mean"):
            x = x * 0.1
        elif kind == "bn_weight":
            x = 1.0 + 0.1 * x
        elif kind == "bn_var":
            x = 1.0 + 0.1 * x.abs()
        out[name] = x.contiguous()
    return out


def embedder_flops(cfg: dict, n_vertices: int, k_local: int) -> float:
    """Matrix-product operations (2 per multiply-add) of embedding
    n_vertices voxels' local clouds of k_local points: per point the
    transformer's convolutions, xy @ T and the PointNet's convolutions; per
    voxel the transformer's dense layers and projection and the PointNet's
    dense layers over the pooled features, the globals and T. Element-wise
    work is left out."""
    conv_w, fc_w = cfg["ptn_widths"]
    stn_conv_w, stn_fc_w = cfg["ptn_widths_stn"]
    n_feat = 3 + 3 * bool(cfg["use_rgb"])
    per_point = (_mlp([cfg["ptn_nfeat_stn"], *stn_conv_w]) + 2 * 2 * 2
                 + _mlp([n_feat, *conv_w]))
    n_in = conv_w[-1] + n_global(cfg) + 4 * bool(cfg["stn_as_global"])
    per_voxel = (_mlp([stn_conv_w[-1], *stn_fc_w]) + 2 * stn_fc_w[-1] * 4
                 + _mlp([n_in, *fc_w]))
    return float(n_vertices) * (k_local * per_point + per_voxel)
