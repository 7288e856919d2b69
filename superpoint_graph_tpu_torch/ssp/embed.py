"""Per-point local embedder of the supervised partition (SSP) and its
trainer.

Port of superpoint_graph_tpu/ssp/embed.py (reference
supervized_partition.py:411-434, pointnet.py:182-218):
  * LocalEmbedder: an STNkD over the first `ptn_nfeat_stn` channels of each
    point's local cloud, xy @ T, then a PointNet with no inner STN whose
    global features are [diameter, (elevation, rgb, XY, xy as
    global_feat says), (the flattened 2x2 T with stn_as_global)]; the
    output is L2-normalised;
  * SspTrainer: one step is one training-mode forward with the autograd
    graph kept, the embeddings and per-edge distances to the host for the
    loss weights (the cut pursuit in the loop), then the loss, one
    backward, an element-wise clamp of every gradient (optax.clip) and
    Adam. The three parts are separate methods (`embed_train`,
    `host_weights`, `loss_and_grads` + `apply_grads`) so a check can give
    two devices the same weights.

The model and the optimizer hold the state; the trainer runs on `device`,
default the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..device import card_unless
from ..models.pointnet import Conv1x1, PointNet, STNkD
from .losses import (SspLossConfig, compute_dist, compute_loss,
                     compute_weight_loss)

# rows a forward pass of the embedder takes at most: the reference embeds a
# whole cloud in batches of 2^16 - 1 (pointnet.py:189-218), so the
# activations' memory does not grow with the cloud
EMBED_ROWS = 2**16 - 1


@dataclasses.dataclass
class SspModelConfig:
    ptn_widths: Sequence[Sequence[int]] = ((32, 128), (34, 32, 32, 4))
    ptn_widths_stn: Sequence[Sequence[int]] = ((16, 64), (32, 16))
    ptn_nfeat_stn: int = 2
    use_rgb: bool = True
    global_feat: str = "eXYrgb"
    stn_as_global: bool = True
    ptn_norm: str = "batch"
    ptn_prelast_do: float = 0.0

    @property
    def n_feat(self) -> int:
        return 3 + 3 * int(self.use_rgb)

    @property
    def nfeat_global(self) -> int:
        n = 1  # the diameter
        if "e" in self.global_feat.replace("rgb", ""):
            n += 1
        if "rgb" in self.global_feat:
            n += 3
        if "XY" in self.global_feat:
            n += 2
        if "xy" in self.global_feat.replace("XY", ""):
            n += 2
        return n + 4 * int(self.stn_as_global)

    @property
    def n_embed(self) -> int:
        return int(self.ptn_widths[1][-1])


class LocalEmbedder(nn.Module):
    """STN + per-point PointNet -> L2-normalised embeddings."""

    def __init__(self, cfg: SspModelConfig):
        super().__init__()
        self.cfg = cfg
        self.stn = (STNkD(cfg.ptn_nfeat_stn, cfg.ptn_widths_stn[0],
                          cfg.ptn_widths_stn[1], k=2, norm=cfg.ptn_norm)
                    if cfg.ptn_nfeat_stn > 0 else None)
        # the T columns join the globals only when there is an STN
        n_global = cfg.nfeat_global - 4 * int(cfg.stn_as_global
                                              and self.stn is None)
        self.ptn = PointNet(cfg.ptn_widths[0], cfg.ptn_widths[1], (), (),
                            nfeat=cfg.n_feat, nfeat_stn=0,
                            nfeat_global=n_global,
                            prelast_do=cfg.ptn_prelast_do, norm=cfg.ptn_norm)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation after the flax initialisers: LeCun normal
        weights, zero biases, a zero STN projection, identity norms."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, Conv1x1)):
                nn.init.normal_(module.weight, 0.0,
                                1.0 / math.sqrt(module.weight.shape[1]),
                                generator=generator)
                module.bias.zero_()
        if self.stn is not None:
            self.stn.proj.weight.zero_()

    def forward(self, clouds, clouds_global, mask=None, generator=None):
        """clouds [n, k_local, C] (centred, scaled xyz + rgb), clouds_global
        [n, G] without the T columns (appended here) -> [n, n_embed]."""
        c = self.cfg
        x = clouds
        if self.stn is not None:
            t = self.stn(x[..., :c.ptn_nfeat_stn], mask)
            x = torch.cat([torch.bmm(x[..., :2], t), x[..., 2:]], -1)
            if c.stn_as_global:
                clouds_global = torch.cat([clouds_global, t.reshape(-1, 4)],
                                          1)
        emb = self.ptn(x, clouds_global, mask, generator)
        return emb / torch.sqrt((emb * emb).sum(1, keepdim=True) + 1e-12)


class SspTrainer:
    """The embedder and its optimizer on one device; each step runs one
    forward and one backward around the host's loss weights."""

    def __init__(self, model_cfg: SspModelConfig, loss_cfg: SspLossConfig,
                 lr: float = 1e-2, grad_clip: float = 1.0, seed: int = 0,
                 device=None, dtype=torch.float32):
        """`dtype` is the model's and its inputs' float type (float64 for a
        reference step in learn/train_check.py)."""
        self.device = card_unless(device)
        self.dtype = dtype
        self.model = LocalEmbedder(model_cfg)
        self.model.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.to(self.device, dtype)
        self.loss_cfg = loss_cfg
        self.grad_clip = grad_clip
        self.params = list(self.model.parameters())
        # every parameter gets a gradient, as optax updates every leaf
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.optimizer = torch.optim.Adam(self.params, lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.step = 0

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=self.dtype if dtype is None else dtype,
                               device=self.device)

    def embed_train(self, batch) -> torch.Tensor:
        """Training-mode embeddings of a collated batch, the autograd graph
        kept; the batch norms update their running statistics."""
        self.model.train()
        return self.model(self._t(batch["clouds"]),
                          self._t(batch["clouds_global"]), None,
                          self.generator)

    def host_weights(self, emb: torch.Tensor, batch):
        """(loss weights [E] f32 numpy, components, in_component) of the
        embeddings `emb`: the in-loop partition on their host copy, the
        per-edge distances computed on the device."""
        with torch.no_grad():
            diff = compute_dist(emb, self._t(batch["edg_source"], torch.int64),
                                self._t(batch["edg_target"], torch.int64),
                                self.loss_cfg.dist_type)
        return compute_weight_loss(
            self.loss_cfg, emb.detach().cpu().numpy(), batch["objects"],
            batch["edg_source"], batch["edg_target"], batch["is_transition"],
            diff.cpu().numpy(), True, batch.get("xyz"), self.device)

    def loss_and_grads(self, emb: torch.Tensor, batch, weights) -> torch.Tensor:
        """The loss of `emb` under the loss weights `weights`, divided by the
        edge count, and its backward: the gradients are left in each
        parameter's .grad, unclamped. Returns the loss, detached."""
        for p in self.params:
            p.grad.zero_()
        diff = compute_dist(emb, self._t(batch["edg_source"], torch.int64),
                            self._t(batch["edg_target"], torch.int64),
                            self.loss_cfg.dist_type)
        l1, l2 = compute_loss(self.loss_cfg, diff,
                              self._t(batch["is_transition"], torch.int32),
                              self._t(weights))
        loss = (l1 + l2) / len(weights)
        loss.backward()
        return loss.detach()

    def apply_grads(self) -> None:
        """The clamp, then Adam's update."""
        if self.grad_clip > 0:
            torch.nn.utils.clip_grad_value_(self.params, self.grad_clip)
        self.optimizer.step()
        self.step += 1

    def train_step(self, batch):
        """One optimizer step on a collated batch; (loss, the in-loop
        partition's components, in_component)."""
        emb = self.embed_train(batch)
        weights, comps, in_comp = self.host_weights(emb, batch)
        loss = self.loss_and_grads(emb, batch, weights)
        self.apply_grads()
        return float(loss), comps, in_comp

    @torch.no_grad()
    def embed(self, clouds, clouds_global) -> torch.Tensor:
        """Eval-mode embeddings (running statistics) on the device."""
        self.model.eval()
        return self.model(self._t(clouds), self._t(clouds_global))

    def embed_chunked(self, clouds, clouds_global,
                      chunk: int | None = None) -> np.ndarray:
        """embed by `embed_rows` (`chunk` rows at a time, default
        EMBED_ROWS), host numpy out."""
        if not len(clouds):
            return np.zeros((0,))
        return embed_rows(self.model, self._t(clouds),
                          self._t(clouds_global), chunk).cpu().numpy()

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


@torch.no_grad()
def embed_rows(model, clouds, clouds_global,
               rows: int | None = None) -> torch.Tensor:
    """Eval-mode embeddings of local clouds [n, k, C] with their global
    features [n, G] (tensors on the model's device), `rows` at a time
    (default EMBED_ROWS); in eval mode the rows are independent."""
    rows = rows or EMBED_ROWS
    model.eval()
    return torch.cat([model(clouds[s:s + rows], clouds_global[s:s + rows])
                      for s in range(0, len(clouds), rows)])
