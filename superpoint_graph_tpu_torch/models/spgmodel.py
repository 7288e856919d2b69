"""The flagship SPG segmentation model: PointNet superpoint embedder feeding
the ECC-GRU graph network (reference create_model, learning/main.py:414-431).

Port of superpoint_graph_tpu/models/spgmodel.py. Batches are one padded
disconnected union of superpoint graphs (`SpgBatch`, torch tensors).
Unlike flax's Dense, torch layers need their input widths: `ptn_nfeat` is
the number of point channels the loader emits
(data/loader.py::pc_attrib_dims, 14 for the default "xyzrgbelpsvXYZ") and
sizes the conv stack; the STN sees the first `ptn_nfeat_stn` of them.

Training mode: batch norms on batch statistics, dropout masks from the
generator the caller passes, and optionally the reference's PointNet memory
monger (`ptn_mem_monger`, pointnet.py:160-180; the JAX package's
`jax.checkpoint`, learn/train.py:150-153): torch.utils.checkpoint around the
embedder, whose replay in backward neither updates the running statistics
again nor draws new dropout masks (`_monger_contexts`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .graphnet import GraphNetwork
from .norm import recomputing
from .pointnet import Conv1x1, PointNet


@dataclasses.dataclass
class SpgBatch:
    """Padded batch of superpoint graphs (one disconnected union)."""

    clouds: torch.Tensor         # [n_sp, n_pts, C] sampled point sets
    clouds_global: torch.Tensor  # [n_sp, G] global features (diameter)
    cloud_mask: torch.Tensor     # [n_sp] bool: embeddable (>= ptn_minpts)
    node_mask: torch.Tensor      # [n_sp] bool: real superpoint (vs padding)
    targets: torch.Tensor        # [n_sp] int64 class, -100 = ignore
    target_size: torch.Tensor    # [n_sp, n_classes+1] GT histogram
    src: torch.Tensor            # [n_edges] int64 superedge source
    tgt: torch.Tensor            # [n_edges] int64 superedge target
    edge_feats: torch.Tensor     # [n_edges, F]
    edge_mask: torch.Tensor      # [n_edges] bool
    # edge-feature compaction: the fnet runs once per unique feature row
    edge_feat_uniq: Optional[torch.Tensor] = None  # [n_uniq, F]
    edge_feat_idx: Optional[torch.Tensor] = None   # [n_edges] -> uniq row
    edge_uniq_mask: Optional[torch.Tensor] = None  # [n_uniq] bool


def _monger_contexts(generator: Optional[torch.Generator]):
    """context_fn of torch.utils.checkpoint: the forward notes the
    generator's state; the replay in backward runs under `recomputing()`
    from that state (the same dropout masks), then puts the generator back
    where the forward left it."""
    saved = {}

    @contextlib.contextmanager
    def forward():
        if generator is not None:
            saved["state"] = generator.get_state()
        yield

    @contextlib.contextmanager
    def replay():
        after = None
        if generator is not None:
            after = generator.get_state()
            generator.set_state(saved["state"])
        try:
            with recomputing():
                yield
        finally:
            if generator is not None:
                generator.set_state(after)

    return forward(), replay()


class SpgModel(nn.Module):
    """ptn + ecc, with the reference CLI's hyper-parameters."""

    def __init__(
        self,
        n_classes: int,
        model_config: str = "gru_10_0,f_13",
        ptn_widths: Sequence[Sequence[int]] = ((64, 64, 128, 128, 256),
                                               (256, 64, 32)),
        ptn_widths_stn: Sequence[Sequence[int]] = ((64, 64, 128), (128, 64)),
        ptn_nfeat: int = 14,
        ptn_nfeat_stn: int = 11,
        ptn_nfeat_global: int = 1,
        ptn_prelast_do: float = 0.0,
        fnet_widths: Sequence[int] = (13, 32, 128, 64),
        fnet_orthoinit: bool = True,
        fnet_llbias: bool = False,
        fnet_bnidx: int = 2,
    ):
        super().__init__()
        # the names learn/convert_torch.py::convert_state_dict reads
        self.n_classes = n_classes
        self.model_config = model_config
        self.ptn_widths = ptn_widths
        self.ptn_widths_stn = ptn_widths_stn
        self.ptn_nfeat_stn = ptn_nfeat_stn
        self.ptn_prelast_do = ptn_prelast_do
        self.fnet_widths = fnet_widths
        self.fnet_orthoinit = fnet_orthoinit
        self.fnet_bnidx = fnet_bnidx
        self.ptn = PointNet(
            ptn_widths[0], ptn_widths[1], ptn_widths_stn[0], ptn_widths_stn[1],
            nfeat=ptn_nfeat, nfeat_stn=ptn_nfeat_stn,
            nfeat_global=ptn_nfeat_global, prelast_do=ptn_prelast_do,
        )
        self.ecc = GraphNetwork(model_config, int(ptn_widths[1][-1]),
                                fnet_widths, fnet_llbias, fnet_bnidx)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded initialisation after the flax model's initialisers: LeCun
        normal weights, zero biases, orthogonal fnet weights (gain sqrt(2)
        on hidden layers), a zero STN projection, identity batch norms."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, Conv1x1)):
                nn.init.normal_(module.weight, 0.0,
                                1.0 / math.sqrt(module.weight.shape[1]),
                                generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
        for name, p in self.named_parameters():
            if name.endswith(("weight_ih", "weight_hh")):
                nn.init.normal_(p, 0.0, 1.0 / math.sqrt(p.shape[1]),
                                generator=generator)
        if self.fnet_orthoinit:
            for name, module in self.named_modules():
                if name.endswith("_fnet"):
                    lins = [m for m in module if isinstance(m, nn.Linear)]
                    for i, lin in enumerate(lins):
                        gain = 1.0 if i == len(lins) - 1 else math.sqrt(2.0)
                        nn.init.orthogonal_(lin.weight, gain=gain,
                                            generator=generator)
        if self.ptn.stn is not None:
            self.ptn.stn.proj.weight.zero_()

    def forward(self, batch: SpgBatch,
                generator: Optional[torch.Generator] = None,
                mem_monger: bool = False) -> torch.Tensor:
        """Logits [n_sp, n_classes]. `generator` draws the dropout masks in
        training mode; `mem_monger` recomputes the PointNet's activations
        in backward instead of keeping them (training with autograd)."""
        args = (batch.clouds, batch.clouds_global, batch.cloud_mask, generator)
        if mem_monger and self.training and torch.is_grad_enabled():
            emb = checkpoint(self.ptn, *args, use_reentrant=False,
                             context_fn=lambda: _monger_contexts(generator))
        else:
            emb = self.ptn(*args)
        emb = torch.where(batch.cloud_mask[:, None], emb, 0.0)
        if batch.edge_feat_uniq is not None:
            ef, idx, fnet_mask = (batch.edge_feat_uniq, batch.edge_feat_idx,
                                  batch.edge_uniq_mask)
        else:
            ef, idx, fnet_mask = batch.edge_feats, None, batch.edge_mask
        return self.ecc(emb, ef, batch.src, batch.tgt, batch.edge_mask,
                        node_mask=batch.node_mask, edge_feat_idx=idx,
                        fnet_mask=fnet_mask, generator=generator)
