"""Training and evaluation steps of the SPG segmentation model.

Port of superpoint_graph_tpu/learn/train.py (reference learning/main.py):
  * weighted cross entropy ignoring -100 targets (main.py:205, 447-452);
  * the optimizer chain in optax's order (train.py:50-67): an element-wise
    clamp of every gradient to +-grad_clip (main.py:210-212; optax.clip, not
    a norm clip), then the decayed weights added to the gradient, then sgd
    (momentum) or adam (b1 0.9, b2 0.999, eps 1e-8). torch's SGD and Adam
    with `weight_decay` add wd * p to the gradient before their update,
    which is optax's add_decayed_weights -> sgd/adam; the clamp is
    `clip_grad_value_` before `step()` (tests/test_torch_train.py holds the
    chain to optax on the same gradients);
  * MultiStepLR per epoch (main.py:172, 341, 433-437);
  * the PointNet memory monger (models/spgmodel.py) in place of the JAX
    package's `jax.checkpoint`.

The model and the optimizer hold the state (no TrainState); `Trainer`
runs on `device`, default the card, and raises without one unless the
caller names the CPU.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..device import card_unless


def make_lr_schedule(lr: float, lr_steps: Sequence[int], lr_decay: float):
    """epoch -> learning rate: lr times lr_decay for every distinct epoch of
    lr_steps that `epoch` has reached (MultiStepLR stepped once an epoch)."""
    steps = sorted({int(s) for s in lr_steps})

    def schedule(epoch: int) -> float:
        factor = 1.0
        for s in steps:
            if epoch >= s:
                factor *= lr_decay
        return lr * factor

    return schedule


def make_optimizer(params, optim: str, lr: float, momentum: float, wd: float):
    """torch.optim.SGD (momentum, no dampening or Nesterov, as optax.sgd) or
    Adam (optax.adam's defaults) with weight decay wd added to the gradient;
    the clamp comes before `step()` (Trainer.train_step)."""
    if optim == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum,
                               weight_decay=wd)
    if optim == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd)
    raise ValueError(f"unknown optimizer {optim!r}")


def weighted_ce_loss(logits, targets, class_weights=None):
    """Cross entropy ignoring -100 targets, optional per-class weights,
    normalised by the summed sample weights (torch F.cross_entropy)."""
    valid = targets != -100
    t = torch.where(valid, targets, 0)
    nll = -torch.gather(F.log_softmax(logits, -1), 1, t[:, None])[:, 0]
    w = torch.ones_like(nll) if class_weights is None else class_weights[t]
    w = torch.where(valid, w, 0.0)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1e-8)


class Trainer:
    """One model and its optimizer on one device."""

    def __init__(self, model, optim: str = "adam", lr: float = 1e-2,
                 lr_steps: Sequence[int] = (), lr_decay: float = 0.7,
                 momentum: float = 0.9, wd: float = 0.0,
                 grad_clip: float = 1.0, class_weights=None,
                 checkpoint_ptn: bool = True, seed: int = 0, device=None):
        self.device = card_unless(device)
        self.model = model.to(self.device)
        self.lr_schedule = make_lr_schedule(lr, lr_steps, lr_decay)
        self.grad_clip = grad_clip
        self.checkpoint_ptn = checkpoint_ptn
        self.class_weights = (
            None if class_weights is None
            else torch.as_tensor(class_weights, dtype=torch.float32,
                                 device=self.device))
        self.params = [p for p in self.model.parameters()]
        # every parameter gets a gradient, zeros where the loss does not
        # reach it, so adam and the weight decay touch it as optax does
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.optimizer = make_optimizer(self.params, optim, lr, momentum, wd)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.step = 0

    def set_epoch_lr(self, epoch: int) -> float:
        """The MultiStepLR rate of `epoch` on every parameter group."""
        lr = self.lr_schedule(epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return lr

    def loss_and_grads(self, batch, generator=None):
        """Training-mode forward and backward of one batch; the gradients
        are left in each parameter's .grad, unclamped, and the batch norms'
        running statistics are updated once. Returns (loss, logits)
        detached."""
        self.model.train()
        for p in self.params:
            p.grad.zero_()
        logits = self.model(
            batch, mem_monger=self.checkpoint_ptn,
            generator=self.generator if generator is None else generator)
        loss = weighted_ce_loss(logits, batch.targets, self.class_weights)
        loss.backward()
        return loss.detach(), logits.detach()

    def apply_grads(self):
        """The clamp, then the optimizer's update."""
        if self.grad_clip > 0:
            torch.nn.utils.clip_grad_value_(self.params, self.grad_clip)
        self.optimizer.step()
        self.step += 1

    def train_step(self, batch, generator=None):
        """One optimizer step; (loss, logits) as tensors on the device."""
        loss, logits = self.loss_and_grads(batch, generator)
        self.apply_grads()
        return loss, logits

    def train_steps(self, batches: Sequence, generator=None, step=None):
        """len(batches) optimizer steps, one after another. The JAX package
        groups them into one dispatch (lax.scan) to save the TPU's launch
        latency; eager torch has no dispatch to save, so this is
        `train_step` in a loop, or `step(batch)` in its place (the
        data-parallel step of parallel/dp.py). Returns (losses [K], list
        of logits)."""
        out = [self.train_step(b, generator) if step is None else step(b)
               for b in batches]
        return torch.stack([o[0] for o in out]), [o[1] for o in out]

    @torch.no_grad()
    def eval_step(self, batch):
        """(loss, logits) in eval mode (running statistics, no dropout)."""
        self.model.eval()
        logits = self.model(batch)
        return weighted_ce_loss(logits, batch.targets,
                                self.class_weights), logits

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
