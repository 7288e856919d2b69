"""Checkpoint and resume.

The JAX package's framing (superpoint_graph_tpu/learn/checkpoint.py:19-58;
reference main.py:342-346, 390-412): a little-endian u64 header length, a
JSON header {epoch, args, scaler}, then the payload. The payload is the
port's own: `torch.save` of {model, optimizer, step} (state dicts), read
back with weights_only=True. `read_checkpoint_args` reads the header of a
file of either package; resume rebuilds the model from the checkpoint's own
args (cli/train.py), so architecture flags cannot drift.
`load_reference_checkpoint` reads the reference implementation's
`model.pth.tar` (the JAX package's learn/convert_torch.py counterpart).
"""
from __future__ import annotations

import io
import json
import os
import struct

import numpy as np
import torch


def _read_header(f) -> dict:
    (hlen,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(hlen).decode())


def save_checkpoint(path: str, state: dict, epoch: int, args: dict,
                    scaler: dict | None):
    """Write {epoch, args, scaler} and `state` ({model, optimizer, step},
    Trainer.state_dict()) to one file, atomically (model.ckpt)."""
    header = {
        "epoch": int(epoch),
        "args": args,
        "scaler": None if scaler is None
        else {k: np.asarray(v).tolist() for k, v in scaler.items()},
    }
    hb = json.dumps(header).encode()
    payload = io.BytesIO()
    torch.save(state, payload)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        f.write(payload.getbuffer())
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location=None):
    """(state, epoch, args, scaler) of a file written by save_checkpoint;
    `scaler` as numpy arrays or None."""
    with open(path, "rb") as f:
        header = _read_header(f)
        state = torch.load(io.BytesIO(f.read()), map_location=map_location,
                           weights_only=True)
    scaler = header["scaler"]
    if scaler is not None:
        scaler = {k: np.asarray(v) for k, v in scaler.items()}
    return state, header["epoch"], header["args"], scaler


def read_checkpoint_args(path: str) -> dict:
    """The args header alone (to rebuild the model before loading)."""
    with open(path, "rb") as f:
        return _read_header(f)["args"]


def load_reference_checkpoint(path: str, map_location="cpu"):
    """Read a checkpoint of the reference implementation (loicland's
    `model.pth.tar`: a torch.save of {epoch, args, state_dict, optimizer,
    scaler}, main.py:342-346) and return (args, SpgModel) with its weights.
    The port's modules carry the reference's state-dict names, so the state
    dict loads as it is. The model is built from the checkpoint's own args
    (main.py:398), as the JAX package's
    superpoint_graph_tpu/learn/convert_torch.py::load_reference_checkpoint
    does: n_classes from args.inv_class_map (13 when absent), fnet_widths
    as args gives them; the PointNet's input width, which the flax model
    infers from its input, from the state dict's first PointNet layer.
    The file is a pickle (it holds an argparse.Namespace), so read only
    checkpoints of a source you trust."""
    from ..models.spgmodel import SpgModel

    ckpt = torch.load(path, map_location=map_location, weights_only=False)
    args, sd = ckpt["args"], ckpt["state_dict"]
    model = SpgModel(
        n_classes=len(getattr(args, "inv_class_map", {})) or 13,
        model_config=args.model_config,
        ptn_widths=tuple(map(tuple, args.ptn_widths)),
        ptn_widths_stn=tuple(map(tuple, args.ptn_widths_stn)),
        ptn_nfeat=int(sd["ptn.convs.0.weight"].shape[1]),
        ptn_nfeat_stn=int(args.ptn_nfeat_stn),
        ptn_prelast_do=float(args.ptn_prelast_do),
        fnet_widths=tuple(args.fnet_widths),
        fnet_llbias=bool(args.fnet_llbias),
        fnet_bnidx=int(args.fnet_bnidx))
    model.load_state_dict(sd)
    return args, model
