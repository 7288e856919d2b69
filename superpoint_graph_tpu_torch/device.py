"""Device selection for the port: a CUDA card or an error, never a CPU fallback."""
from __future__ import annotations

import torch


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA device `index`, with TF32 turned off. Raises when there is no
    card: a measurement or a kernel path must not run on the CPU unnoticed.

    Distance tiles (kNN) and the model's products need full-precision f32:
    TF32 keeps about three decimal digits and drops true neighbours, as the
    JAX package's `Precision.HIGHEST` rule guards against on the TPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path needs an NVIDIA GPU")
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"CUDA device {index} requested, {torch.cuda.device_count()} present"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", index)


def card_unless(device) -> torch.device:
    """`device` as a torch.device; None means the card, `cuda_device(0)`.

    The port's entry points take `device=None` and call this first, so they
    run on the GPU unless the caller names another device (the CPU tests
    pass device="cpu"), and raise where there is no card."""
    return cuda_device(0) if device is None else torch.device(device)
