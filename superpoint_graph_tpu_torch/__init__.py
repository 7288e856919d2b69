"""superpoint_graph_tpu_torch — the PyTorch / CUDA port of superpoint_graph_tpu.

The JAX package ``superpoint_graph_tpu`` stays the reference; this package
mirrors its layout (``ops/``, ``graph/``, ``data/``, ``models/``, ``learn/``)
so each module's counterpart is easy to find, and adds ``csrc/`` for the CUDA
kernels written by hand for Hopper (sm_90a).

It imports ``torch`` and never ``jax`` or ``flax``. Device stages take an
explicit ``device``; on a CPU tensor each kernel wrapper runs its plain torch
version, on a CUDA tensor it launches its kernel or raises.

First slice (serving path of the S3DIS recipe):
raw room + Annotations (nn1 kernel) -> voxel prune -> kNN + geometric features
-> exact cut pursuit -> superpoint graph -> superpoint point sets -> ECC-GRU
logits -> labels spread back to the raw points (nn1 kernel).
"""

__version__ = "0.1.0"
