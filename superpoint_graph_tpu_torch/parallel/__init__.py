"""Distribution layer (port of superpoint_graph_tpu/parallel/): data-parallel
training over a `torch.distributed` group, one process a rank (`dp`,
`multihost`), and the partition of one cloud with its tables sharded over a
list of devices (`mesh`, `partition_shard`, `partition_big_shard`).
"""
from .dp import make_dp_eval_step, make_dp_train_step  # noqa: F401
from .mesh import make_mesh  # noqa: F401
