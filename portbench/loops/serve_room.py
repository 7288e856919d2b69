"""The loop `serve_room`: raw S3DIS rooms labelled back to back through
`room.label_room` by one client (a closed loop), round robin."""
from __future__ import annotations

import numpy as np

from portbench.harness import compare, inputs
from portbench.harness.serve import ServeLoop
from portbench.reference import cloud as ref_cloud


class Loop(ServeLoop):
    """`room.label_room` over `traffic["rooms"]` rooms of
    `traffic["points"]` raw points, round robin."""

    reader_name = "read_s3dis_format"
    point_style = "s3dis"
    label_offset = 0
    has_read_check = True

    def entry_module(self):
        from superpoint_graph_tpu_torch import room
        return room

    def setup(self):
        from superpoint_graph_tpu_torch.data.loader import LoaderConfig
        from superpoint_graph_tpu_torch.pipeline import PartitionConfig

        t = self.traffic
        self.sample_rows = int(t["sample_rows"])
        self.partition_cfg = PartitionConfig(**self.config["partition"])
        self.loader_cfg = LoaderConfig(**self.config["loader"])
        self.rooms = []
        for r in range(int(t["rooms"])):
            path, _, _ = inputs.write_s3dis_room(
                self.workdir / "Area_5" / f"room_{r}",
                np.random.RandomState(self.input_seeds[1 + r]),
                int(t["points"]))
            self.rooms.append(str(path))
        self.order = np.random.RandomState(self.seeds[6]).permutation(
            len(self.rooms))
        self.build_model()
        self.call(0)  # warm-up
        self.raw = {}

    def call(self, i):
        from superpoint_graph_tpu_torch import room

        return room.label_room(self.rooms[self.which(i)], self.model,
                               self.device, cfg=self.partition_cfg,
                               loader_cfg=self.loader_cfg)

    def span_patches(self):
        from superpoint_graph_tpu_torch import pipeline, room

        return [(room, "read_s3dis_format"), (room, "partition_cloud"),
                (pipeline, "_features_stage"), (pipeline, "_partition_stage"),
                (pipeline, "_spg_stage"), (room, "parsed_entries"),
                (room, "spg_entry"), (room, "load_spg_sample"),
                (room, "collate_spg"), (room, "eval_step"),
                (room, "interpolate_labels")]

    def which(self, i):
        """The room the i-th cloud of the window serves."""
        return int(self.order[i % len(self.rooms)])

    cloud_of = which

    def reference_read(self, i):
        r = self.which(i)
        if r not in self.raw:
            self.raw[r] = ref_cloud.s3dis_read(self.rooms[r])
        return self.raw[r]

    def raw_xyz(self, which):
        return self.reference_read(which)[0]

    def read_off(self, which, read) -> int:
        xyz, rgb, labels = self.reference_read(which)
        return compare.rows_off([read[0], read[1], read[2]],
                                [xyz, rgb, labels])

    def reference_voxels(self, which, read):
        xyz, rgb, labels = self.reference_read(which)
        return ref_cloud.prune(xyz, self.partition_cfg.voxel_width, rgb,
                               labels, 13)
