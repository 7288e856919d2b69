"""The loop `serve_scan`: one Semantic3D station labelled again and again
through `scan.label_scan` by one client (a closed loop)."""
from __future__ import annotations

import numpy as np

from portbench.harness import inputs
from portbench.harness.serve import ServeLoop
from portbench.reference import cloud as ref_cloud


class Loop(ServeLoop):
    """`scan.label_scan` over one station of `traffic["points"]` raw
    points, served again and again; with `traffic["labels"]` false it has
    no `.labels` sibling, as a test station."""

    reader_name = "read_semantic3d_format"
    point_style = "sema3d"
    label_offset = 1
    has_read_check = False

    def entry_module(self):
        from superpoint_graph_tpu_torch import scan
        return scan

    def setup(self):
        from superpoint_graph_tpu_torch.data.loader import LoaderConfig
        from superpoint_graph_tpu_torch.pipeline import PartitionConfig

        t = self.traffic
        self.sample_rows = int(t["sample_rows"])
        self.ver_batch = int(t["ver_batch"])
        self.partition_cfg = PartitionConfig(**self.config["partition"])
        self.loader_cfg = LoaderConfig(**self.config["loader"])
        self.path = self.workdir / "station.txt"
        xyz, _, rgb, _ = inputs.write_semantic3d_scan(
            self.path, int(t["points"]), self.input_seeds[1],
            labels=bool(t["labels"]))
        # what a reader gets back from the text: x y z with 3 decimals
        self.raw = (inputs.parsed_fixed(xyz, 3), rgb)
        self.build_model()
        self.call(0)  # warm-up

    def call(self, i):
        from superpoint_graph_tpu_torch import scan

        return scan.label_scan(str(self.path), self.model, self.device,
                               cfg=self.partition_cfg,
                               ver_batch=self.ver_batch,
                               loader_cfg=self.loader_cfg)

    def span_patches(self):
        from superpoint_graph_tpu_torch import pipeline, pipeline_big, scan

        return [(scan, "read_semantic3d_format"), (scan, "partition_cloud"),
                (pipeline, "prune_stage"), (pipeline_big, "knn_bigcloud"),
                (pipeline_big, "compute_geof"),
                (pipeline_big, "chunked_cutpursuit_device"),
                (pipeline_big, "compute_sp_graph_device"),
                (scan, "scan_batch"), (scan, "eval_step"),
                (scan, "reduced_labels2full"),
                (scan, "interpolate_labels_batch")]

    def cloud_of(self, i):
        return 0

    def raw_xyz(self, which):
        return self.raw[0]

    def reference_voxels(self, which, read):
        """The reader's chunks, each pruned on its own and concatenated."""
        xyz, rgb = self.raw
        parts = [ref_cloud.prune(xyz[s:s + self.ver_batch],
                                 self.partition_cfg.voxel_width,
                                 rgb[s:s + self.ver_batch], None, 0)
                 for s in range(0, len(xyz), self.ver_batch)]
        return {"xyz": np.concatenate([p["xyz"] for p in parts]),
                "rgb": np.concatenate([p["rgb"] for p in parts]),
                "hist": None}
