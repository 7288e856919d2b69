"""The loop `serve_frame`: raw vKITTI3D frames labelled back to back
through `frame.label_frame` (the learned partition, then the SPG) by one
client (a closed loop), round robin.

Besides the checks every serving loop makes (harness/serve.py), each
frame's embeddings are held to the reference embedder (reference/ssp.py)
on the program's own local clouds (`emb_err`), and those local clouds and
their global features to the reference's own (`clouds_err`; its
elevation over its own RANSAC plane, `elev_err`). The partition's energy
is taken on the reference's own graph: its float64 kNN, its local clouds
and embeddings of the reference's voxels, the edge weights of those
embeddings (`cp_energy_gap`, `cp_count_over` against the reference's
greedy solve with the cutoff fuse). The superedges are those of the
Delaunay of the program's voxels (`spg_off`, `spg_err`).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.harness import compare, frames
from portbench.harness.serve import ServeLoop, graph_of
from portbench.reference import cloud as ref_cloud
from portbench.reference import loader as ref_loader
from portbench.reference import partition as ref_partition
from portbench.reference import ssp as ref_ssp

N_LABELS = 13
# the columns of the diameter and the elevation among a voxel's global
# features (diameter, elevation, colour, XY)
DIAMETER_COL, ELEVATION_COL = 0, 1
# a voxel whose next neighbour lies within this many voxel widths of its
# last is at a tie: the program's float32 search may take either (the
# kNN check's limit), so its local cloud is not compared
TIE_WIDTHS = 1e-3
# voxels a block of the local clouds' comparison holds
CLOUD_BLOCK = 1 << 14


class Loop(ServeLoop):
    """`frame.label_frame` over `traffic["frames"]` frames of
    `traffic["points"]` raw points, round robin."""

    reader_name = "read_vkitti_format"
    point_style = "vkitti"
    label_offset = 0
    has_read_check = True

    def entry_module(self):
        from superpoint_graph_tpu_torch import frame
        return frame

    def setup(self):
        # a program without the frame path fails here, before any input
        # is written
        from superpoint_graph_tpu_torch import frame  # noqa: F401
        from superpoint_graph_tpu_torch.data.loader import LoaderConfig
        from superpoint_graph_tpu_torch.ssp.graph_processing import \
            SspPreprocessConfig
        from superpoint_graph_tpu_torch.ssp.losses import SspLossConfig

        t, c = self.traffic, self.config
        self.sample_rows = int(t["sample_rows"])
        self.structure_cfg = SspPreprocessConfig(compute_geof=False,
                                                 **c["structure"])
        self.loss_cfg = SspLossConfig(**{k: v for k, v in
                                         c["partition"].items()
                                         if k != "d_se_max"})
        self.loader_cfg = LoaderConfig(**c["loader"])
        self.frames = []
        for f in range(int(t["frames"])):
            path = self.workdir / f"frame_{f}.npy"
            frames.write_vkitti_frame(
                path, np.random.RandomState(self.input_seeds[1 + f]),
                int(t["points"]))
            self.frames.append(str(path))
        self.order = np.random.RandomState(self.seeds[6]).permutation(
            len(self.frames))
        self.build_model()
        self.build_embedder()
        self.call(0)  # warm-up
        self.raw = {}
        self.cloud_numbers = {}

    def build_embedder(self):
        from superpoint_graph_tpu_torch.ssp.embed import (LocalEmbedder,
                                                          SspModelConfig)

        cfg = dict(self.config["embedder"])
        self.emb_weights = frames.draw_embedder(cfg, self.seeds[1],
                                                self.device)
        for k in ("ptn_widths", "ptn_widths_stn"):
            cfg[k] = tuple(map(tuple, cfg[k]))
        embedder = LocalEmbedder(SspModelConfig(**cfg))
        embedder.load_state_dict(self.emb_weights, strict=True)
        self.embedder = embedder.to(self.device).eval()

    def call(self, i):
        from superpoint_graph_tpu_torch import frame

        return frame.label_frame(
            self.frames[self.which(i)], self.embedder, self.model,
            self.device, structure_cfg=self.structure_cfg,
            loss_cfg=self.loss_cfg, loader_cfg=self.loader_cfg,
            edge_attribs=self.config["edge_attribs"])

    def window(self, seconds: float, traced: bool) -> dict:
        """ServeLoop's window; each frame's `model_flops` also counts its
        voxels' embeddings (harness/frames.embedder_flops)."""
        rec = super().window(seconds, traced)
        for c in rec["clouds"]:
            c["model_flops"] += frames.embedder_flops(
                self.config["embedder"], c["counts"]["voxels"],
                self.structure_cfg.k_nn_local)
        return rec

    def span_patches(self):
        from superpoint_graph_tpu_torch import frame
        from superpoint_graph_tpu_torch.graph import spg
        from superpoint_graph_tpu_torch.ssp import generate

        return [(frame, "read_vkitti_format"), (frame, "serving_structure"),
                (generate, "graph_loader"), (generate, "embed_cloud"),
                (generate, "compute_partition"),
                (generate, "compute_sp_graph"), (spg, "Delaunay"),
                (frame, "superpoint_batch"), (frame, "eval_step"),
                (frame, "interpolate_labels")]

    def release(self):
        self.embedder = None
        super().release()

    def which(self, i):
        """The frame the i-th cloud of the window serves."""
        return int(self.order[i % len(self.frames)])

    cloud_of = which

    # -- checks -------------------------------------------------------
    def reference_read(self, i):
        f = self.which(i)
        if f not in self.raw:
            self.raw[f] = ref_ssp.read_frame(self.frames[f])
        return self.raw[f]

    def raw_xyz(self, which):
        return self.reference_read(which)[0]

    def read_off(self, which, read) -> int:
        return compare.rows_off(list(read[:3]),
                                list(self.reference_read(which)))

    def reference_voxels(self, which, read):
        xyz, rgb, labels = self.reference_read(which)
        return ref_cloud.prune(xyz, self.structure_cfg.voxel_width, rgb,
                               labels, N_LABELS)

    def check(self, tf32: bool = False) -> dict:
        """ServeLoop's numbers, `emb_err`: the widest gap of an embedding
        coordinate (the embeddings are unit vectors) between the program's
        and the reference embedder's, on the program's own local clouds of
        every frame of the window, and `clouds_err` and `elev_err`, which
        the sound check's `partition_check` reads (`cloud_gaps`)."""
        out = super().check(tf32)
        out["emb_err"] = max(self.emb_err(res, tf32)
                             for _, res, _ in self.outputs)
        # no matrix products: the control reads the program's, as prune_off
        out.update(self.cloud_numbers)
        return out

    def reference_embed(self, clouds, globals_, tf32=False) -> np.ndarray:
        return ref_ssp.embed(
            self.emb_weights, self.config["embedder"],
            torch.as_tensor(clouds, device=self.device),
            torch.as_tensor(globals_, device=self.device), tf32
        ).cpu().numpy()

    def emb_err(self, res, tf32: bool) -> float:
        s = res.embedding.sample
        want = self.reference_embed(s["clouds"], s["clouds_global"])
        got = (self.reference_embed(s["clouds"], s["clouds_global"], True)
               if tf32 else res.embedding.embeddings)
        return compare.max_abs(got, want)

    def batch_off(self, res) -> int:
        """The model's input against the reference loader's over the
        program's partition. vKITTI rows carry no geometric features: their
        l p s v columns are 0 (data/parsed.py), as the reference's rows make
        them from 0.5 - 0.5; the cell's pc_attribs select none of them."""
        part = res.partition
        want = ref_loader.batch(part.xyz, part.rgb,
                                np.full((len(part.xyz), 4), 0.5, np.float32),
                                part.components, part.graph_sp,
                                self.point_style, self.config["loader"],
                                self.config["edge_attribs"])
        return compare.batch_off(graph_of(res.batch), want)

    def reference_graph(self, vox) -> tuple:
        """(the energy's graph, the local clouds) of the reference's
        voxels: values [embeddings | spatial_emb * xyz] of its own local
        clouds (its float64 kNN, its elevation over its RANSAC plane)
        through the reference embedder, and its directed kNN edges
        weighted by those embeddings (reference/ssp.py); the clouds as
        {"clouds", "globals", "gap"} (`ref_ssp.local_clouds`)."""
        xyz64 = vox["xyz"]
        clouds, globals_, nbr, gap = ref_ssp.local_clouds(
            xyz64, vox["rgb"], ref_ssp.plane_elevation(xyz64),
            self.config["embedder"], self.structure_cfg.k_nn_local)
        emb = self.reference_embed(clouds, globals_)
        g = ref_ssp.partition_graph(
            emb, xyz64, nbr[:, :self.structure_cfg.k_nn_adj],
            self.loss_cfg.spatial_emb)
        return g, {"clouds": clouds, "globals": globals_, "gap": gap}

    def partition_check(self, tf32: bool) -> dict:
        """The learned partition of every frame of the window against the
        reference's greedy solve, with the cutoff fuse, of the reference's
        graph of the same voxels (`reference_graph`), as
        ServeLoop.partition_check: the widest E_prog / E_ref - 1 and ratio
        of the program's component count to the reference's. The control
        reads 0 and 1; the notes give each frame's readings and what one
        component a voxel would read. Fills `cloud_numbers` from the same
        local clouds."""
        if tf32:
            return {"cp_energy_gap": 0.0, "cp_count_over": 1.0}
        reg = self.loss_cfg.reg_strength / (4 * self.loss_cfg.k_nn_adj)
        refs = {}
        gap = over = clouds = elev = 0.0
        inf = float("inf")
        self.cloud_numbers = {"clouds_err": inf, "elev_err": inf}
        for i, res, read in self.outputs:
            c = self.cloud_of(i)
            if c not in refs:
                vox = self.reference_voxels_of(i, read)
                if len(vox["xyz"]) != len(res.partition.xyz):
                    return {"cp_energy_gap": inf, "cp_count_over": inf}
                g, local = self.reference_graph(vox)
                comp = ref_ssp.cutoff_fuse(
                    g, ref_partition.greedy(g, reg, self.device), reg,
                    self.loss_cfg.CP_cutoff)
                refs[c] = (g, local, ref_partition.energy(g, comp, reg),
                           len(np.unique(comp)))
                n = len(comp)
                single = ref_partition.energy(g, np.arange(n), reg)
                self.notes.setdefault("cp_singletons", []).append(
                    {"cloud": c, "cp_energy_gap": single / refs[c][2] - 1,
                     "cp_count_over": n / refs[c][3]})
            g, local, e_ref, n_ref = refs[c]
            got = np.asarray(res.partition.in_component)
            n_got = len(np.unique(got))
            e_got = ref_partition.energy(g, got, reg)
            self.notes.setdefault("cp", []).append(
                {"cloud": c, "cp_energy_gap": e_got / e_ref - 1,
                 "components": n_got, "reference_components": n_ref})
            gap = max(gap, e_got / e_ref - 1)
            over = max(over, n_got / n_ref)
            ce, ee = self.cloud_gaps(res.embedding.sample, local, c)
            clouds, elev = max(clouds, ce), max(elev, ee)
        self.cloud_numbers = {"clouds_err": clouds, "elev_err": elev}
        return {"cp_energy_gap": gap, "cp_count_over": over}

    def cloud_gaps(self, sample, local, which) -> tuple:
        """(clouds_err, elev_err) of the program's sample of a frame
        against the reference's local clouds of it: the widest gap, over
        the voxels not at a tie (TIE_WIDTHS), between the program's and
        the reference's local cloud of a voxel as sets of rows (the
        Hausdorff distance in the max norm: the embedder pools over a
        cloud's points, so their order is free) and of their global
        features but the elevation (colour and XY over every voxel); and
        the widest gap of the elevation (m) over every voxel. The notes
        give the voxels at a tie."""
        got, want = sample["clouds"], local["clouds"]
        if got.shape != want.shape:
            return float("inf"), float("inf")
        keep = local["gap"] >= TIE_WIDTHS * self.structure_cfg.voxel_width
        self.notes.setdefault("clouds_ties", []).append(
            {"cloud": which, "voxels": int((~keep).sum())})
        rows = np.flatnonzero(keep)
        err = 0.0
        for s in range(0, len(rows), CLOUD_BLOCK):
            r = rows[s:s + CLOUD_BLOCK]
            a = torch.as_tensor(got[r], device=self.device)
            b = torch.as_tensor(want[r], device=self.device)
            d = (a[:, :, None] - b[:, None]).abs().amax(-1)
            err = max(err, float(d.amin(2).amax()), float(d.amin(1).amax()))
        g_got, g_want = sample["clouds_global"], local["globals"]
        glob = np.abs(g_got - g_want)
        glob[~keep, DIAMETER_COL] = 0.0
        glob[:, ELEVATION_COL] = 0.0
        return (max(err, float(glob.max())),
                float(np.abs(g_got[:, ELEVATION_COL]
                             - g_want[:, ELEVATION_COL]).max()))

    def deep_check(self, which, res, read, rng, tf32) -> dict:
        """The frame drawn from the seed stage by stage: its reader's rows,
        its voxels, the kNN distances of sampled voxels, and the superedges
        of the Delaunay of the program's voxels (a triangulation of
        near-degenerate voxel means can move with one rounding of an input,
        so the reference triangulates the program's float32 voxels and
        takes the features from its own float64 ones)."""
        part = res.partition
        vox = self.reference_voxels_of(which, read)
        out = {"read_off": self.read_off(which, read),
               "prune_off": compare.prune_off(part, vox)}
        m = min(len(part.xyz), len(vox["xyz"]))
        ref_xyz = vox["xyz"].astype(np.float32)
        blocks = ref_cloud.cluster_blocks(ref_xyz[:m], self.n_blocks,
                                          self.sample_rows // self.n_blocks,
                                          rng, self.device)
        rows = np.concatenate(blocks)
        k_adj = self.structure_cfg.k_nn_adj
        want = ref_cloud.knn_distances(ref_xyz, blocks, k_adj, self.device)
        got = (ref_cloud.knn_distances(ref_xyz, blocks, k_adj, self.device,
                                       tf32=True) if tf32 else
               np.sort(part.graph_nn["distances"].reshape(-1, k_adj)[rows],
                       1))
        out["knn_err"] = (compare.max_abs(got, want)
                          / self.structure_cfg.voxel_width)
        src, tgt = ref_ssp.delaunay_edges(
            part.xyz, self.config["partition"]["d_se_max"])
        xyz64 = vox["xyz"][:len(part.xyz)]
        se_want = ref_cloud.superedges(xyz64, part.in_component, src, tgt)
        se_got = (ref_cloud.superedges(xyz64, part.in_component, src, tgt,
                                       tf32=True)
                  if tf32 else compare.program_superedges(part.graph_sp))
        out["spg_off"], out["spg_err"] = compare.superedge_diff(se_got,
                                                                se_want)
        return out
