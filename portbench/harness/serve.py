"""What the serving loops share: one client labelling clouds back to back
(a closed loop).

A loop kind is a file `portbench/loops/<loop>.py` whose class `Loop`
subclasses `ServeLoop` with the program's entry, its reader and the
inputs (`serve_room`, `serve_scan`). Its `setup` writes the inputs under
the run's work directory (the clouds drawn from `inputs.INPUTS_SEED`, so
that every run serves the same work), builds the model with the
benchmark's weights and labels one cloud to warm up. `window` labels
clouds until `seconds` have passed, finishing the cloud under way, and
records per cloud the program's stage seconds, the cut pursuit's host
syncs, the nn1 calls' shapes and the model's batch counts; with `trace`
the first cloud runs under torch.profiler. `check` compares, once the
window has closed, what the timed path produced with the reference
(reference/): every cloud's model input, logits, spread labels on
sampled rows and partition energy, and one cloud drawn from the seed
stage by stage.
"""
from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..reference import cloud as ref_cloud
from ..reference import loader as ref_loader
from ..reference import model as ref_model
from ..reference import partition as ref_partition
from . import compare, flops, inputs, trace
from .weights import draw_weights


@contextlib.contextmanager
def recording(module, name, calls, keep=lambda args, out: out):
    """Within: module.<name> runs as it is and appends keep(args, result)
    of each call to `calls`."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(keep(args, out))
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, orig)


def seeds_of(seed: int, n: int) -> list:
    """n 32-bit seeds drawn from the run's seed (any whole number)."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n)]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def graph_of(batch) -> dict:
    """The reference model's input: the valid nodes and edges of an
    SpgBatch that the program built (its loader's work is followed, not
    redone: PERF.md)."""
    n = int(batch.node_mask.sum())
    e = batch.edge_mask
    return {"clouds": batch.clouds[:n], "diameters": batch.clouds_global[:n, 0],
            "embeddable": batch.cloud_mask[:n], "src": batch.src[e],
            "tgt": batch.tgt[e], "edge_feats": batch.edge_feats[e]}


class ServeLoop:
    """What the two serving loops share; subclasses set the program's
    entry, its reader and the inputs."""

    n_blocks = 64  # groups of the deep check's sampled voxels

    def __init__(self, config, traffic, seed, device, workdir):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.workdir = Path(workdir)
        self.seeds = seeds_of(seed, 8)
        self.input_seeds = seeds_of(inputs.INPUTS_SEED, 8)
        self.outputs = []   # (cloud's place in the window, program result,
        #                      reader output)
        self.clouds = []    # per-cloud records
        self.voxels = {}    # the reference's voxels, by input cloud
        self.notes = {}

    # -- set-up -------------------------------------------------------
    def build_model(self):
        from superpoint_graph_tpu_torch.models.spgmodel import SpgModel

        cfg = dict(self.config["model"])
        self.weights = draw_weights(cfg, self.seeds[0], self.device)
        kw = {k: (tuple(map(tuple, v)) if k.startswith("ptn_widths")
                  else tuple(v) if k == "fnet_widths" else v)
              for k, v in cfg.items() if k != "n_classes"}
        model = SpgModel(cfg["n_classes"], **kw)
        model.load_state_dict(self.weights, strict=True)
        self.model = model.to(self.device).eval()

    # -- the window ---------------------------------------------------
    def window(self, seconds: float, traced: bool) -> dict:
        from superpoint_graph_tpu_torch.data import provider
        from superpoint_graph_tpu_torch.ops import cutpursuit_band

        nn1_calls, reads = [], []
        with recording(provider, "nn1", nn1_calls,
                       lambda a, out: (len(a[0]), len(a[1]))), \
                recording(self.entry_module(), self.reader_name, reads):
            t0 = time.perf_counter()
            deadline = t0 + seconds
            i = 0
            summary = None
            while time.perf_counter() < deadline:
                n_calls = len(nn1_calls)
                cutpursuit_band.LAST_SOLVE_STATS.clear()
                ts = time.perf_counter()
                if traced and i == 0:
                    out, summary = self.traced_call(i)
                else:
                    out = self.call(i)
                te = time.perf_counter()
                counts = flops.batch_counts(out.batch)
                self.clouds.append({
                    "times": {k: v for k, v in out.times.items()
                              if isinstance(v, float)},
                    "counts": dict(out.counts), "batch": counts,
                    "host_syncs": cutpursuit_band.LAST_SOLVE_STATS.get(
                        "host_syncs"),
                    "nn1": nn1_calls[n_calls:], "wall_s": te - ts,
                    "model_flops": flops.model_forward_flops(
                        self.config["model"], **counts)})
                self.outputs.append((i, out, reads[-1]))
                i += 1
            t_end = time.perf_counter()
        print("portbench: clouds " + json.dumps(
            [{"wall": round(c["wall_s"], 3),
              **{k: round(v, 3) for k, v in c["times"].items()}}
             for c in self.clouds]), file=sys.stderr, flush=True)
        return {"clouds": self.clouds, "attempted": len(self.clouds),
                "window_s": t_end - t0, "trace": summary}

    def traced_call(self, i):
        names = [n for _, n in self.span_patches()]
        prof = trace.profiler()
        with trace.spans(self.span_patches()):
            sync(self.device)
            t0 = time.perf_counter()
            prof.start()
            out = self.call(i)
            sync(self.device)
            prof.stop()
            wall = time.perf_counter() - t0
        return out, {"prof": prof, "names": set(names), "wall": wall}

    def release(self):
        """Free what only the program holds once the window has closed."""
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- checks -------------------------------------------------------
    def check(self, tf32: bool = False) -> dict:
        """{number: value}: every cloud's logits and spread labels, and
        the cloud drawn from the seed stage by stage. With `tf32` the
        reference computed in TF32 stands in the program's place (the
        control) for the numbers whose arithmetic has matrix products."""
        rng = np.random.RandomState(self.seeds[7])
        deep = int(rng.randint(len(self.outputs)))
        out = {"logit_err": 0.0, "spread_off": 0, "batch_off": 0,
               **self.partition_check(tf32)}
        for i, (which, res, read) in enumerate(self.outputs):
            if not tf32:  # the control's batch is the reference loader's
                out["batch_off"] += self.batch_off(res)
            ref_logits = ref_model.forward(
                self.weights, self.config["model"],
                graph_of(res.batch)).cpu().numpy()
            cand = res.logits
            if tf32:
                cand = ref_model.forward(
                    self.weights, self.config["model"], graph_of(res.batch),
                    tf32=True).cpu().numpy()
            out["logit_err"] = max(out["logit_err"],
                                   compare.logit_err(cand, ref_logits))
            out["spread_off"] += self.spread_off(which, res, rng)
            if i == deep:
                out.update(self.deep_check(which, res, read, rng, tf32))
        return out

    def batch_off(self, res) -> int:
        """The model's input against the reference loader's
        (reference/loader.py) over the program's partition."""
        part = res.partition
        want = ref_loader.batch(part.xyz, part.rgb, part.geof,
                                part.components, part.graph_sp,
                                self.point_style, self.config["loader"],
                                self.config["edge_attribs"])
        return compare.batch_off(graph_of(res.batch), want)

    def reference_voxels_of(self, i, read) -> dict:
        """`reference_voxels` of the window's i-th cloud, kept by input
        cloud."""
        c = self.cloud_of(i)
        if c not in self.voxels:
            self.voxels[c] = self.reference_voxels(i, read)
        return self.voxels[c]

    def partition_check(self, tf32: bool) -> dict:
        """The cut pursuit's result on every cloud of the window against
        the reference solver's on the reference's graph of the same
        voxels (reference/partition.py): the widest excess of the
        program's energy over the reference's, E_prog / E_ref - 1, and the
        widest ratio of the program's component count to the reference's.
        The control puts the reference's own partition in the program's
        place, which reads 0 and 1. The notes give each cloud's readings,
        and what a partition of one component a voxel would read."""
        if tf32:
            return {"cp_energy_gap": 0.0, "cp_count_over": 1.0}
        pcfg = self.partition_cfg
        reg = float(pcfg.reg_strength)
        refs = {}
        gap = over = 0.0
        for i, res, read in self.outputs:
            c = self.cloud_of(i)
            if c not in refs:
                vox = self.reference_voxels_of(i, read)
                g = ref_partition.graph(vox["xyz"], vox["rgb"], pcfg,
                                        self.device)
                comp = ref_partition.greedy(g, reg, self.device)
                refs[c] = (g, comp, ref_partition.energy(g, comp, reg),
                           len(np.unique(comp)))
                n = len(comp)
                single = ref_partition.energy(g, np.arange(n), reg)
                self.notes.setdefault("cp_singletons", []).append(
                    {"cloud": c, "cp_energy_gap": single / refs[c][2] - 1,
                     "cp_count_over": n / refs[c][3]})
            g, comp, e_ref, n_ref = refs[c]
            got = np.asarray(res.partition.in_component)
            if len(got) != len(comp):
                inf = float("inf")
                return {"cp_energy_gap": inf, "cp_count_over": inf}
            n_got = len(np.unique(got))
            e_got = ref_partition.energy(g, got, reg)
            self.notes.setdefault("cp", []).append(
                {"cloud": c, "cp_energy_gap": e_got / e_ref - 1,
                 "components": n_got, "reference_components": n_ref})
            gap = max(gap, e_got / e_ref - 1)
            over = max(over, n_got / n_ref)
        return {"cp_energy_gap": gap, "cp_count_over": over}

    def voxel_classes(self, res) -> np.ndarray:
        """The class the program gave each voxel (its superpoint's argmax
        logit), in the program's label numbering."""
        cls = np.zeros(len(res.partition.xyz), np.int64)
        best = res.logits.argmax(1)
        for c, comp in enumerate(res.partition.components):
            cls[np.asarray(comp, np.int64)] = best[c] + self.label_offset
        return cls

    def spread_off(self, which, res, rng) -> int:
        """Sampled raw points whose served label is not the class of a
        voxel nearest to them."""
        raw = self.raw_xyz(which)
        rows = rng.choice(len(raw), min(len(raw), self.sample_rows),
                          replace=False)
        ties = ref_cloud.nearest(res.partition.xyz, raw[rows], self.device)
        cls = self.voxel_classes(res)
        return int(sum(res.labels[r] not in set(cls[t].tolist())
                       for r, t in zip(rows, ties)))

    def deep_check(self, which, res, read, rng, tf32) -> dict:
        part = res.partition
        pcfg = self.partition_cfg
        vox = self.reference_voxels_of(which, read)
        out = {"prune_off": compare.prune_off(part, vox)}
        if self.has_read_check:
            out["read_off"] = self.read_off(which, read)
        m = min(len(part.xyz), len(vox["xyz"]))
        ref_xyz = vox["xyz"].astype(np.float32)
        blocks = ref_cloud.cluster_blocks(ref_xyz[:m], self.n_blocks,
                                          self.sample_rows // self.n_blocks,
                                          rng, self.device)
        rows = np.concatenate(blocks)
        k_adj = pcfg.k_nn_adj
        want = ref_cloud.knn_distances(ref_xyz, blocks, k_adj, self.device)
        got = (ref_cloud.knn_distances(ref_xyz, blocks, k_adj, self.device,
                                       tf32=True) if tf32 else
               np.sort(part.graph_nn["distances"].reshape(-1, k_adj)[rows],
                       1))
        out["knn_err"] = compare.max_abs(got, want) / pcfg.voxel_width
        g_want, usable, tie, gap = ref_cloud.geof_rows(
            ref_xyz, rows, pcfg.k_nn_geof, self.device)
        g_got = (ref_cloud.geof_rows(ref_xyz, rows, pcfg.k_nn_geof,
                                     self.device, tf32=True)[0] if tf32
                 else part.geof[rows])
        out["geof_err"] = compare.max_abs(g_got[usable], g_want[usable])
        if not tf32:
            err = np.where(usable, np.abs(g_got - g_want), 0.0)
            r, f = np.unravel_index(int(err.argmax()), err.shape)
            self.notes["geof_worst"] = {
                "row": int(rows[r]), "feature": int(f),
                "err": float(err[r, f]), "tie": float(tie[r]),
                "eig_gap": float(gap[r]),
                "usable_share": float(usable.mean())}
        src = np.asarray(part.graph_nn["source"], np.int64)
        tgt = np.asarray(part.graph_nn["target"], np.int64)
        out["partition_off"] = ref_cloud.partition_faults(
            len(part.xyz), part.components, part.in_component, src, tgt)
        se_want = ref_cloud.superedges(vox["xyz"][:len(part.xyz)],
                                       part.in_component, src, tgt)
        se_got = (ref_cloud.superedges(vox["xyz"][:len(part.xyz)],
                                       part.in_component, src, tgt, tf32=True)
                  if tf32 else compare.program_superedges(part.graph_sp))
        out["spg_off"], out["spg_err"] = compare.superedge_diff(se_got,
                                                                se_want)
        return out
