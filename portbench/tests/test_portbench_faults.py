"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run on the
CPU, at a small size of the cell's traffic, with one fault planted in the
program: an answer altered where it is produced, the cut pursuit stopped
after its first iteration (a partition far from the energy's minimum),
and the loader sampling other points. The cell's own limits
(portbench/limits/) judge it. At these sizes the scan's partition has a
handful of components, too few for its limits, which hold for the cell's
own station: the scan's stopped solver is read at the cell's size on the
card (portbench/readings.py, PERF.md).
"""
import time


from portbench import run

ROOM = {"rooms": 1, "points": 20000, "sample_rows": 256}
SCAN = {"points": 120000, "ver_batch": 50000, "sample_rows": 256}


def run_small(cell, traffic, tmp_path):
    return run.run_cell(cell, 2**31 + 12345, 0.01, False, device="cpu",
                        traffic_override=traffic, t_start=time.perf_counter(),
                        workdir=str(tmp_path))


def altered_logits(module, monkeypatch):
    orig = module.eval_step

    def eval_step(model, batch, *a, **kw):
        loss, logits = orig(model, batch, *a, **kw)
        logits = logits.clone()
        logits[0, 0] += 1.0
        return loss, logits

    monkeypatch.setattr(module, "eval_step", eval_step)


def test_room_answer_altered(monkeypatch, tmp_path):
    from superpoint_graph_tpu_torch import room

    altered_logits(room, monkeypatch)
    out = run_small("s3dis-room-serve", ROOM, tmp_path)
    assert not out["correct"]
    assert out["checks"]["logit_err"]["value"] > \
        out["checks"]["logit_err"]["limit"]


def test_scan_answer_altered(monkeypatch, tmp_path):
    from superpoint_graph_tpu_torch import pipeline, pipeline_big, scan

    # the giant-cloud path at this size
    monkeypatch.setattr(pipeline, "CHUNKED_CP_THRESHOLD", 4096)
    monkeypatch.setattr(pipeline_big, "CHUNK_POINTS", 8192)
    altered_logits(scan, monkeypatch)
    out = run_small("sema3d-scan-serve", SCAN, tmp_path)
    assert not out["correct"]
    assert out["checks"]["logit_err"]["value"] > \
        out["checks"]["logit_err"]["limit"]


def first_iteration_only(monkeypatch):
    from superpoint_graph_tpu_torch import pipeline_big
    from superpoint_graph_tpu_torch.ops import cutpursuit_band

    orig = cutpursuit_band.solve

    def solve(*args, **kwargs):
        return orig(*args, **dict(kwargs, max_iter=1))

    monkeypatch.setattr(cutpursuit_band, "solve", solve)
    monkeypatch.setattr(pipeline_big, "solve", solve)


def test_room_cut_pursuit_stopped_early(monkeypatch, tmp_path):
    first_iteration_only(monkeypatch)
    out = run_small("s3dis-room-serve", ROOM, tmp_path)
    assert not out["correct"]
    assert out["checks"]["cp_energy_gap"]["value"] > \
        out["checks"]["cp_energy_gap"]["limit"]


def test_room_loader_samples_other_points(monkeypatch, tmp_path):
    from superpoint_graph_tpu_torch import room

    orig = room.load_spg_sample

    def load_spg_sample(entry, rows, cfg, *args, **kwargs):
        return orig(entry, rows, cfg, *args, **dict(kwargs,
                                                    test_seed_offset=1))

    monkeypatch.setattr(room, "load_spg_sample", load_spg_sample)
    out = run_small("s3dis-room-serve", ROOM, tmp_path)
    assert not out["correct"]
    assert out["checks"]["batch_off"]["value"] > 0
