"""Whole clouds' share of the card's FP32 peak, %: the operations every
cloud of the window needs (the model's forward pass from its batch's
shapes, and nn1's 6 a brute-force pair) over the clouds' wall time, over
67 TFLOP/s (TF32 is off)."""
from portbench.harness.flops import FP32_FLOPS, nn1_flops
from portbench.harness.readers import timed_clouds


def read(rec):
    clouds = timed_clouds(rec)
    if not rec.get("clouds") or not clouds:
        return None
    ops = sum(c["model_flops"] + sum(nn1_flops(m, n) for m, n in c["nn1"])
              for c in clouds)
    return 100.0 * ops / sum(c["wall_s"] for c in clouds) / FP32_FLOPS
