"""nn1's share of its roofline in the profiled cloud, %: the least time
the card needs for the pairs of every nn1 call of that cloud
(harness/flops.nn1_bound_s: FP32 operations or bytes) over the device time
of the nn1 kernels (nn1_stage, nn1_scan, nn1_merge) in the trace. It counts brute-force pairs."""
import re

from portbench.harness.flops import nn1_bound_s

NN1_KERNEL = re.compile(r"\bnn1_(stage|scan|merge)\b")


def read(rec):
    t = rec.get("trace")
    if t is None or not rec.get("clouds"):
        return None
    device = sum(s for k, s in t["kernels"].items() if NN1_KERNEL.search(k))
    bound = sum(nn1_bound_s(m, n) for m, n in rec["clouds"][0]["nn1"])
    return 100.0 * bound / device if device > 0 and bound > 0 else None
