"""Share of the profiled cloud's wall time in which no kernel ran on the
card, %."""


def read(rec):
    t = rec.get("trace")
    if not rec.get("clouds") or t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
