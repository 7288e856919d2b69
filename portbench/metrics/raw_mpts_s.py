"""Raw points labelled per second, in millions: every raw point of every
cloud started in the window over the time until the last one ended."""


def read(rec):
    if not rec.get("clouds"):
        return None
    pts = sum(c["counts"]["raw_points"] for c in rec["clouds"])
    return pts / rec["window_s"] / 1e6
