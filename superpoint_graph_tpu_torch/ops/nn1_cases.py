"""Adversarial clouds for checking the nn1 kernel against nn1_plain.

Shared by chip_smoke.py's adversarial phase and the nn1 tests
(tests/test_torch_nn1.py on the CPU, tests/test_torch_cuda.py on the card).
numpy only; nothing here runs at import time.
"""
from __future__ import annotations

import numpy as np


def nn1_cases(seed: int, n_db: int, n_q: int) -> dict:
    """Adversarial (db, queries) float32 pairs for nn1, made with numpy:
    an 8 x 6 x 3 m box at the origin and offset by 1e3 m, queries that equal
    db points or lie near them, pairs of db points a few float32 ulps from
    equidistant to a query (at both scales), and points duplicated across
    the db (so across tiles and splits). Sizes are whatever the caller
    gives, so they need not be multiples of any tile."""
    rng = np.random.RandomState(seed)
    box = np.array([8.0, 6.0, 3.0])

    def cloud(k, offset):
        return (rng.rand(k, 3) * box + offset).astype(np.float32)

    def near_copies(db, k, sigma):
        q = db[rng.randint(0, len(db), k)]
        return (q + sigma * rng.randn(k, 3)).astype(np.float32)

    cases = {}
    for name, offset in (("room", 0.0), ("offset_1e3", 1e3)):
        db = cloud(n_db, offset)
        k = n_q // 4
        q = np.concatenate([db[rng.randint(0, n_db, k)],
                            near_copies(db, k, 1e-3),
                            cloud(n_q - 2 * k, offset)])
        cases[name] = (db, q)
        # near-ties: for each of some queries, two db points whose offsets
        # are the same vector with its components permuted and nudged by
        # 0-3 ulps, written at random places in the db
        db = db.copy()
        q = cloud(n_q, offset)
        n_tie = min(n_q, n_db // 4)
        v = (0.004 + 0.01 * rng.rand(n_tie, 3)).astype(np.float32)
        v *= rng.choice([-1, 1], (n_tie, 3))
        w = v[:, rng.permutation(3)]
        for _ in range(3):
            nudge = rng.rand(n_tie, 3) < 0.5
            w = np.where(nudge, np.nextafter(w, np.float32(np.inf)), w)
        slots = rng.permutation(n_db)[:2 * n_tie]
        db[slots[:n_tie]] = q[:n_tie] + v
        db[slots[n_tie:]] = q[:n_tie] + w
        cases[f"near_ties_{name}"] = (db, q)
    base = cloud(max(1, n_db // 3), 0.0)
    db = np.concatenate([base, base[rng.permutation(len(base))],
                         cloud(n_db - 3 * len(base), 0.0), base])[:n_db]
    q = np.concatenate([base[rng.randint(0, len(base), n_q // 2)],
                        near_copies(base, n_q - n_q // 2, 1e-3)])
    cases["duplicates"] = (db, q)
    # one point repeated: every query ties with every db point, and every
    # chunk goes to the exact re-check
    k = min(n_db, 4099)
    cases["one_point"] = (np.repeat(cloud(1, 0.0), k, 0), q)
    return cases
