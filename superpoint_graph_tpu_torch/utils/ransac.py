"""RANSAC fit of a plane z = a*x + b*y + c, host numpy + scipy.

The port's own copy of what `sklearn.linear_model.RANSACRegressor(
random_state=0)` with its default `LinearRegression` does (sklearn
linear_model/_ransac.py `fit`, utils/_random.pyx
`sample_without_replacement`), which the JAX package calls for the plane
elevation (data/parsed.py `elevation_plane`, ssp/graph_processing.py
`build_supervision_structure`). sklearn is not imported: the card's
machine has none.

The same steps in the same dtype (a float32 cloud stays float32, as
sklearn keeps it): residual threshold = the MAD of y; 100 trials at most,
cut by the dynamic bound at stop probability 0.99; each trial draws 3
indices from one RandomState(0) by sklearn's "auto" sampler (tracking
selection below a 0.01 ratio, a permutation up to 0.99, reservoir
sampling above), fits them by least squares (centred, scipy's gelsd,
cond 1e-6), and counts inliers by absolute residual; a trial wins with
more inliers, or as many and an R^2 no lower; the winner's inliers are
refitted.
"""
from __future__ import annotations

import numpy as np
from scipy import linalg

MAX_TRIALS = 100
STOP_PROBABILITY = 0.99
_EPSILON = np.spacing(1)


def _sample(n: int, k: int, rs: np.random.RandomState) -> np.ndarray:
    """k distinct integers of [0, n) drawn as sklearn's
    sample_without_replacement(method="auto") draws them."""
    ratio = k / n if n != 0 else 1.0
    if 0.01 < ratio < 0.99:
        return rs.permutation(n)[:k]
    out = np.empty(k, dtype=int)
    if ratio < 0.2:  # tracking selection
        selected = set()
        for i in range(k):
            j = rs.randint(n)
            while j in selected:
                j = rs.randint(n)
            selected.add(j)
            out[i] = j
        return out
    out[:] = np.arange(k)  # reservoir sampling
    for i in range(k, n):
        j = rs.randint(0, i + 1)
        if j < k:
            out[j] = i
    return out


class _Plane:
    """LinearRegression(fit_intercept=True) for one target."""

    def fit(self, X, y):
        x_off = X.mean(0).astype(X.dtype)
        y_off = np.asarray(y.mean(0))
        coef = linalg.lstsq(X - x_off, y - y_off, cond=1e-6)[0]
        self.coef = np.ravel(coef).astype(X.dtype)
        self.intercept = y_off - x_off @ self.coef
        return self

    def predict(self, X):
        return X @ self.coef + self.intercept

    def score(self, X, y) -> float:
        """R^2 as sklearn's r2_score computes it (force_finite)."""
        y_true = y.reshape(-1, 1)
        y_pred = self.predict(X).reshape(-1, 1)
        if len(y_true) < 2:
            return float("nan")
        num = ((y_true - y_pred) ** 2).sum(0)
        den = ((y_true - np.average(y_true, axis=0)) ** 2).sum(0)
        score = np.ones(1, dtype=num.dtype)
        valid = (den != 0) & (num != 0)
        score[valid] = 1 - num[valid] / den[valid]
        score[(num != 0) & (den == 0)] = 0.0
        return float(np.average(score))


def _dynamic_max_trials(n_inliers, n_samples, min_samples, probability):
    inlier_ratio = n_inliers / float(n_samples)
    nom = max(_EPSILON, 1 - probability)
    denom = max(_EPSILON, 1 - inlier_ratio ** min_samples)
    if nom == 1:
        return 0
    if denom == 1:
        return float("inf")
    return abs(float(np.ceil(np.log(nom) / np.log(denom))))


def ransac_plane(X: np.ndarray, y: np.ndarray, seed: int = 0):
    """The plane RANSACRegressor(random_state=seed).fit(X, y) finds, for
    X [n, 2] and y [n]; returns an object whose `predict(X)` gives z."""
    X = np.asarray(X)
    y = np.asarray(y)
    n = X.shape[0]
    min_samples = X.shape[1] + 1
    if min_samples > n:
        raise ValueError(f"{n} points: a plane needs {min_samples}")
    threshold = np.median(np.abs(y - np.median(y)))
    rs = np.random.RandomState(seed)
    plane = _Plane()
    n_best, score_best, best = 1, -np.inf, None
    trials, max_trials = 0, MAX_TRIALS
    while trials < max_trials:
        trials += 1
        subset = _sample(n, min_samples, rs)
        plane.fit(X[subset], y[subset])
        inliers = np.abs(y - plane.predict(X)) <= threshold
        n_in = int(np.sum(inliers))
        if n_in < n_best:
            continue
        idx = np.arange(n)[inliers]
        score = plane.score(X[idx], y[idx])
        if n_in == n_best and score < score_best:
            continue
        n_best, score_best, best = n_in, score, idx
        max_trials = min(max_trials, _dynamic_max_trials(
            n_best, n, min_samples, STOP_PROBABILITY))
    if best is None:
        raise ValueError("RANSAC found no consensus set")
    return _Plane().fit(X[best], y[best])


def plane_elevation(xyz: np.ndarray) -> np.ndarray:
    """z above the RANSAC plane of the points within 0.5 of the lowest z
    (s3dis_dataset.py:127-133 of the reference)."""
    low = np.flatnonzero(xyz[:, 2] - xyz[:, 2].min() < 0.5)
    return xyz[:, 2] - ransac_plane(xyz[low, :2], xyz[low, 2]).predict(
        xyz[:, :2])
