"""TPE (tree-structured Parzen estimator) sampler — Bayesian-optimization
search parity with the reference's ray.tune + BayesOpt engine
(reference automl/search/RayTuneSearchEngine.py:25,126-199, which wires
``BayesOptSearch`` into tune).

Design (the hyperopt-style independent TPE, CPU-side, numpy-only):
after ``n_startup`` seeded random trials, observations split into good
(best ``gamma`` fraction) and bad; per dimension we model densities
l(x) over good and g(x) over bad — Gaussian kernels at observed points
for numeric dims, smoothed count ratios for categorical dims, per-item
Bernoulli rates for feature subsets — then draw candidates from l and
keep the one maximizing Σ log l(x)/g(x) (numeric dims; categorical dims
take ONE stochastic draw weighted by the smoothed l/g count ratio, which
discounts merely-often-sampled arms while preserving exploration).
Proposals are a deterministic function of (seed, history), so a search
reruns bit-for-bit at the same parallelism.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Sequence, Tuple

from analytics_zoo_tpu_torch.automl.search.space import (Choice, FeatureSubset,
                                                   GridSearch, LogUniform,
                                                   RandInt, Sampler, Uniform,
                                                   sample_config)


def _gauss_logpdf(x: float, mu: float, sigma: float) -> float:
    z = (x - mu) / sigma
    return -0.5 * z * z - math.log(sigma * math.sqrt(2 * math.pi))


class _NumericDim:
    """TPE over a bounded numeric dim (optionally log-scaled / integer)."""

    def __init__(self, low: float, high: float, log: bool = False,
                 integer: bool = False):
        self.low, self.high = float(low), float(high)
        self.log = log
        self.integer = integer

    def _warp(self, v: float) -> float:
        return math.log(v) if self.log else float(v)

    def _unwarp(self, w: float) -> Any:
        v = math.exp(w) if self.log else w
        v = min(max(v, self.low), self.high)
        return int(round(v)) if self.integer else v

    def _bounds(self) -> Tuple[float, float]:
        return ((math.log(self.low), math.log(self.high)) if self.log
                else (self.low, self.high))

    def _kde_sample(self, pts: List[float], rng: random.Random) -> float:
        lo, hi = self._bounds()
        width = hi - lo or 1.0
        if not pts or rng.random() < 0.2:     # prior mass keeps exploring
            return rng.uniform(lo, hi)
        mu = pts[rng.randrange(len(pts))]
        sigma = max(width / max(len(pts), 2), 1e-6 * width)
        return min(max(rng.gauss(mu, sigma), lo), hi)

    def _kde_logpdf(self, w: float, pts: List[float]) -> float:
        lo, hi = self._bounds()
        width = hi - lo or 1.0
        base = -math.log(width)               # uniform prior component
        if not pts:
            return base
        sigma = max(width / max(len(pts), 2), 1e-6 * width)
        comps = [_gauss_logpdf(w, mu, sigma) for mu in pts]
        comps.append(base)                    # mixture with the prior
        m = max(comps)
        return m + math.log(sum(math.exp(c - m) for c in comps)
                            / len(comps))

    def propose(self, good: List[Any], bad: List[Any], rng: random.Random,
                n_candidates: int) -> Any:
        g_pts = [self._warp(v) for v in good]
        b_pts = [self._warp(v) for v in bad]
        best_w, best_score = None, -math.inf
        for _ in range(n_candidates):
            w = self._kde_sample(g_pts, rng)
            score = self._kde_logpdf(w, g_pts) - self._kde_logpdf(w, b_pts)
            if score > best_score:
                best_w, best_score = w, score
        return self._unwarp(best_w)


class _CategoricalDim:
    """TPE over a finite choice set: smoothed good/bad count ratio."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def propose(self, good: List[Any], bad: List[Any], rng: random.Random,
                n_candidates: int) -> Any:
        del n_candidates  # categorical: single stochastic draw (below)

        def key(v):
            return repr(v)

        n_vals = len(self.values)
        gcnt = {key(v): 0.0 for v in self.values}
        bcnt = dict(gcnt)
        for v in good:
            gcnt[key(v)] = gcnt.get(key(v), 0.0) + 1.0
        for v in bad:
            bcnt[key(v)] = bcnt.get(key(v), 0.0) + 1.0
        # ONE draw ∝ the smoothed l(v)/g(v) ratio — the ratio (not raw
        # good counts) discounts arms that are merely sampled often, and
        # a single stochastic draw (not argmax-of-many) preserves
        # exploration; the +1 priors keep every arm live and a 10%
        # uniform floor guarantees escape
        if rng.random() < 0.1:
            return self.values[rng.randrange(n_vals)]
        weights = [((gcnt[key(v)] + 1.0) / (len(good) + n_vals))
                   / ((bcnt[key(v)] + 1.0) / (len(bad) + n_vals))
                   for v in self.values]
        r = rng.random() * sum(weights)
        acc = 0.0
        for v, w in zip(self.values, weights):
            acc += w
            if r <= acc:
                return v
        return self.values[-1]


class _SubsetDim:
    """TPE over feature subsets: independent per-item Bernoulli rates."""

    def __init__(self, values: Sequence[str]):
        self.values = list(values)

    def propose(self, good: List[Any], bad: List[Any], rng: random.Random,
                n_candidates: int) -> List[str]:
        if not self.values:
            return []
        n_good = max(len(good), 1)
        n_bad = max(len(bad), 1)
        picked = []
        for item in self.values:
            g = sum(1 for s in good if item in s)
            b = sum(1 for s in bad if item in s)
            # smoothed inclusion odds: favor items over-represented in
            # good configs, keep a floor/ceiling for exploration
            p_good = (g + 1.0) / (n_good + 2.0)
            p_bad = (b + 1.0) / (n_bad + 2.0)
            p = min(max(p_good * 0.5 / max(p_bad, 1e-6), 0.1), 0.9)
            if rng.random() < p:
                picked.append(item)
        return picked or [self.values[rng.randrange(len(self.values))]]


def _dim_for(sampler: Sampler):
    if isinstance(sampler, FeatureSubset):
        return _SubsetDim(sampler.values)
    if isinstance(sampler, (Choice, GridSearch)):
        return _CategoricalDim(sampler.values)
    if isinstance(sampler, RandInt):
        return _NumericDim(sampler.low, sampler.high, integer=True)
    if isinstance(sampler, LogUniform):
        return _NumericDim(sampler.low, sampler.high, log=True)
    if isinstance(sampler, Uniform):
        return _NumericDim(sampler.low, sampler.high)
    return None


class TPESampler:
    """Propose configs for a search space given observed (config, metric)
    history.  ``mode``: "min" | "max"."""

    def __init__(self, space: Dict[str, Any], mode: str = "min",
                 n_startup: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: int = 42):
        self.space = space
        self.mode = mode
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self.dims = {k: _dim_for(v) for k, v in space.items()
                     if isinstance(v, Sampler)}

    def propose(self, history: List[Tuple[Dict[str, Any], float]]
                ) -> Dict[str, Any]:
        finite = [(c, m) for c, m in history if math.isfinite(m)]
        if len(finite) < self.n_startup:
            return sample_config(self.space, self.rng)
        ordered = sorted(finite, key=lambda cm: cm[1],
                         reverse=(self.mode == "max"))
        n_good = max(1, int(math.ceil(self.gamma * len(ordered))))
        good = [c for c, _ in ordered[:n_good]]
        bad = [c for c, _ in ordered[n_good:]] or good
        out = {}
        for k, v in self.space.items():
            dim = self.dims.get(k)
            if dim is None:
                out[k] = v if not isinstance(v, Sampler) \
                    else v.sample(self.rng)
                continue
            out[k] = dim.propose([c[k] for c in good if k in c],
                                 [c[k] for c in bad if k in c],
                                 self.rng, self.n_candidates)
        return out
