"""Search-space sampling primitives (tune.choice / randint / uniform /
grid_search equivalents) shared by the random engine and the TPE sampler."""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

# ---------------------------------------------------------------------------
# sampling primitives (tune.choice / randint / uniform / grid_search)
# ---------------------------------------------------------------------------

class Sampler:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Choice(Sampler):
    values: Sequence[Any]

    def sample(self, rng):
        return rng.choice(list(self.values))


@dataclass
class RandInt(Sampler):
    low: int
    high: int    # inclusive

    def sample(self, rng):
        return rng.randint(self.low, self.high)


@dataclass
class Uniform(Sampler):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Sampler):
    low: float
    high: float

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclass
class GridSearch(Sampler):
    """Expanded exhaustively (cartesian with other GridSearch dims)."""

    values: Sequence[Any]


def sample_config(space: Dict[str, Any], rng: random.Random) -> Dict[str, Any]:
    out = {}
    for k, v in space.items():
        if isinstance(v, GridSearch):
            out[k] = rng.choice(list(v.values))
        elif isinstance(v, Sampler):
            out[k] = v.sample(rng)
        else:
            out[k] = v
    return out


def expand_grid(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cartesian product over GridSearch dims (non-grid dims untouched)."""
    grid_keys = [k for k, v in space.items() if isinstance(v, GridSearch)]
    if not grid_keys:
        return [dict(space)]
    combos = itertools.product(*[space[k].values for k in grid_keys])
    out = []
    for combo in combos:
        d = dict(space)
        d.update(dict(zip(grid_keys, combo)))
        out.append(d)
    return out



@dataclass
class FeatureSubset(Sampler):
    """Random non-empty subset of generated features (the reference's
    per-feature Choice([0,1]) encoding, RayTuneSearchEngine.py)."""

    values: Sequence[str]

    def sample(self, rng):
        vals = list(self.values)
        if not vals:
            return []
        picked = [v for v in vals if rng.random() < 0.5]
        return picked or [rng.choice(vals)]




def finalize_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve a sampled config for the trainable: dict-valued ``__*``
    keys are dependent-parameter bundles (e.g. MTNet's (time_step,
    long_num, past_seq_len) triple, which must stay consistent) and are
    flattened into the config."""
    out = {}
    for k, v in cfg.items():
        if k.startswith("__") and isinstance(v, dict):
            out.update(v)
        else:
            out[k] = v
    return out
