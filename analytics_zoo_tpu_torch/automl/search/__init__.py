"""Hyper-parameter search: sampling primitives, recipes, and an in-process
engine with a ray.tune-shaped API.

Reference capability: ``RayTuneSearchEngine`` (automl/search/
RayTuneSearchEngine.py:28) running trials as Ray actors over RayOnSpark,
with Bayesian optimization via tune's BayesOptSearch (:25). The JAX
package's engine on the card: a trial trains through the port's
Estimator (its steps captured CUDA graphs), so the engine runs trials
concurrently in-process (thread pool; process pool for GIL-bound host-
heavy trainables) — no second runtime to bootstrap. Concurrent trials on
one card capture their graphs one at a time (a process-wide lock,
``core/graphs.py``) and replay them side by side. The samplers are the
JAX package's, line for line (Python's ``random`` and ``math``), so the
same seed proposes the same configs in both packages.
``search_alg="tpe"`` replaces BayesOptSearch with a numpy-only TPE
sampler (search/tpe.py) whose proposals are a deterministic function of
(seed, history) — reruns at the same parallelism reproduce bit-for-bit
regardless of thread scheduling.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import math
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from analytics_zoo_tpu_torch.automl.search.space import (  # noqa: F401
    Choice, FeatureSubset, GridSearch, LogUniform, RandInt, Sampler,
    Uniform, expand_grid, finalize_config, sample_config)
from analytics_zoo_tpu_torch.automl.search.tpe import TPESampler

logger = logging.getLogger("analytics_zoo_tpu_torch.automl")


# ---------------------------------------------------------------------------
# recipes (reference time_sequence_predictor.py:37-334)
# ---------------------------------------------------------------------------

class Recipe:
    """A search space + trial budget."""

    num_samples: int = 1
    training_iteration: int = 10

    def search_space(self, all_available_features: Sequence[str]
                     ) -> Dict[str, Any]:
        raise NotImplementedError


class SmokeRecipe(Recipe):
    """Tiny space to validate the plumbing (reference SmokeRecipe)."""

    num_samples = 1
    training_iteration = 1

    def search_space(self, all_available_features):
        return {
            "selected_features": list(all_available_features),
            "past_seq_len": 2,
            "lstm_1_units": 16,
            "lstm_2_units": 16,
            "dropout": 0.2,
            "lr": 1e-3,
            "batch_size": 32,
            "epochs": 1,
        }


class RandomRecipe(Recipe):
    """Random sampling over the LSTM space (reference RandomRecipe)."""

    def __init__(self, num_rand_samples: int = 1, look_back: int = 2):
        self.num_samples = num_rand_samples
        self.training_iteration = 10
        self.look_back = look_back

    def search_space(self, all_available_features):
        return {
            "selected_features": FeatureSubset(all_available_features),
            "past_seq_len": (RandInt(self.look_back[0], self.look_back[1])
                             if isinstance(self.look_back, (tuple, list))
                             else self.look_back),
            "lstm_1_units": Choice([16, 32, 64, 128]),
            "lstm_2_units": Choice([16, 32, 64]),
            "dropout": Uniform(0.2, 0.5),
            "lr": LogUniform(1e-4, 1e-2),
            "batch_size": Choice([32, 64, 128]),
            "epochs": 5,
        }


class GridRandomRecipe(Recipe):
    """Grid over structure x random over the rest (reference
    GridRandomRecipe)."""

    def __init__(self, num_rand_samples: int = 1, look_back: int = 2):
        self.num_samples = num_rand_samples
        self.training_iteration = 10
        self.look_back = look_back

    def search_space(self, all_available_features):
        return {
            "selected_features": FeatureSubset(all_available_features),
            "past_seq_len": (RandInt(self.look_back[0], self.look_back[1])
                             if isinstance(self.look_back, (tuple, list))
                             else self.look_back),
            "lstm_1_units": GridSearch([16, 64]),
            "lstm_2_units": GridSearch([16, 64]),
            "dropout": Uniform(0.2, 0.5),
            "lr": LogUniform(1e-4, 1e-2),
            "batch_size": Choice([32, 64]),
            "epochs": 5,
        }


class MTNetSmokeRecipe(Recipe):
    """One MTNet trial with fixed hyper-parameters (reference
    MTNetSmokeRecipe, time_sequence_predictor.py:88-117).  past_seq_len
    is pinned to (long_num + 1) * time_step as MTNet's window split
    requires."""

    num_samples = 1
    training_iteration = 1

    def search_space(self, all_available_features):
        return {
            "selected_features": list(all_available_features),
            "model": "MTNet",
            "lr": 1e-3,
            "batch_size": 16,
            "epochs": 1,
            "dropout": 0.2,
            "time_step": 3,
            "long_num": 3,
            "cnn_height": 2,
            "ar_window": 2,
            "cnn_hid_size": 16,
            "rnn_hid_sizes": [8, 16],
            "past_seq_len": (3 + 1) * 3,
        }


class MTNetGridRandomRecipe(Recipe):
    """Grid over MTNet structure × random over training params; the
    grid keeps (long_num, time_step) pairs with a consistent
    past_seq_len per combo (the reference samples past_seq_len as a
    dependent RandomSample — here each grid point carries its own)."""

    def __init__(self, num_rand_samples: int = 1,
                 time_steps: Sequence[int] = (3, 4),
                 long_nums: Sequence[int] = (3, 4)):
        self.num_samples = num_rand_samples
        self.training_iteration = 10
        combos = [{"time_step": t, "long_num": n,
                   "past_seq_len": (n + 1) * t}
                  for t in time_steps for n in long_nums]
        self._combos = combos

    def search_space(self, all_available_features):
        return {
            "selected_features": list(all_available_features),
            "model": "MTNet",
            "__mtnet_shape": GridSearch(self._combos),
            "cnn_height": Choice([1, 2]),
            "cnn_hid_size": Choice([16, 32]),
            "ar_window": Choice([1, 2]),
            "dropout": Uniform(0.2, 0.5),
            "lr": LogUniform(1e-4, 1e-2),
            "batch_size": Choice([32, 64]),
            "epochs": 5,
        }


class BayesRecipe(Recipe):
    """TPE (Bayesian-optimization-style) search over the LSTM space —
    the reference's BayesRecipe (time_sequence_predictor.py, driving
    tune BayesOptSearch).  Same space as RandomRecipe; the engine's TPE
    sampler concentrates later trials around observed good regions, so
    at equal trial budget it finds better configs than random sampling.
    """

    search_alg = "tpe"

    def __init__(self, num_samples: int = 16, look_back: int = 2,
                 n_startup: Optional[int] = None):
        self.num_samples = num_samples
        self.training_iteration = 10
        self.look_back = look_back
        self.n_startup = n_startup if n_startup is not None \
            else max(4, num_samples // 4)

    def search_space(self, all_available_features):
        return RandomRecipe(1, self.look_back).search_space(
            all_available_features)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@dataclass
class TrialResult:
    config: Dict[str, Any]
    metric: float
    extra: Dict[str, Any] = field(default_factory=dict)


def _run_one_trial(trainable, fail_score: float, cfg: Dict[str, Any]
                   ) -> TrialResult:
    """One trial, exception-contained (module-level so the process
    backend can pickle it).  A failing or non-numeric-scoring trial is
    recorded as worst-possible, not fatal — one bad sampled config must
    not lose the whole search (ray.tune's failed-trial tolerance)."""
    cfg = finalize_config(cfg)
    try:
        out = trainable(dict(cfg))
        if isinstance(out, tuple):
            score, extra = out
        else:
            score, extra = out, {}
        score = float(score)
    except Exception as e:
        logger.warning("trial failed for config %s: %s", cfg, e)
        return TrialResult(cfg, fail_score, {"error": str(e)})
    return TrialResult(cfg, score, extra)


class SearchEngine:
    """Run trials over a search space, keep the best by metric.

    ``trainable(config) -> float | (float, extra_dict)`` — like a
    ray.tune trainable's final reported metric.
    """

    def __init__(self, search_space: Dict[str, Any], metric_mode: str = "min",
                 num_samples: int = 1, max_parallel: int = 1, seed: int = 42,
                 search_alg: Any = "random", backend: str = "thread",
                 n_startup: Optional[int] = None):
        """``search_alg``: "random" (i.i.d. sampling, grid dims expanded
        exhaustively), "tpe" (sequential model-based, search/tpe.py), or
        ANY object with ``propose(history) -> config`` (the pluggable
        hook — history is a list of (raw_config, score) pairs).
        ``backend``:
          - "thread" (default): trials run in threads (their device work
            releases the GIL);
          - "process": host-heavy picklable trainables;
          - "device": thread pool with each trial PINNED to one of the
            context's CUDA devices round-robin (``torch.cuda.device``) —
            K trials run on K cards concurrently, the replacement for
            the reference's Ray-actor scale-out
            (RayTuneSearchEngine.py:28); on the CPU every trial runs on
            the CPU;
          - "vmap": the whole population is ONE ``torch.func.vmap`` call
            (search/population.py) — the trainable must be a pure
            ``fn(numeric_cfg, **shared) -> score`` in the contract
            written there.
        ``n_startup``: random trials before TPE kicks in.
        """
        self.search_space = search_space
        self.metric_mode = metric_mode
        self.num_samples = num_samples
        self.max_parallel = max(1, max_parallel)
        self.seed = seed
        self.search_alg = search_alg
        self.backend = backend
        self.n_startup = n_startup
        self.results: List[TrialResult] = []

    def _configs(self) -> List[Dict[str, Any]]:
        rng = random.Random(self.seed)
        configs = []
        for grid_cfg in expand_grid(self.search_space):
            for _ in range(self.num_samples):
                configs.append(sample_config(grid_cfg, rng))
        return configs

    def _budget(self) -> int:
        return len(expand_grid(self.search_space)) * self.num_samples

    def _pool(self):
        if self.backend == "process":
            return cf.ProcessPoolExecutor(self.max_parallel)
        return cf.ThreadPoolExecutor(self.max_parallel)

    def _run_batch(self, trainable, configs) -> List[TrialResult]:
        import functools
        import pickle
        from concurrent.futures.process import BrokenProcessPool

        fail_score = float("-inf") if self.metric_mode == "max" \
            else float("inf")
        one = functools.partial(_run_one_trial, trainable, fail_score)

        if self.backend == "vmap":
            return self._run_vmap(trainable, configs, fail_score)
        if self.backend == "device":
            return self._run_device(one, configs)
        if self.max_parallel == 1 or len(configs) == 1:
            return [one(c) for c in configs]
        if self.backend == "process":
            try:
                with self._pool() as pool:
                    return list(pool.map(one, configs))
            except (AttributeError, TypeError, ImportError,
                    ModuleNotFoundError, pickle.PicklingError,
                    BrokenProcessPool, OSError) as e:
                # unpicklable trainable/results (closures, live models) or
                # a crashed worker — degrade to threads.  NOTE: trials
                # dispatched before the error may rerun; the process
                # backend is for module-level pure trainables.
                logger.warning("process pool unusable (%s); running "
                               "trials in threads", e)
        with cf.ThreadPoolExecutor(self.max_parallel) as pool:
            return list(pool.map(one, configs))

    def _run_device(self, one, configs) -> List[TrialResult]:
        """Round-robin trial→device placement over the context's CUDA
        devices: K concurrent trials occupy K cards (each trial's
        ``torch.device("cuda")`` tensors and graphs land on its pinned
        card via ``torch.cuda.device``).  A context on the CPU runs every
        trial there."""
        import contextlib

        import torch

        from analytics_zoo_tpu_torch.core.context import resolve_device

        home = resolve_device()
        if home.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [home]
        par = min(self.max_parallel, len(devices)) or 1

        def pinned(i_cfg):
            i, cfg = i_cfg
            dev = devices[i % len(devices)]
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                r = one(cfg)
            r.extra.setdefault("device", str(dev))
            return r

        if par == 1 or len(configs) == 1:
            return [pinned(ic) for ic in enumerate(configs)]
        with cf.ThreadPoolExecutor(par) as pool:
            return list(pool.map(pinned, enumerate(configs)))

    def _run_vmap(self, trainable, configs, fail_score) -> List[TrialResult]:
        """Population-as-a-batch: every config in ONE vmapped call
        (search/population.py).  Grid/structural keys must agree within
        a batch; configs are grouped by their structural signature and
        each group runs as one dispatch."""
        from analytics_zoo_tpu_torch.automl.search.population import (
            is_numeric_hparam, vmapped_trials)

        configs = [finalize_config(c) for c in configs]
        # group by structural signature (same predicate split_config
        # uses, so numpy scalars batch together instead of fragmenting)
        groups: Dict[Any, List[int]] = {}
        for i, c in enumerate(configs):
            sig = tuple(sorted((k, str(v)) for k, v in c.items()
                               if not is_numeric_hparam(v)))
            groups.setdefault(sig, []).append(i)
        results: List[Optional[TrialResult]] = [None] * len(configs)
        for idxs in groups.values():
            batch = [configs[i] for i in idxs]
            try:
                scores = vmapped_trials(trainable, batch)
            except Exception as e:
                logger.warning("vmapped batch failed (%s); scoring as "
                               "failed", e)
                for i in idxs:
                    results[i] = TrialResult(configs[i], fail_score,
                                             {"error": str(e)})
                continue
            for i, s in zip(idxs, scores):
                results[i] = TrialResult(configs[i], float(s))
        return list(results)

    def run(self, trainable: Callable[[Dict[str, Any]], Any]
            ) -> List[TrialResult]:
        if hasattr(self.search_alg, "propose"):
            self.results = self._run_tpe(trainable,
                                         sampler=self.search_alg)
        elif self.search_alg in ("tpe", "bayes", "bayesopt"):
            self.results = self._run_tpe(trainable)
        else:
            self.results = self._run_batch(trainable, self._configs())
        for i, r in enumerate(self.results):
            logger.info("trial %d/%d metric=%.6g", i + 1,
                        len(self.results), r.metric)
        return self.results

    def _run_tpe(self, trainable, sampler=None) -> List[TrialResult]:
        """Sequential model-based search in rounds of ``max_parallel``:
        propose a batch from the TPE sampler, evaluate concurrently,
        feed the scores back.  Proposals are drawn sequentially from one
        seeded rng in the driver thread, so a rerun at the same
        parallelism reproduces the exact trial sequence regardless of
        worker scheduling (within a batch, later proposals don't see
        batch-mates' scores — the standard batching tradeoff)."""
        budget = self._budget()
        if sampler is None:
            sampler = TPESampler(
                self.search_space, mode=self.metric_mode,
                n_startup=self.n_startup if self.n_startup is not None
                else max(4, budget // 4),
                seed=self.seed)
        results: List[TrialResult] = []
        history: List = []
        while len(results) < budget:
            k = min(self.max_parallel, budget - len(results))
            batch = [sampler.propose(history) for _ in range(k)]
            out = self._run_batch(trainable, batch)
            results.extend(out)
            # feed the sampler the RAW proposals (pre-finalize_config),
            # so dependent-bundle keys keep being modeled
            history.extend((raw, r.metric) for raw, r in zip(batch, out))
        return results

    def best(self) -> TrialResult:
        if not self.results:
            raise RuntimeError("run() first")
        ok = [r for r in self.results if "error" not in r.extra]
        if not ok:
            raise RuntimeError(
                f"all {len(self.results)} trials failed; first error: "
                f"{self.results[0].extra.get('error')}")
        key = (max if self.metric_mode == "max" else min)
        return key(ok, key=lambda r: r.metric)


__all__ = ["SearchEngine", "TrialResult", "Recipe", "SmokeRecipe",
           "RandomRecipe", "GridRandomRecipe", "BayesRecipe",
           "MTNetSmokeRecipe", "MTNetGridRandomRecipe", "Choice",
           "RandInt", "Uniform", "LogUniform", "GridSearch",
           "FeatureSubset", "TPESampler", "sample_config", "expand_grid",
           "finalize_config"]
