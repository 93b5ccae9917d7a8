"""Vmapped trial populations: N hyper-parameter configs as ONE call.

The reference scaled tuning out with Ray actors over a cluster
(RayTuneSearchEngine.py:28).  The JAX package makes the POPULATION a
batch dimension under ``jax.vmap``; here the same split of the configs
feeds ``torch.func.vmap``: the varying numeric hyper-parameters are
stacked into tensors on the context's device, and the whole training
function runs once over them, so N tiny trainings become batched
kernels on the card — one call, no per-trial dispatch.

The trainable's contract (``fn(cfg, **structural) -> scalar tensor``):

- it is a pure function of its inputs, written with ``torch.func``
  transforms (``torch.func.grad`` for its updates), and it updates its
  parameters out of place (``w = w - lr * g``, never ``w -= ...``);
- it calls no ``.item()``, ``float()`` or ``bool()`` on a value that
  depends on a varying leaf (vmap cannot turn a batched tensor into one
  Python number), and no ``if`` on one;
- it draws no random numbers: the population runs under
  ``torch.func.vmap(randomness="error")``, so a draw raises and the
  batch is scored as failed.  Data and initial weights come in through
  the closure or the config (made once from a seed), as the JAX
  package's trainables take explicit keys;
- varying int leaves arrive as int32 tensors and cannot size a shape;
  ``split_config`` keeps every non-numeric key constant across a batch
  and the engine groups configs by those keys.

Structural params (layer sizes, sequence lengths) are fixed per call;
numeric params (lr, init scale, regularization) vary.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np


def is_numeric_hparam(v: Any) -> bool:
    """The ONE numeric-vs-structural predicate (shared with the engine's
    vmap grouping so they cannot disagree).  bools are structural: a
    batched bool breaks Python truth tests inside the trainable."""
    return (isinstance(v, (int, float, np.floating, np.integer))
            and not isinstance(v, (bool, np.bool_)))


def split_config(configs: Sequence[Dict[str, Any]]):
    """Split configs into (stacked, const_numeric, structural).

    The calling convention is VALUE-INDEPENDENT: every numeric key
    always reaches the trainable inside its cfg dict (varying ones as
    stacked/vmapped leaves — ints keep integer dtype — constant ones as
    plain python constants), and ``**structural`` carries only
    non-numeric keys.  Raises if a non-numeric key differs (vmap cannot
    batch shape-changing params).
    """
    keys = set()
    for c in configs:
        keys.update(c)
    stacked: Dict[str, np.ndarray] = {}
    const_num: Dict[str, Any] = {}
    structural: Dict[str, Any] = {}
    for k in sorted(keys):
        vals = [c.get(k) for c in configs]
        same = all(v == vals[0] for v in vals[1:]) if len(vals) > 1 else True
        if all(is_numeric_hparam(v) for v in vals):
            if same:
                const_num[k] = vals[0]
            elif all(isinstance(v, (int, np.integer)) for v in vals):
                # keep integer semantics — but note a batched int cannot
                # size a shape; structural ints must be constant
                stacked[k] = np.asarray(vals, np.int32)
            else:
                stacked[k] = np.asarray(vals, np.float32)
        elif same:
            structural[k] = vals[0]
        else:
            raise ValueError(
                f"config key {k!r} varies across the population but is "
                f"not numeric ({vals[:3]}...); structural params must be "
                "constant within one vmapped batch — group configs by "
                "structure first (see SearchEngine backend='vmap')")
    return stacked, const_num, structural


# one wrapped callable per (train_fn, stacked keys, constants), REUSED
# across batches.  BOUNDED (LRU): each entry pins the trainable's
# closure (and the data it holds on the device), so unbounded growth
# would leak in long-lived tuning services.
_VMAP_CACHE: "collections.OrderedDict[Tuple, Any]" = collections.OrderedDict()
_VMAP_CACHE_MAX = 32


def _wrapped(train_fn, stacked_keys: Tuple[str, ...],
             const_num: Dict[str, Any], structural: Dict[str, Any]):
    from torch.func import vmap

    key = (id(train_fn), stacked_keys,
           tuple(sorted((k, repr(v)) for k, v in const_num.items())),
           tuple(sorted((k, repr(v)) for k, v in structural.items())))
    fn = _VMAP_CACHE.get(key)
    if fn is None:
        def one(leaves):
            cfg = dict(const_num)
            cfg.update(leaves)
            return train_fn(cfg, **structural)

        fn = vmap(one, randomness="error")
        _VMAP_CACHE[key] = fn
        while len(_VMAP_CACHE) > _VMAP_CACHE_MAX:
            _VMAP_CACHE.popitem(last=False)
    else:
        _VMAP_CACHE.move_to_end(key)
    return fn


def _score_list(scores) -> List[float]:
    import torch

    if isinstance(scores, torch.Tensor):
        return [float(s) for s in scores.detach().cpu().reshape(-1)]
    return [float(s) for s in np.asarray(scores).reshape(-1)]


def vmapped_trials(train_fn: Callable[..., Any],
                   configs: Sequence[Dict[str, Any]],
                   device=None) -> List[float]:
    """Run ``train_fn(cfg_dict, **structural) -> scalar score`` for
    every config as one ``torch.func.vmap`` call; returns per-trial
    scores.

    ``cfg_dict`` always carries EVERY numeric key (varying ones as
    batched scalars on ``device`` — the context's by default — and
    batch-constant ones as python constants); ``**structural`` carries
    the non-numeric keys.  ``train_fn`` keeps the contract in this
    module's docstring.
    """
    import torch

    from analytics_zoo_tpu_torch.core.context import resolve_device

    stacked, const_num, structural = split_config(list(configs))
    if not stacked:
        # degenerate population: one run, N identical results
        return _score_list(train_fn(dict(const_num), **structural)) \
            * len(configs)

    dev = resolve_device(device)
    fn = _wrapped(train_fn, tuple(sorted(stacked)), const_num, structural)
    leaves = {k: torch.as_tensor(v, device=dev) for k, v in stacked.items()}
    return _score_list(fn(leaves))
