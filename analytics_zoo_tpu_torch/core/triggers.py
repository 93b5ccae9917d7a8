"""Trigger algebra for ending training and for validation — the JAX
package's ``core/triggers.py``, copied (it imports no JAX).

EveryEpoch, SeveralIteration, MaxEpoch, MaxIteration, MaxScore, MinLoss,
and the And/Or combinators: pure predicates over a ``TriggerState`` of
host-side counters, evaluated by the Estimator between steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class TriggerState:
    """Host-side snapshot of training progress fed to triggers."""

    epoch: int = 0                 # completed epochs
    iteration: int = 0             # completed global steps
    epoch_finished: bool = False   # True exactly at an epoch boundary
    loss: Optional[float] = None   # most recent training loss
    score: Optional[float] = None  # most recent validation score
    records: int = 0               # samples consumed


class Trigger:
    def __call__(self, state: TriggerState) -> bool:  # pragma: no cover
        raise NotImplementedError

    def __and__(self, other: "Trigger") -> "Trigger":
        return And(self, other)

    def __or__(self, other: "Trigger") -> "Trigger":
        return Or(self, other)


class EveryEpoch(Trigger):
    """Fires at every epoch boundary."""

    def __call__(self, state: TriggerState) -> bool:
        return state.epoch_finished


class SeveralIteration(Trigger):
    """Fires every ``interval`` iterations."""

    def __init__(self, interval: int):
        if interval <= 0:
            raise ValueError("interval must be positive")
        self.interval = interval

    def __call__(self, state: TriggerState) -> bool:
        return state.iteration > 0 and state.iteration % self.interval == 0


class MaxEpoch(Trigger):
    def __init__(self, max_epoch: int):
        self.max_epoch = max_epoch

    def __call__(self, state: TriggerState) -> bool:
        return state.epoch >= self.max_epoch


class MaxIteration(Trigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = max_iteration

    def __call__(self, state: TriggerState) -> bool:
        return state.iteration >= self.max_iteration


class MaxScore(Trigger):
    """Fires once validation score reaches ``max_score``."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def __call__(self, state: TriggerState) -> bool:
        return state.score is not None and state.score >= self.max_score


class MinLoss(Trigger):
    """Fires once training loss drops to ``min_loss``."""

    def __init__(self, min_loss: float):
        self.min_loss = min_loss

    def __call__(self, state: TriggerState) -> bool:
        return state.loss is not None and state.loss <= self.min_loss


class And(Trigger):
    def __init__(self, *triggers: Trigger):
        self.triggers = triggers

    def __call__(self, state: TriggerState) -> bool:
        return all(t(state) for t in self.triggers)


class Or(Trigger):
    def __init__(self, *triggers: Trigger):
        self.triggers = triggers

    def __call__(self, state: TriggerState) -> bool:
        return any(t(state) for t in self.triggers)
