"""Optimizers with optax's numbers, in PyTorch.

The JAX package builds every optimizer from optax; this module rebuilds
the same chains of small transforms so the port's updates equal optax's
step for step: Adam's bias correction on ``count + 1`` with ``eps``
outside the square root, RMSprop's ``eps`` inside it, Adagrad's 0.1
initial accumulator, and every schedule read at the step count *before*
that step's increment (optax's clock, not ``LambdaLR``'s).

An ``Optimizer`` is functional, like an optax ``GradientTransformation``:

    state = opt.init(params)                    # list of tensors
    updates, state = opt.update(grads, state, params)
    params = params + updates

over tensors of one shape — the Estimator hands it the model's parameters
flattened into one f32 vector, so each transform is a few elementwise
kernels whatever the number of layers, and the NaN/Inf guard can keep or
discard a step's whole state with one ``torch.where`` per tensor.  Step
counts live on the device, so nothing here reads the host per step.
Schedules are functions of that count tensor.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

Schedule = Callable[[torch.Tensor], Union[torch.Tensor, float]]
ScheduleOrFloat = Union[float, Schedule]
State = List[torch.Tensor]


class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)``; ``state`` is a flat list of tensors."""

    def __init__(self, init: Callable[[torch.Tensor], State],
                 update: Callable[..., Tuple[torch.Tensor, State]],
                 name: str = "optimizer"):
        self.init = init
        self.update = update
        self.name = name

    def __repr__(self):
        return f"Optimizer({self.name})"


def _count(p):
    return torch.zeros((), dtype=torch.int32, device=p.device)


def chain(*parts: Optimizer, name: str = "chain") -> Optimizer:
    """Apply ``parts`` in order, each on the previous one's updates."""
    sizes: List[int] = []

    def init(p):
        states = [t.init(p) for t in parts]
        sizes[:] = [len(s) for s in states]
        return [x for s in states for x in s]

    def update(g, state, p):
        out, at = [], 0
        for t, n in zip(parts, sizes):
            g, s = t.update(g, state[at:at + n], p)
            out.extend(s)
            at += n
        return g, out

    return Optimizer(init, update, name)


# ---------------------------------------------------------------------------
# transforms (optax/_src/transform.py, one each)


def _bias_correction(moment, decay, count):
    return moment / (1 - decay ** count.to(torch.float32))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Optimizer:
    def init(p):
        return [_count(p), torch.zeros_like(p), torch.zeros_like(p)]

    def update(g, state, p):
        count, mu, nu = state
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * (g * g) + b2 * nu
        count = count + 1
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        return mu_hat / (torch.sqrt(nu_hat) + eps), [count, mu, nu]

    return Optimizer(init, update, "scale_by_adam")


def scale_by_adamax(b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> Optimizer:
    def init(p):
        return [_count(p), torch.zeros_like(p), torch.zeros_like(p)]

    def update(g, state, p):
        count, mu, nu = state
        count = count + 1
        mu = (1 - b1) * g + b1 * mu
        nu = torch.maximum(torch.abs(g) + eps, b2 * nu)
        return _bias_correction(mu, b1, count) / nu, [count, mu, nu]

    return Optimizer(init, update, "scale_by_adamax")


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0) -> Optimizer:
    def init(p):
        return [torch.full_like(p, initial_scale)]

    def update(g, state, p):
        nu = (1 - decay) * (g * g) + decay * state[0]
        return torch.rsqrt(nu + eps) * g, [nu]

    return Optimizer(init, update, "scale_by_rms")


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> Optimizer:
    def init(p):
        return [torch.full_like(p, initial_accumulator_value)]

    def update(g, state, p):
        sos = g * g + state[0]
        inv = torch.where(sos > 0, torch.rsqrt(sos + eps),
                          torch.zeros_like(sos))
        return inv * g, [sos]

    return Optimizer(init, update, "scale_by_rss")


def scale_by_adadelta(rho: float = 0.9, eps: float = 1e-6) -> Optimizer:
    def init(p):
        return [torch.zeros_like(p), torch.zeros_like(p)]

    def update(g, state, p):
        e_g, e_x = state
        e_g = (1 - rho) * (g * g) + rho * e_g
        u = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
        e_x = (1 - rho) * (u * u) + rho * e_x
        return u, [e_g, e_x]

    return Optimizer(init, update, "scale_by_adadelta")


def trace(decay: float, nesterov: bool = False) -> Optimizer:
    def init(p):
        return [torch.zeros_like(p)]

    def update(g, state, p):
        t = g + decay * state[0]
        return (g + decay * t if nesterov else t), [t]

    return Optimizer(init, update, "trace")


def add_decayed_weights(weight_decay: float = 0.0) -> Optimizer:
    def update(g, state, p):
        return g + weight_decay * p, state

    return Optimizer(lambda p: [], update, "add_decayed_weights")


def scale_by_learning_rate(lr: Schedule) -> Optimizer:
    """``-lr(count)`` times the updates, the schedule read at the count
    before this step's increment."""
    def update(g, state, p):
        (count,) = state
        step = lr(count)
        if isinstance(step, torch.Tensor):
            step = step.to(g.dtype)
        return g * -step, [count + 1]

    return Optimizer(lambda p: [_count(p)], update, "scale_by_schedule")


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def update(g, state, p):
        norm = torch.linalg.vector_norm(g)
        return torch.where(norm < max_norm, g, g / norm * max_norm), state

    return Optimizer(lambda p: [], update, "clip_by_global_norm")


def clip(max_delta: float) -> Optimizer:
    return Optimizer(lambda p: [],
                     lambda g, s, p: (torch.clamp(g, -max_delta, max_delta),
                                      s), "clip")


def multi_steps(inner: Optimizer, every_k: int) -> Optimizer:
    """``optax.MultiSteps(inner, every_k)`` (gradient accumulation), as
    the JAX Estimator wraps its optimizer for ``grad_accum_steps``.

    The state is ``[mini_step, gradient_step, acc, *inner state]``.  Each
    step folds its gradient into the f32 running mean ``acc`` (``acc +
    (g - acc) / (mini_step + 1)``) and computes the inner update from it;
    every ``every_k``-th step emits that update, advances the inner state
    and clears ``acc``, the other steps return zeros and keep the inner
    state.  The choice is a ``torch.where`` on the device counter, so no
    step reads the host.  Clipping chained into ``inner`` sees the
    accumulated mean, not each micro-batch's gradient."""
    def init(p):
        return [_count(p), _count(p), torch.zeros_like(p)] + inner.init(p)

    def update(g, state, p):
        mini, gstep, acc = state[:3]
        inner_state = state[3:]
        acc = acc + (g - acc) / (mini + 1)
        upd, new_inner = inner.update(acc, inner_state, p)
        emit = mini == every_k - 1
        new_state = [(mini + 1) % every_k,
                     torch.where(emit, gstep + 1, gstep),
                     torch.where(emit, torch.zeros_like(acc), acc)]
        new_state += [torch.where(emit, n, o)
                      for n, o in zip(new_inner, inner_state)]
        return torch.where(emit, upd, torch.zeros_like(upd)), new_state

    return Optimizer(init, update, f"multi_steps({inner.name}, {every_k})")


# ---------------------------------------------------------------------------
# schedules (optax/_src/schedule.py), functions of the int32 count tensor


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value

    def sched(count):
        c = torch.clamp(count, 0, transition_steps).to(torch.float32)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac ** power + end_value

    return sched


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps)


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def sched(count):
        c = torch.clamp(count.to(torch.float32), max=float(decay_steps))
        return init_value * (0.5 * (1 + torch.cos(math.pi * c
                                                  / decay_steps)))

    return sched


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Schedule:
    def sched(count):
        c = count.to(torch.float32)
        return torch.where(c <= 0, torch.full_like(c, init_value),
                           init_value * decay_rate ** (c / transition_steps))

    return sched


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    def value(v, count):
        # a float is filled on the device, never copied from the host, so
        # the schedule can run inside a captured step
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32)
        return torch.full((), float(v), dtype=torch.float32,
                          device=count.device)

    def sched(count):
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            out = torch.where(count < boundary, value(out, count),
                              value(s(count - boundary), count))
        return out

    return sched


def make_schedule(lr: ScheduleOrFloat, schedule: Optional[str] = None,
                  decay: float = 0.0, warmup_steps: int = 0,
                  total_steps: Optional[int] = None) -> Schedule:
    """A schedule from Keras/Zoo-style knobs, as the JAX package builds
    it: ``decay`` is Keras' ``lr / (1 + decay * iterations)``;
    ``schedule`` in {poly, cosine, exponential}; ``warmup_steps`` ramps
    linearly from 0 first."""
    if callable(lr):
        return lr
    base = float(lr)
    if schedule is None:
        if decay:
            sched = lambda count: base / (1.0 + decay * count)  # noqa: E731
        else:
            sched = constant_schedule(base)
    elif schedule in ("poly", "cosine"):
        if not total_steps:
            raise ValueError(f"{schedule} schedule needs total_steps")
        sched = (polynomial_schedule(base, 0.0, 1.0, total_steps)
                 if schedule == "poly"
                 else cosine_decay_schedule(base, total_steps))
    elif schedule == "exponential":
        sched = exponential_decay(base, 1000, 0.96)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if warmup_steps > 0:
        sched = join_schedules([linear_schedule(0.0, base, warmup_steps),
                                sched], [warmup_steps])
    return sched


# ---------------------------------------------------------------------------
# the optimizers (the JAX package's train/optimizers.py)


def Adam(lr: ScheduleOrFloat = 1e-3, beta_1: float = 0.9,
         beta_2: float = 0.999, epsilon: float = 1e-8, decay: float = 0.0,
         schedule: Optional[str] = None, warmup_steps: int = 0,
         total_steps: Optional[int] = None) -> Optimizer:
    sched = make_schedule(lr, schedule, decay, warmup_steps, total_steps)
    return chain(scale_by_adam(beta_1, beta_2, epsilon),
                 scale_by_learning_rate(sched), name="adam")


def AdamWeightDecay(lr: ScheduleOrFloat = 1e-3,
                    warmup_portion: float = -1.0, total: int = -1,
                    schedule: str = "linear", beta_1: float = 0.9,
                    beta_2: float = 0.999, epsilon: float = 1e-6,
                    weight_decay: float = 0.01) -> Optimizer:
    """BERT-style AdamW: linear warmup over ``warmup_portion * total``
    steps, then linear decay to zero at ``total``; decoupled weight
    decay."""
    if total > 0:
        warmup = int(max(warmup_portion, 0.0) * total)
        sched = join_schedules(
            [linear_schedule(0.0, float(lr), max(warmup, 1)),
             linear_schedule(float(lr), 0.0, max(total - warmup, 1))],
            [max(warmup, 1)])
    else:
        sched = make_schedule(lr)
    return chain(scale_by_adam(beta_1, beta_2, epsilon),
                 add_decayed_weights(weight_decay),
                 scale_by_learning_rate(sched), name="adamw")


def SGD(lr: ScheduleOrFloat = 0.01, momentum: float = 0.0,
        decay: float = 0.0, nesterov: bool = False,
        schedule: Optional[str] = None, warmup_steps: int = 0,
        total_steps: Optional[int] = None) -> Optimizer:
    sched = make_schedule(lr, schedule, decay, warmup_steps, total_steps)
    parts = [trace(momentum, nesterov)] if momentum else []
    return chain(*parts, scale_by_learning_rate(sched), name="sgd")


def RMSprop(lr: ScheduleOrFloat = 1e-3, rho: float = 0.9,
            epsilon: float = 1e-8, decay: float = 0.0) -> Optimizer:
    return chain(scale_by_rms(rho, epsilon),
                 scale_by_learning_rate(make_schedule(lr, decay=decay)),
                 name="rmsprop")


def Adagrad(lr: ScheduleOrFloat = 0.01) -> Optimizer:
    return chain(scale_by_rss(),
                 scale_by_learning_rate(make_schedule(lr)), name="adagrad")


def Adadelta(lr: ScheduleOrFloat = 1.0, rho: float = 0.95,
             epsilon: float = 1e-8) -> Optimizer:
    return chain(add_decayed_weights(0.0), scale_by_adadelta(rho, epsilon),
                 scale_by_learning_rate(make_schedule(lr)), name="adadelta")


def Adamax(lr: ScheduleOrFloat = 2e-3, beta_1: float = 0.9,
           beta_2: float = 0.999, epsilon: float = 1e-8) -> Optimizer:
    return chain(scale_by_adamax(beta_1, beta_2, epsilon),
                 scale_by_learning_rate(make_schedule(lr)), name="adamax")


_REGISTRY = {
    "adam": Adam,
    "adamweightdecay": AdamWeightDecay,
    "adamw": AdamWeightDecay,
    "sgd": SGD,
    "rmsprop": RMSprop,
    "adagrad": Adagrad,
    "adadelta": Adadelta,
    "adamax": Adamax,
}


def get(optimizer) -> Optimizer:
    """String → optimizer lowering (Keras names); an ``Optimizer`` passes
    through, a factory is called."""
    if isinstance(optimizer, Optimizer):
        return optimizer
    if callable(optimizer) and not isinstance(optimizer, str):
        return optimizer()
    key = str(optimizer).lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown optimizer {optimizer!r}; "
                         f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]()
