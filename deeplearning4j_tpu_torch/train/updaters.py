"""Updaters / optimizers (counterpart: ``deeplearning4j_tpu/train/
updaters.py``; ref: org.nd4j.linalg.learning.config.* dataclasses +
org.nd4j.linalg.learning.*Updater fused-update implementations).

Each updater is a JSON-serializable dataclass. The reference lowers it to
an ``optax.GradientTransformation``; the port has no optax, so
:meth:`Updater.to_transform` gives the port's own :class:`GradientTransformation`,
an ``(init, update)`` pair over trees of tensors (lists, dicts, tuples),
with optax's arithmetic and defaults (adagrad's initial accumulator 0.1,
rmsprop's initial scale 0, adadelta's learning rate 1.0, adamw's
decoupled decay added to the Adam direction before the learning rate
scales it, nadam's and amsgrad's bias corrections, ``set_to_zero``).

The state is optax's: a tuple over the chained transforms of NamedTuples
with optax's field names, so :func:`tree_leaves` of it lists the leaves in
the order ``jax.tree_util.tree_leaves`` lists the reference's (dict keys
sorted) — the order of ``updaterState.npz``. Step counts are int32 0-d
tensors on the host: bias corrections and schedules are computed from
them in Python doubles (the reference's values under its 64-bit mode) and
join each leaf in its dtype, without a read from the device.

Learning rates accept a float or a Schedule (train/schedules.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Union

import torch

from deeplearning4j_tpu_torch.ops.pallas_updaters import tree_leaves
from deeplearning4j_tpu_torch.train import schedules as _sched

LrType = Union[float, _sched.Schedule]

_INT32_MAX = 2 ** 31 - 1


# ------------------------------------------------------------------ trees


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and the same places of each
    tree in ``rest``), keeping dicts, lists, tuples and NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` in :func:`tree_leaves`
    order (dict keys sorted) — the inverse of ``tree_leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


# ---------------------------------------------------------------- optax's


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params=None) ->
    (updates, state)`` (optax's pair)."""
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor


class TraceState(NamedTuple):
    trace: Any


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any


class ScaleByAmsgradState(NamedTuple):
    count: torch.Tensor
    mu: Any
    nu: Any
    nu_max: Any


class ScaleByRssState(NamedTuple):
    sum_of_squares: Any


class ScaleByAdaDeltaState(NamedTuple):
    e_g: Any
    e_x: Any


class ScaleByRmsState(NamedTuple):
    nu: Any


def _count0():
    return torch.zeros((), dtype=torch.int32)


def _inc(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment``: +1, held at the int32 maximum."""
    return torch.tensor(min(int(count) + 1, _INT32_MAX), dtype=torch.int32)


def true_div(t: torch.Tensor, v) -> torch.Tensor:
    """t / v rounded once, as the reference divides: v as a tensor of t's
    dtype on t's device, since CUDA multiplies a tensor by the reciprocal
    of a Python number instead of dividing by it. The 0-d divisor is
    filled on the device (``torch.as_tensor(v, device=...)`` copies from
    pageable memory, which waits for the card, twice a leaf a step)."""
    if isinstance(v, torch.Tensor):
        return t / v.to(dtype=t.dtype, device=t.device)
    return t / torch.full((), v, dtype=t.dtype, device=t.device)


def rtrue_div(v, t: torch.Tensor) -> torch.Tensor:
    """v / t rounded once (``v / t`` in torch is a reciprocal times v),
    the 0-d numerator filled on t's device."""
    return torch.full((), v, dtype=t.dtype, device=t.device) / t


def _bias(moment, decay: float, count: int):
    """optax's ``tree_bias_correction``: 1 - decay^count in doubles, then
    each leaf divided by it in the leaf's dtype."""
    bc = 1 - decay ** count
    return tree_map(lambda t: true_div(t, bc), moment)


def _moment(g, t, decay, order):
    """(1 - decay) g^order + decay t (``tree_update_moment``)."""
    return (1 - decay) * (g if order == 1 else g * g) + decay * t


def chain(*txs) -> GradientTransformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def identity() -> GradientTransformation:
    return GradientTransformation(lambda p: EmptyState(),
                                  lambda u, s, p=None: (u, s))


def scale(step: float) -> GradientTransformation:
    return GradientTransformation(
        lambda p: EmptyState(),
        lambda u, s, p=None: (tree_map(lambda g: step * g, u), s))


def scale_by_schedule(fn) -> GradientTransformation:
    def update(u, s, p=None):
        step = fn(int(s.count))
        return tree_map(lambda g: float(step) * g, u), \
            ScaleByScheduleState(_inc(s.count))

    return GradientTransformation(
        lambda p: ScaleByScheduleState(_count0()), update)


def scale_by_learning_rate(lr) -> GradientTransformation:
    if callable(lr):
        return scale_by_schedule(lambda c: -1 * lr(c))
    return scale(-1 * lr)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    def update(u, s, p=None):
        new = tree_map(lambda g, t: g + decay * t, u, s.trace)
        out = tree_map(lambda g, t: g + decay * t, u, new) if nesterov else new
        return out, TraceState(new)

    return GradientTransformation(
        lambda p: TraceState(tree_map(torch.zeros_like, p)), update)


def _adam_init(params):
    return ScaleByAdamState(_count0(), tree_map(torch.zeros_like, params),
                            tree_map(torch.zeros_like, params))


def scale_by_adam(b1, b2, eps, nesterov=False) -> GradientTransformation:
    def update(u, s, p=None):
        mu = tree_map(lambda g, t: _moment(g, t, b1, 1), u, s.mu)
        nu = tree_map(lambda g, t: _moment(g, t, b2, 2), u, s.nu)
        c = _inc(s.count)
        n = int(c)
        if nesterov:
            mu_hat = tree_map(lambda m, g: b1 * m + (1 - b1) * g,
                              _bias(mu, b1, min(n + 1, _INT32_MAX)),
                              _bias(u, b1, n))
        else:
            mu_hat = _bias(mu, b1, n)
        nu_hat = _bias(nu, b2, n)
        out = tree_map(lambda m, v: m / (torch.sqrt(v) + eps), mu_hat, nu_hat)
        return out, ScaleByAdamState(c, mu, nu)

    return GradientTransformation(_adam_init, update)


def scale_by_adamax(b1, b2, eps) -> GradientTransformation:
    def update(u, s, p=None):
        c = _inc(s.count)
        mu = tree_map(lambda g, t: _moment(g, t, b1, 1), u, s.mu)
        nu = tree_map(lambda g, t: torch.maximum(torch.abs(g) + eps, b2 * t),
                      u, s.nu)
        mu_hat = _bias(mu, b1, int(c))
        return tree_map(lambda m, v: m / v, mu_hat, nu), \
            ScaleByAdamState(c, mu, nu)

    return GradientTransformation(_adam_init, update)


def scale_by_amsgrad(b1, b2, eps) -> GradientTransformation:
    def init(params):
        z = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        return ScaleByAmsgradState(_count0(), z(), z(), z())

    def update(u, s, p=None):
        mu = tree_map(lambda g, t: _moment(g, t, b1, 1), u, s.mu)
        nu = tree_map(lambda g, t: _moment(g, t, b2, 2), u, s.nu)
        c = _inc(s.count)
        mu_hat = _bias(mu, b1, int(c))
        nu_hat = _bias(nu, b2, int(c))
        nu_max = tree_map(torch.maximum, s.nu_max, nu_hat)
        out = tree_map(lambda m, v: m / (torch.sqrt(v) + eps), mu_hat, nu_max)
        return out, ScaleByAmsgradState(c, mu, nu, nu_max)

    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value=0.1, eps=1e-7
                 ) -> GradientTransformation:
    def update(u, s, p=None):
        ss = tree_map(lambda g, t: g * g + t, u, s.sum_of_squares)
        inv = tree_map(lambda t: torch.where(t > 0, torch.rsqrt(t + eps), 0.0),
                       ss)
        return tree_map(lambda a, g: a * g, inv, u), ScaleByRssState(ss)

    return GradientTransformation(
        lambda p: ScaleByRssState(tree_map(
            lambda t: torch.full_like(t, initial_accumulator_value), p)),
        update)


def scale_by_adadelta(rho=0.9, eps=1e-6) -> GradientTransformation:
    def update(u, s, p=None):
        e_g = tree_map(lambda g, t: _moment(g, t, rho, 2), u, s.e_g)
        out = tree_map(lambda g, eg, ex: (torch.sqrt(ex + eps)
                                          / torch.sqrt(eg + eps)) * g,
                       u, e_g, s.e_x)
        e_x = tree_map(lambda g, t: _moment(g, t, rho, 2), out, s.e_x)
        return out, ScaleByAdaDeltaState(e_g, e_x)

    return GradientTransformation(
        lambda p: ScaleByAdaDeltaState(tree_map(torch.zeros_like, p),
                                       tree_map(torch.zeros_like, p)), update)


def scale_by_rms(decay=0.9, eps=1e-8, initial_scale=0.0
                 ) -> GradientTransformation:
    def update(u, s, p=None):
        nu = tree_map(lambda g, t: _moment(g, t, decay, 2), u, s.nu)
        return tree_map(lambda n, g: torch.rsqrt(n + eps) * g, nu, u), \
            ScaleByRmsState(nu)

    return GradientTransformation(
        lambda p: ScaleByRmsState(tree_map(
            lambda t: torch.full_like(t, initial_scale), p)), update)


def add_decayed_weights(weight_decay: float = 0.0) -> GradientTransformation:
    def update(u, s, p=None):
        if p is None:
            raise ValueError("add_decayed_weights needs the params")
        return tree_map(lambda g, w: g + weight_decay * w, u, p), s

    return GradientTransformation(lambda p: EmptyState(), update)


def set_to_zero() -> GradientTransformation:
    return GradientTransformation(
        lambda p: EmptyState(),
        lambda u, s, p=None: (tree_map(torch.zeros_like, u), s))


def apply_updates(params, updates):
    """optax's ``apply_updates``: p + u in p's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# --------------------------------------------------------------- updaters


def _lr(lr: LrType, iterations_per_epoch=1):
    if isinstance(lr, _sched.Schedule):
        return lr.to_fn(iterations_per_epoch)
    return lr


@dataclass
class Updater:
    def to_transform(self, iterations_per_epoch: int = 1) -> GradientTransformation:
        """The (init, update) pair of this updater (the reference's
        ``to_optax``)."""
        raise NotImplementedError

    def to_dict(self):
        d = {"@type": type(self).__name__}
        for k, v in self.__dict__.items():
            d[k] = v.to_dict() if isinstance(v, _sched.Schedule) else v
        return d

    @property
    def learningRate(self):
        return getattr(self, "lr", None)


@dataclass
class Sgd(Updater):
    lr: LrType = 1e-3

    def to_transform(self, iterations_per_epoch=1):
        return chain(identity(),
                     scale_by_learning_rate(_lr(self.lr, iterations_per_epoch)))


@dataclass
class Nesterovs(Updater):
    lr: LrType = 0.1
    momentum: float = 0.9

    def to_transform(self, iterations_per_epoch=1):
        return chain(trace(self.momentum, nesterov=True),
                     scale_by_learning_rate(_lr(self.lr, iterations_per_epoch)))


@dataclass
class Adam(Updater):
    lr: LrType = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self, iterations_per_epoch=1):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     scale_by_learning_rate(_lr(self.lr, iterations_per_epoch)))


@dataclass
class AdamW(Adam):
    """Adam with decoupled weight decay (the BERT fine-tune default; the
    reference models weight decay via regularization instead)."""
    weightDecay: float = 0.01

    def to_transform(self, iterations_per_epoch=1):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon),
                     add_decayed_weights(self.weightDecay),
                     scale_by_learning_rate(_lr(self.lr, iterations_per_epoch)))


@dataclass
class AdaMax(Updater):
    lr: LrType = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self, iterations_per_epoch=1):
        return chain(scale_by_adamax(self.beta1, self.beta2, self.epsilon),
                     scale_by_learning_rate(_lr(self.lr, iterations_per_epoch)))


@dataclass
class Nadam(Updater):
    lr: LrType = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self, iterations_per_epoch=1):
        return chain(scale_by_adam(self.beta1, self.beta2, self.epsilon,
                                   nesterov=True),
                     scale_by_learning_rate(_lr(self.lr, iterations_per_epoch)))


@dataclass
class AMSGrad(Updater):
    lr: LrType = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def to_transform(self, iterations_per_epoch=1):
        return chain(scale_by_amsgrad(self.beta1, self.beta2, self.epsilon),
                     scale_by_learning_rate(_lr(self.lr, iterations_per_epoch)))


@dataclass
class AdaGrad(Updater):
    lr: LrType = 0.1
    epsilon: float = 1e-6

    def to_transform(self, iterations_per_epoch=1):
        return chain(scale_by_rss(0.1, self.epsilon),
                     scale_by_learning_rate(_lr(self.lr, iterations_per_epoch)))


@dataclass
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6

    def to_transform(self, iterations_per_epoch=1):
        return chain(add_decayed_weights(0.0),
                     scale_by_adadelta(self.rho, self.epsilon),
                     scale_by_learning_rate(1.0))


@dataclass
class RmsProp(Updater):
    lr: LrType = 0.1
    rmsDecay: float = 0.95
    epsilon: float = 1e-8

    def to_transform(self, iterations_per_epoch=1):
        return chain(scale_by_rms(self.rmsDecay, self.epsilon, 0.0),
                     scale_by_learning_rate(_lr(self.lr, iterations_per_epoch)),
                     identity())


@dataclass
class NoOp(Updater):
    def to_transform(self, iterations_per_epoch=1):
        return set_to_zero()


_ALL = {c.__name__: c for c in [
    Sgd, Nesterovs, Adam, AdamW, AdaMax, Nadam, AMSGrad, AdaGrad, AdaDelta, RmsProp, NoOp]}


def from_dict(d: dict) -> Updater:
    d = dict(d)
    cls = _ALL[d.pop("@type")]
    if isinstance(d.get("lr"), dict):
        d["lr"] = _sched.from_dict(d["lr"])
    return cls(**d)


__all__ = ["GradientTransformation", "tree_leaves", "tree_map", "tree_unflatten",
           "apply_updates"] + list(_ALL)
