"""The optax updates DeepLearning trains with, in plain PyTorch.

The JAX package's ``models/deeplearning.py`` builds its optimizer from
optax 0.2.6; this module is the port's copy of those pieces, with optax's
update formulas and optax's state layout:

- ``Adadelta(learning_rate=1.0, rho, eps)``: ``optax.adadelta``, that is
  ``chain(add_decayed_weights(0), scale_by_adadelta(rho, eps),
  scale_by_learning_rate(1.0))``. Per parameter ``e_g = (1-rho) g^2 + rho e_g``, ``u = sqrt(e_x + eps) /
  sqrt(e_g + eps) * g``, ``e_x = (1-rho) u^2 + rho e_x``, update ``-u``.
  A zero weight decay adds ``0 * p``, which changes nothing but the sign of
  a zero, and is left out;
- ``SGD(rate)`` and ``SGD(rate, momentum)``: ``optax.sgd``, that is
  ``chain(trace(momentum), scale_by_learning_rate(rate))`` with ``trace =
  g + momentum * trace``; ``rate`` is a number or ``ExponentialDecay(init,
  1, decay)`` (``optax.schedules.exponential_decay``);
- ``InjectMomentum(rate, schedule)``: ``optax.inject_hyperparams`` around
  ``sgd(rate, momentum=...)`` with the momentum a function of the step
  count, evaluated at the count before the step;
- ``softmax_cross_entropy_with_integer_labels``.

State: a flat list of tensors in the order ``jax.tree_util.tree_leaves``
flattens the optax state, so a model's ``opt_leaves`` moves between the two
packages as it is, and a continued fit resumes the accumulators, the traces
and the step counts exactly. For parameters ``[W0, b0, W1, b1, ...]`` the
leaves are:

- adadelta: ``e_g`` of each parameter, then ``e_x`` of each;
- sgd with a constant rate: none; with ``exponential_decay``: the count;
- injected momentum: the count, the momentum (float32), the momentum
  schedule's count, the trace of each parameter and, with
  ``exponential_decay``, the rate's count.

Counts are int32 and the scalar schedules run in float32 on the host, as
optax computes them (its float32 ``power`` and fused multiply-adds may part
from these in the last bit); the per-parameter arithmetic runs on the
parameters' device, one ``torch._foreach_*`` op over all parameters per
step of the formula (one multi-tensor launch on the card; on the CPU a
loop of the single-tensor ops, with the same bits).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

Tensor = torch.Tensor

Rate = Union[float, "ExponentialDecay"]


def _count(n: int = 0) -> Tensor:
    return torch.tensor(n, dtype=torch.int32)


def _f32(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


class ExponentialDecay:
    """``optax.schedules.exponential_decay(init_value, transition_steps,
    decay_rate)`` without staircase, begin or end value: ``init *
    decay ** (count / transition_steps)`` in float32, ``init`` at count 0."""

    def __init__(self, init_value: float, transition_steps: int, decay_rate: float):
        self.init_value = init_value
        self.transition_steps = transition_steps
        self.decay_rate = decay_rate

    def __call__(self, count: int) -> Tensor:
        if self.transition_steps <= 0 or self.decay_rate == 0 or count <= 0:
            return _f32(self.init_value)
        p = _f32(count) / _f32(self.transition_steps)
        return _f32(self.init_value) * torch.pow(_f32(self.decay_rate), p)


class Optimizer:
    """An optax ``GradientTransformation`` on a list of parameter tensors.

    ``init(params)`` gives the state leaves; ``update(grads, state,
    params)`` gives ``(updates, new_state)``; ``apply_updates`` adds them.
    ``num_leaves(n_params)`` is the length of the state list."""

    def init(self, params: Sequence[Tensor]) -> List[Tensor]:
        raise NotImplementedError

    def update(self, grads: Sequence[Tensor], state: List[Tensor],
               params: Sequence[Tensor]) -> Tuple[List[Tensor], List[Tensor]]:
        raise NotImplementedError

    def num_leaves(self, n_params: int) -> int:
        raise NotImplementedError


class Adadelta(Optimizer):
    def __init__(self, learning_rate: float = 1.0, rho: float = 0.9, eps: float = 1e-6):
        self.learning_rate = learning_rate
        self.rho = rho
        self.eps = eps

    def init(self, params):
        return [torch.zeros_like(p) for p in params] + [torch.zeros_like(p) for p in params]

    def num_leaves(self, n_params):
        return 2 * n_params

    def update(self, grads, state, params):
        n = len(grads)
        e_g, e_x = state[:n], state[n:]
        # optax.tree.update_moment: (1 - decay) * g**2 + decay * moment
        a, r, eps = 1.0 - self.rho, self.rho, self.eps
        e_g = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), a),
                                 torch._foreach_mul(e_g, r))
        u = torch._foreach_mul(torch._foreach_div(torch._foreach_sqrt(torch._foreach_add(e_x, eps)),
                                                  torch._foreach_sqrt(torch._foreach_add(e_g, eps))),
                               grads)
        e_x = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(u, u), a),
                                 torch._foreach_mul(e_x, r))
        return torch._foreach_mul(u, -self.learning_rate), list(e_g) + list(e_x)


class SGD(Optimizer):
    """``optax.sgd(learning_rate, momentum)`` (no Nesterov)."""

    def __init__(self, learning_rate: Rate, momentum: Optional[float] = None):
        self.learning_rate = learning_rate
        self.momentum = momentum

    @property
    def _scheduled(self) -> bool:
        return callable(self.learning_rate)

    def num_leaves(self, n_params):
        return (n_params if self.momentum is not None else 0) + int(self._scheduled)

    def init(self, params):
        trace = [torch.zeros_like(p) for p in params] if self.momentum is not None else []
        return trace + ([_count()] if self._scheduled else [])

    def update(self, grads, state, params):
        n = len(grads)
        if self.momentum is not None:
            # g + momentum * trace; torch's add with alpha rounds once, as
            # XLA's fused multiply-add in the JAX package's jitted step
            trace = list(torch._foreach_add(grads, state[:n], alpha=float(self.momentum)))
            grads, rest = trace, state[n:]
        else:
            trace, rest = [], state
        if self._scheduled:
            count = int(rest[0])
            step = float(-self.learning_rate(count))
            rest = [_count(min(count + 1, 2**31 - 1))]
        else:
            step = -self.learning_rate
        return torch._foreach_mul(grads, step), trace + rest


class InjectMomentum(Optimizer):
    """``optax.inject_hyperparams(lambda momentum: sgd(rate,
    momentum=momentum))(momentum=schedule)``: the momentum is
    ``schedule(count)`` with the count before the step, kept in the state
    as float32 beside the counts."""

    def __init__(self, learning_rate: Rate, schedule: Callable[[int], Tensor]):
        self.schedule = schedule
        self.learning_rate = learning_rate

    def _inner(self, momentum: Tensor) -> SGD:
        return SGD(self.learning_rate, momentum=float(momentum))

    def num_leaves(self, n_params):
        return 3 + self._inner(_f32(0.0)).num_leaves(n_params)

    def init(self, params):
        momentum = _f32(self.schedule(0))
        return [_count(), momentum, _count()] + self._inner(momentum).init(params)

    def update(self, grads, state, params):
        count, sched_count = int(state[0]), int(state[2])
        momentum = _f32(self.schedule(sched_count))
        updates, inner = self._inner(momentum).update(grads, state[3:], params)
        top = 2**31 - 1
        return updates, [_count(min(count + 1, top)), momentum,
                         _count(min(sched_count + 1, top))] + inner


def apply_updates(params: Sequence[Tensor], updates: Sequence[Tensor]) -> List[Tensor]:
    """``optax.apply_updates``: ``p + u`` (float32 parameters and updates)."""
    return list(torch._foreach_add(params, updates))


def softmax_cross_entropy_with_integer_labels(logits: Tensor, labels: Tensor) -> Tensor:
    """Per-row ``logsumexp(logits) - logits[label]``, optax's form."""
    label_logits = logits.gather(1, labels.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=1) - label_logits
