"""The reference's optimizers, rounded as its compiled epoch rounds them.

The trainers of ``flowsentryx_tpu/train/qat.py`` use ``optax.adagrad``
and ``optax.adam`` (optax 0.2.6) inside a jitted step.  Their update
rules are not ``torch.optim``'s, so they are rebuilt here op for op:

* :class:`Adagrad` (``scale_by_rss`` then ``scale(-lr)``): the
  accumulator starts at ``initial_accumulator_value`` (0.1), takes this
  step's ``g*g`` before it is used (one fused multiply-add, as XLA:CPU
  contracts ``g*g + acc``), and the update is
  ``-lr * (rsqrt(acc + eps) * g)``, 0 where ``acc`` is 0.
  ``torch.optim.Adagrad`` starts at 0 and divides by ``sqrt(acc) +
  1e-10``.
* :class:`Adam` (``scale_by_adam`` then ``scale(-lr)``): ``mu`` and
  ``nu`` are kept in the parameter's dtype (bfloat16 for the MLP
  families); ``mu = (1-b1) g + b1 mu`` and ``nu = (1-b2) g^2 + b2 nu``
  (in float32 one fused multiply-add each), the bias corrections
  ``1 - b**count`` in float32 cast to the parameter's dtype, and the
  update ``-lr * mu_hat / (sqrt(nu_hat) + eps)``; in float32 XLA's
  simplifier folds its two divisions into ``mu / (bc1 * (sqrt(nu /
  bc2) + eps))``, in bfloat16 it does not.
* :func:`apply_update`: ``(p + u).astype(p.dtype)``; in float32 the
  ``-lr`` product and this add are one fused multiply-add.

A float32 operand is rounded once per op, an FMA once
(:func:`~flowsentryx_tpu_torch.core.device.fma32`).  In bfloat16 every
op rounds to bfloat16 and every Python constant enters as a bfloat16
value, as a weak-typed scalar does in the reference (``b2 = 0.999`` is
1.0 there).  XLA:CPU's ``rsqrt`` is the host's ``vrsqrtps`` estimate
refined by two Newton steps, which no other machine reproduces; here it
is the correctly rounded ``1 / sqrt`` (ROADMAP queue 3).

Each optimizer is a ``torch.optim.Optimizer``: ``step()`` reads
``p.grad`` and writes ``p`` in place.  Its state (``sum_of_squares``, or
``mu``, ``nu`` and ``count``) can be set from a reference optax state
(:mod:`~flowsentryx_tpu_torch.train.qat` carries one across).
"""

from __future__ import annotations

import numpy as np
import torch

from flowsentryx_tpu_torch.core.device import fma32


def _const(x: float, dtype: torch.dtype) -> float:
    """A Python constant as the reference's weak-typed scalar enters an
    op on a ``dtype`` operand: rounded to that dtype."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype).float())


def _madd(a: torch.Tensor, b: torch.Tensor | float,
          c: torch.Tensor) -> torch.Tensor:
    """``a * b + c``: one rounding in float32 (XLA:CPU contracts it),
    two in any other dtype."""
    if a.dtype == torch.float32:
        return fma32(a, b, c)
    return a * b + c


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(x)`` correctly rounded (through float64)."""
    return (1.0 / torch.sqrt(x.double())).to(x.dtype)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's ``sqrt``: correctly rounded in float32 (through float64;
    torch's float32 CPU ``sqrt`` is not), a bfloat16 operand computed in
    float32 and rounded back."""
    return torch.sqrt(x.double()).float().to(x.dtype)


def apply_update(p: torch.Tensor, d: torch.Tensor, lr: float) -> None:
    """``p <- (p + (-lr) * d).astype(p.dtype)`` in place: ``optax.scale``
    then ``optax.apply_updates``."""
    m = _const(-lr, p.dtype)
    if p.dtype == torch.float32:
        p.copy_(fma32(d, m, p))
    else:
        p.copy_(p + d * m)


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr, initial_accumulator_value, eps)``."""

    def __init__(self, params, lr: float = 0.05,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad
                st = self.state[p]
                if "sum_of_squares" not in st:
                    st["sum_of_squares"] = torch.full_like(
                        p, _const(group["initial_accumulator_value"],
                                  p.dtype))
                acc = _madd(g, g, st["sum_of_squares"])
                st["sum_of_squares"] = acc
                inv = torch.where(
                    acc > 0, _rsqrt(acc + _const(group["eps"], p.dtype)),
                    torch.zeros_like(acc))
                apply_update(p, inv * g, group["lr"])


class Adam(torch.optim.Optimizer):
    """``optax.adam(lr, b1, b2, eps, eps_root=0)``."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            for p in group["params"]:
                g = p.grad
                st = self.state[p]
                if "mu" not in st:
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                    st["count"] = 0
                dt = p.dtype
                mu = _madd(g, _const(1 - b1, dt), st["mu"] * _const(b1, dt))
                nu = _madd(g * g, _const(1 - b2, dt),
                           st["nu"] * _const(b2, dt))
                count = min(st["count"] + 1, 2**31 - 1)   # safe_increment
                # 1 - b**count in float32, then cast to the moment's dtype
                bc1 = _const(float(np.float32(1) - np.float32(b1) ** count), dt)
                bc2 = _const(float(np.float32(1) - np.float32(b2) ** count), dt)
                eps = _const(group["eps"], dt)
                if dt == torch.float32:
                    d = mu / ((_sqrt(nu / bc2) + eps) * bc1)
                else:
                    d = (mu / bc1) / (_sqrt(nu / bc2) + eps)
                apply_update(p, d, group["lr"])
                st.update(mu=mu, nu=nu, count=count)
