"""Quantization-aware training of the int8 classifier, and the float
trainers of the MLP families.

Counterpart of ``flowsentryx_tpu/train/qat.py``: moving-average min/max
:class:`Observer` s, straight-through :func:`fake_quant`,
:func:`qat_forward`, the full-batch :func:`train_logreg_qat` (an
observer-only warmup, then fake-quant with a fresh optimizer), its
data-parallel twin :func:`train_logreg_qat_dp` over the n shards of a
:class:`~flowsentryx_tpu_torch.parallel.mesh.Mesh`, :func:`convert` to
the deployable :class:`~flowsentryx_tpu_torch.models.logreg.LogRegParams`,
and the
minibatch Adam trainers :func:`train_mlp` / :func:`train_multiclass`.

Rounded as the reference's jitted epoch rounds it (ROADMAP ground rules):

* the features go through XLA's ``log1p``
  (:func:`~flowsentryx_tpu_torch.core.device.xla_log1p`), since
  ``in_scale`` is read off its output;
* inside the epoch, ``(hi - lo) / 255`` and ``max|w| / 127`` are
  multiplies by the f32 reciprocal (XLA:CPU rewrites division by a
  constant, :func:`~flowsentryx_tpu_torch.core.device.recip_mul`), while
  :func:`convert`, eager in the reference, divides truly;
* the observers' momentum update is the reference's
  ``m*lo + (1-m)*blo`` with the ``m*lo`` product fused into the add
  (:func:`_ema`), and fake-quant's ``dq - x`` is one fused multiply-add
  (``tests/test_torch_train.py`` holds both to the jitted reference);
* the forward's ``x @ w`` is XLA:CPU's sum of eight products, in the
  order its dot emitter gives a row (:func:`_dot8`), its sigmoid and the
  loss's ``log`` are XLA's; the gradients are written out as the
  reference's compiled backward computes them (:func:`qat_epoch`);
* the optimizers are optax's (:mod:`.optim`).

With these the epoch equals the reference's but for the last bit of
Adagrad's ``rsqrt`` (ROADMAP queue 3, item 19).  The state lives on the
device of the data (the card by default); the per-epoch ``float(loss)``
is the one host sync of an epoch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from flowsentryx_tpu_torch.core.device import (
    fma32, recip_mul, resolve_device, xla_log, xla_log1p, xla_sigmoid,
)
from flowsentryx_tpu_torch.core.schema import NUM_FEATURES
from flowsentryx_tpu_torch.models import logreg
from flowsentryx_tpu_torch.models.mlp import fixed_order_dot, xla_batch_sum
from flowsentryx_tpu_torch.ops import kernels
from flowsentryx_tpu_torch.parallel import exchange
from flowsentryx_tpu_torch.train import optim


def _ema(old: torch.Tensor, new: torch.Tensor, m: float) -> torch.Tensor:
    """``m * old + (1 - m) * new`` as the jitted epoch rounds it.  The
    momentum is a leaf of the reference's state, so it enters the epoch
    as a traced float32 and ``1 - m`` is a float32 subtraction
    (0.100000024 for 0.9); the ``(1 - m) * new`` product is rounded and
    ``m * old`` fused into the add."""
    m32 = np.float32(m)
    return fma32(old, float(m32), new * float(np.float32(1) - m32))


class Observer(NamedTuple):
    """Moving-average min/max (torch's MovingAverageMinMaxObserver):
    ``lo``/``hi`` are 0-d f32 tensors, ``inf``/``-inf`` until the first
    update."""

    lo: torch.Tensor
    hi: torch.Tensor
    momentum: float = 0.9

    def update(self, x: torch.Tensor) -> "Observer":
        return self.update_minmax(x.min(), x.max())

    def update_minmax(self, blo: torch.Tensor, bhi: torch.Tensor
                      ) -> "Observer":
        fresh = ~torch.isfinite(self.lo)
        m = self.momentum
        return Observer(
            lo=torch.where(fresh, blo, _ema(self.lo, blo, m)),
            hi=torch.where(fresh, bhi, _ema(self.hi, bhi, m)),
            momentum=m)

    def quint8_qparams(self, eager: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Affine quint8 ``(scale, zero_point)``: the range always holds
        0, zp clamped to [0, 255].  ``eager`` divides ``hi - lo`` by 255
        truly (the reference's ``convert``); inside the epoch it is a
        reciprocal multiply."""
        lo = torch.clamp(self.lo, max=0.0)
        hi = torch.clamp(self.hi, min=0.0)
        span = hi - lo
        scale = torch.clamp(span / 255.0 if eager else recip_mul(span, 255.0),
                            min=float(np.float32(1e-12)))
        zp = torch.clamp(torch.round(-lo / scale), 0.0, 255.0)
        return scale, zp


def fresh_observer(device="cpu") -> Observer:
    return Observer(lo=torch.tensor(float("inf"), device=device),
                    hi=torch.tensor(float("-inf"), device=device))


def fake_quant(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor,
               qmin: float, qmax: float) -> torch.Tensor:
    """Quantize -> dequantize with a straight-through gradient: the value
    is ``x + (dq - x)``, the gradient that of ``x``.  ``dq - x`` is one
    fused multiply-add, ``(q - zp) * scale - x``, as the jitted
    reference contracts it."""
    with torch.no_grad():
        q = torch.clamp(torch.round(x / scale) + zp, qmin, qmax)
        d = fma32(q - zp, scale, -x)
    return x + d.detach()


def _weight_scale(w: torch.Tensor, eager: bool = False) -> torch.Tensor:
    """Per-tensor symmetric int8 weight scale ``absmax / 127`` (zp 0)."""
    a = w.detach().abs().max()
    return torch.clamp(a / 127.0 if eager else recip_mul(a, 127.0),
                       min=float(np.float32(1e-12)))


def _dot8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``[N, 8] x [8]`` as XLA:CPU sums it, the eight
    products rounded: the rows of whole 8-row tiles add them as adjacent
    pairs ``((p0+p1)+(p2+p3)) + ((p4+p5)+(p6+p7))``, the ``N mod 8`` rows
    after the last whole tile as halves ``((p0+p4)+(p2+p6)) +
    ((p1+p5)+(p3+p7))`` (ROADMAP queue 3, item 29)."""
    t = x.shape[0] - x.shape[0] % 8
    out = fixed_order_dot(x[:t], w[:, None], 8, "adjacent")[:, 0]
    if t == x.shape[0]:
        return out
    return torch.cat([out, fixed_order_dot(x[t:], w[:, None], 8,
                                           "half")[:, 0]])


class QatState(NamedTuple):
    w: torch.Tensor          # [8] f32 master weights
    b: torch.Tensor          # [] f32
    obs_in: Observer
    obs_out: Observer
    opt: torch.optim.Optimizer


class TrainResult(NamedTuple):
    state: QatState
    losses: np.ndarray       # [epochs] f32
    params: logreg.LogRegParams


def _forward(w, b, obs_in, obs_out, x, quantize):
    """The forward pass without autograd: ``(p, xq, obs_in, obs_out)``,
    ``xq`` the (fake-quantized) input the dot saw."""
    obs_in = obs_in.update(x)
    if quantize:
        in_s, in_zp = obs_in.quint8_qparams()
        x = fake_quant(x, in_s, in_zp, 0.0, 255.0)
        w = fake_quant(w, _weight_scale(w), torch.zeros_like(b), -127.0,
                       127.0)
    y = _dot8(x, w) + b
    obs_out = obs_out.update(y)
    if quantize:
        out_s, out_zp = obs_out.quint8_qparams()
        y = fake_quant(y, out_s, out_zp, 0.0, 255.0)
    return xla_sigmoid(y), x, obs_in, obs_out


def qat_forward(w: torch.Tensor, b: torch.Tensor, obs_in: Observer,
                obs_out: Observer, x: torch.Tensor, quantize: bool = True
                ) -> tuple[torch.Tensor, Observer, Observer]:
    """One QAT forward pass: probabilities + updated observers.
    ``quantize=False`` is the observer-only warmup."""
    with torch.no_grad():
        p, _, obs_in, obs_out = _forward(w, b, obs_in, obs_out, x, quantize)
    return p, obs_in, obs_out


#: ``1 + 1e-7`` in float32: XLA folds ``1 - p + eps`` into ``1.00000012 - p``.
_ONE_EPS = float(np.float32(1) + np.float32(1e-7))
_EPS = 1e-7


def loss_terms(p: torch.Tensor, y: torch.Tensor,
               sample_weight: torch.Tensor | None = None,
               cotangent: float = 1.0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row BCE terms (``eps = 1e-7``, XLA's ``log``, optionally
    weighted) and their gradient with respect to the pre-sigmoid output,
    as JAX's autodiff lays out the reference's compiled epoch:
    ``dL/dp = -((1 - y) * -sw) / (1.00000012 - p) + (y * -sw) / (p +
    eps)`` (XLA folds ``1 + eps``), times the sigmoid's ``p * (1 - p)``.
    Unweighted, ``sw`` is the loss's ``cotangent`` (1, or the
    data-parallel trainer's mesh size)."""
    losses = -(y * xla_log(p + _EPS) + (1 - y) * xla_log(_ONE_EPS - p))
    nsw = -float(cotangent)
    if sample_weight is not None:
        losses = losses * sample_weight
        nsw = -sample_weight
    gp = -(((1 - y) * nsw) / (_ONE_EPS - p)) + (y * nsw) / (p + _EPS)
    return losses, gp * (p * (1 - p))


def qat_epoch(state: QatState, X: torch.Tensor, y: torch.Tensor,
              quantize: bool, sample_weight: torch.Tensor | None = None
              ) -> tuple[QatState, torch.Tensor]:
    """One full-batch epoch: the summed BCE (``eps = 1e-7``, optionally
    row-weighted), its gradients (left in ``state.w.grad`` /
    ``state.b.grad``), the optimizer step.  Returns the new state and
    the loss (a device tensor).

    The gradients are written out as the reference's compiled epoch
    computes them (:func:`loss_terms`; the straight-through fake-quant
    passes them on).  The weight gradient ``xq^T dL/dy`` is one FMA chain per weight in row
    order (the ``gemv_seq`` kernel on the card), the bias gradient and
    the loss XLA's blocked sums (:func:`~..models.mlp.xla_batch_sum`):
    the orders of the reference's compiled backward, on which the
    quantized phase's int8 codes depend."""
    with torch.no_grad():
        p, xq, obs_in, obs_out = _forward(state.w, state.b, state.obs_in,
                                          state.obs_out, X, quantize)
        losses, gy = loss_terms(p, y, sample_weight)
        state.w.grad = kernels.gemv_seq(gy, xq.contiguous())
        state.b.grad = xla_batch_sum(gy)
        loss = xla_batch_sum(losses)
    state.opt.step()
    return state._replace(obs_in=obs_in, obs_out=obs_out), loss


def _adagrad(lr: float) -> Callable:
    return lambda params: optim.Adagrad(params, lr)


def new_state(device, optimizer: Callable | None = None, lr: float = 0.05
              ) -> QatState:
    """Zero weights and bias, fresh observers, a fresh optimizer."""
    w = torch.zeros(NUM_FEATURES, device=device)
    b = torch.zeros((), device=device)
    make = optimizer or _adagrad(lr)
    return QatState(w, b, fresh_observer(device), fresh_observer(device),
                    make([w, b]))


def train_logreg_qat(
    X: np.ndarray,
    y: np.ndarray,
    epochs: int = 200,
    lr: float = 0.05,
    warmup_fraction: float = 0.5,
    log_features: bool = True,
    optimizer: Callable | None = None,
    log_every: int = 0,
    sample_weight: np.ndarray | None = None,
    device=None,
) -> TrainResult:
    """Full-batch QAT: summed BCE, Adagrad(lr) by default
    (``optimizer`` is a factory ``params -> Optimizer``), the first
    ``warmup_fraction`` of epochs observer-only, a fresh optimizer when
    fake-quant engages.  ``log_features`` trains in the log1p domain
    (recorded in the artifact); ``sample_weight`` scales each row's BCE
    term.  ``device`` defaults to the card (raises without one)."""
    dev = resolve_device(device)
    Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(dev)
    if log_features:
        Xd = xla_log1p(Xd)
    yd = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
    sw = (None if sample_weight is None else torch.from_numpy(
        np.asarray(sample_weight, np.float32)).to(dev))
    make = optimizer or _adagrad(lr)
    state = new_state(dev, make)
    n_warm = int(epochs * warmup_fraction)
    losses = np.zeros(epochs, np.float32)
    for e in range(epochs):
        if e == n_warm:  # phase switch: fresh optimizer for finetune
            state = state._replace(opt=make([state.w, state.b]))
        state, loss = qat_epoch(state, Xd, yd, e >= n_warm, sw)
        losses[e] = float(loss)
        if log_every and (e + 1) % log_every == 0:
            print(f"epoch {e + 1}/{epochs}: loss {losses[e]:.1f}")
    return TrainResult(state=state, losses=losses,
                       params=convert(state, log_features))


def _fused_sum(v: torch.Tensor) -> torch.Tensor:
    """``v.sum()`` of a ``[n]`` float32 as XLA:CPU reduces the
    data-parallel loss's masked terms: past 32 rows, its blocked sums
    (:func:`~..models.mlp.xla_batch_sum`); up to 32 rows, one loop
    fusion that LLVM vectorizes: eight lanes accumulate the whole 8-row
    chunks in order, the lanes add as halves ``((a0+a4)+(a2+a6)) +
    ((a1+a5)+(a3+a7))``, then the ``n mod 8`` rows after the last whole
    chunk add one by one."""
    if v.shape[0] > 32:
        return xla_batch_sum(v)
    t = v.shape[0] - v.shape[0] % 8
    if t:
        acc = v[:t].reshape(-1, 8)
        lanes = acc[0]
        for row in acc[1:]:
            lanes = lanes + row
        while lanes.shape[0] > 1:
            h = lanes.shape[0] // 2
            lanes = lanes[:h] + lanes[h:]
        s = lanes[0]
    else:
        s = v.new_zeros(())
    for x in v[t:]:
        s = s + x
    return s


def qat_dp_epoch(state: QatState, X: torch.Tensor, y: torch.Tensor,
                 mask: torch.Tensor, n_shards: int, quantize: bool,
                 mesh=None) -> tuple[QatState, torch.Tensor]:
    """One epoch of the reference's data-parallel trainer over
    ``n_shards`` equal row ranges of the padded ``X``/``y``/``mask``
    (``train_logreg_qat_dp``'s ``device_epoch``, its shard_map unrolled
    into a loop over the shards of one device):

    * the observers update once, from the global masked min and max
      (the reference's ``pmin``/``pmax`` of the shards' ranges);
    * each shard runs the forward over its rows (its own ``[N/n, 8]``
      dot, :func:`_dot8`) and its masked BCE terms;
    * each shard's gradients: the weight's a row-order FMA chain over
      the shard's rows (one ``gemv_seq`` launch for all the shards on
      the card, a block per shard: :func:`~..ops.kernels.gemv_seq_shards`),
      the bias's XLA's sum of the shard's rows (:func:`~..models.mlp
      .xla_batch_sum`), the loss's its fused sum (:func:`_fused_sum`); their
      ``psum`` adds the shards in order
      (:func:`~..parallel.exchange.ordered_sum`);
    * the loss's cotangent is ``n_shards``, not 1: the reference's
      ``value_and_grad`` of a ``psum`` under ``shard_map(check_vma=
      False)`` transposes the ``psum`` into another, so every shard's
      gradient, and their sum, is ``n_shards`` times the full-batch
      gradient (ROADMAP queue 3, item 30; a power of two, so the scale
      is exact).

    On a process mesh (``mesh``, one process per shard, every rank
    calling this) ``X``/``y``/``mask`` are this rank's own ``N/n`` rows,
    and the reference's collectives are :mod:`~..parallel.exchange`'s:
    ``pmin``/``pmax`` of the ranks' masked ranges (exact in any order)
    and ``psum`` of their gradients and losses (added in rank order on
    every rank, the order above), so every rank steps the same bits.

    Returns the new state and the summed loss (a device tensor)."""
    if mesh is not None and mesh.is_process:
        def ranged(v):
            lo, hi = _masked_range(v, mask)
            return exchange.pmin(mesh, lo), exchange.pmax(mesh, hi)

        return _dp_epoch(state, X, y, mask, quantize, [slice(None)],
                         mesh.size, ranged,
                         lambda parts: exchange.psum(mesh, parts[0]))
    rows = X.shape[0] // n_shards
    return _dp_epoch(
        state, X, y, mask, quantize,
        [slice(i * rows, (i + 1) * rows) for i in range(n_shards)],
        n_shards, lambda v: (v[mask].min(), v[mask].max()),
        exchange.ordered_sum)


def _masked_range(v: torch.Tensor, mask: torch.Tensor):
    """This rank's masked ``(min, max)`` of ``v`` (rows ``mask``): the
    identities where it holds no valid row."""
    m = mask.reshape(-1, *([1] * (v.dim() - 1)))
    return (torch.where(m, v, float("inf")).min(),
            torch.where(m, v, float("-inf")).max())


def _dp_epoch(state: QatState, X, y, mask, quantize: bool, cuts: list,
              cotangent: int, ranged, summed
              ) -> tuple[QatState, torch.Tensor]:
    """The body of :func:`qat_dp_epoch` over the shards that ``cuts``
    slice out of this process's rows (all of them on one process, its
    own on a rank of a process mesh); ``ranged(v)`` is the global masked
    ``(min, max)`` of ``v`` and ``summed(parts)`` the global sum of the
    shards' values, as the caller reduces them."""
    with torch.no_grad():
        obs_in = state.obs_in.update_minmax(*ranged(X))
        w = state.w
        if quantize:
            in_s, in_zp = obs_in.quint8_qparams()
            X = fake_quant(X, in_s, in_zp, 0.0, 255.0)
            w = fake_quant(w, _weight_scale(w), torch.zeros_like(state.b),
                           -127.0, 127.0)
        yl = torch.cat([_dot8(X[c], w) for c in cuts]) + state.b
        obs_out = state.obs_out.update_minmax(*ranged(yl))
        if quantize:
            out_s, out_zp = obs_out.quint8_qparams()
            yl = fake_quant(yl, out_s, out_zp, 0.0, 255.0)
        losses, gy = loss_terms(xla_sigmoid(yl), y, cotangent=cotangent)
        losses = torch.where(mask, losses, 0.0)
        gy = torch.where(mask, gy, 0.0)
        # the cuts are equal row ranges in order: one [S, R] launch
        s, rows = len(cuts), X.shape[0] // len(cuts)
        state.w.grad = summed(list(kernels.gemv_seq_shards(
            gy[:s * rows].reshape(s, rows).contiguous(),
            X[:s * rows].reshape(s, rows, X.shape[1]).contiguous()
        ).unbind(0)))
        state.b.grad = summed([xla_batch_sum(gy[c]) for c in cuts])
        loss = summed([_fused_sum(losses[c]) for c in cuts])
    state.opt.step()
    return state._replace(obs_in=obs_in, obs_out=obs_out), loss


def train_logreg_qat_dp(
    X: np.ndarray,
    y: np.ndarray,
    mesh,
    epochs: int = 200,
    lr: float = 0.05,
    warmup_fraction: float = 0.5,
    log_features: bool = True,
    optimizer: Callable | None = None,
) -> TrainResult:
    """:func:`train_logreg_qat` over the n shards of ``mesh``
    (:func:`~flowsentryx_tpu_torch.parallel.mesh.make_mesh`, all on one
    device), each holding ``N/n`` rows: a ragged ``N`` is zero-padded
    and masked out of the loss, the gradients and the ranges, as the
    reference's ``train_logreg_qat_dp`` does.  One epoch is
    :func:`qat_dp_epoch`; the warmup and the optimizer restart are the
    single-device trainer's.

    On a process mesh (one process per shard) every rank makes this same
    call (SPMD: :meth:`~..parallel.launch.MeshProcesses.spmd`, e.g.
    ``world.spmd(train_logreg_qat_dp, X, y, epochs=E)``) and keeps only
    its own ``N/n`` rows of the padded data on its device; each rank's
    result equals the one-process trainer's over as many shards, bit for
    bit.  ``gemv_seq`` launches once per epoch on each rank."""
    dev = mesh.device
    n_shards = mesh.size
    n = len(X)
    pad = (-n) % n_shards
    Xh = np.concatenate([np.ascontiguousarray(X, np.float32),
                         np.zeros((pad, np.shape(X)[1]), np.float32)])
    yh = np.concatenate([np.asarray(y, np.float32),
                         np.zeros(pad, np.float32)])
    mh = np.arange(n + pad) < n
    if mesh.is_process:
        rows = (n + pad) // n_shards
        mine = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
        Xh, yh, mh = Xh[mine], yh[mine], mh[mine]
    Xd = torch.from_numpy(np.ascontiguousarray(Xh)).to(dev)
    if log_features:
        Xd = xla_log1p(Xd)
    yd = torch.from_numpy(np.ascontiguousarray(yh)).to(dev)
    mask = torch.from_numpy(mh).to(dev)
    make = optimizer or _adagrad(lr)
    state = new_state(dev, make)
    n_warm = int(epochs * warmup_fraction)
    losses = np.zeros(epochs, np.float32)
    for e in range(epochs):
        if e == n_warm:  # phase switch: fresh optimizer for finetune
            state = state._replace(opt=make([state.w, state.b]))
        state, loss = qat_dp_epoch(state, Xd, yd, mask, n_shards,
                                   e >= n_warm, mesh)
        losses[e] = float(loss)
    return TrainResult(state=state, losses=losses,
                       params=convert(state, log_features))


def convert(state: QatState, log_features: bool = True
            ) -> logreg.LogRegParams:
    """Bake observers and weights into the deployable int8 artifact (on
    the host, with true divisions, as the reference's eager
    ``convert``)."""
    w = state.w.detach().cpu()
    w_s = _weight_scale(w, eager=True)
    w_int8 = np.clip(np.round(w.numpy() / float(w_s)), -127,
                     127).astype(np.int8)
    cpu = [Observer(o.lo.cpu(), o.hi.cpu(), o.momentum)
           for o in (state.obs_in, state.obs_out)]
    in_s, in_zp = cpu[0].quint8_qparams(eager=True)
    out_s, out_zp = cpu[1].quint8_qparams(eager=True)
    return logreg.make_params(
        w_int8=w_int8, bias=float(state.b.detach().cpu()),
        w_scale=float(w_s), in_scale=float(in_s), in_zp=int(in_zp),
        out_scale=float(out_s), out_zp=int(out_zp), log1p=log_features)


# ---------------------------------------------------------------------------
# Reference state carried across
# ---------------------------------------------------------------------------

_STATE_KEYS = ("w", "b", "obs_in_lo", "obs_in_hi", "obs_out_lo",
               "obs_out_hi", "acc_w", "acc_b")


def state_from_numpy(d: dict, device="cpu", lr: float = 0.05) -> QatState:
    """A reference ``QatState`` as numpy arrays -> the port's, with an
    :class:`~.optim.Adagrad` holding its accumulators.  Keys: ``w``,
    ``b``, ``obs_in_lo``/``_hi``, ``obs_out_lo``/``_hi``, and ``acc_w``
    / ``acc_b`` (``opt_state[0].sum_of_squares``)."""
    t = {k: torch.from_numpy(np.array(d[k], np.float32)).to(device)
         for k in _STATE_KEYS}
    w, b = t["w"].clone(), t["b"].clone()
    opt = optim.Adagrad([w, b], lr)
    opt.state[w]["sum_of_squares"] = t["acc_w"]
    opt.state[b]["sum_of_squares"] = t["acc_b"]
    return QatState(w, b, Observer(t["obs_in_lo"], t["obs_in_hi"]),
                    Observer(t["obs_out_lo"], t["obs_out_hi"]), opt)


def state_to_numpy(state: QatState) -> dict:
    """Inverse of :func:`state_from_numpy` (accumulators absent before
    the optimizer's first step come back as its initial value)."""
    def acc(p):
        s = state.opt.state[p].get("sum_of_squares")
        init = state.opt.param_groups[0].get("initial_accumulator_value", 0)
        return (np.full(p.shape, init, np.float32) if s is None
                else s.cpu().numpy())

    def np32(t):
        return t.detach().cpu().numpy().astype(np.float32)

    return {"w": np32(state.w), "b": np32(state.b),
            "obs_in_lo": np32(state.obs_in.lo),
            "obs_in_hi": np32(state.obs_in.hi),
            "obs_out_lo": np32(state.obs_out.lo),
            "obs_out_hi": np32(state.obs_out.hi),
            "acc_w": acc(state.w), "acc_b": acc(state.b)}


# ---------------------------------------------------------------------------
# Float trainers (MLP families)
# ---------------------------------------------------------------------------


def _minibatch_adam(family, loss_of_logits, X, labels, epochs, batch_size,
                    lr, hidden, seed, device, step_log=None, grads_fn=None):
    """Minibatch Adam over bf16 params, the reference's batches: one
    ``default_rng(seed).permutation`` per epoch, chunks of
    ``batch_size`` in order.  ``family`` is ``models.mlp`` or
    ``models.multiclass``; the init is its ``init_params(PRNGKey(seed))``
    (the port's threefry).  ``step_log`` (a list) receives every step's
    loss as a device tensor.  Returns ``(params, losses)``, the params as
    the family's serving params (f32 tensors of bf16 values).

    The six leaves live in one flat bf16 buffer, so Adam (elementwise,
    one step count) runs once per step over all of them; each step takes
    detached views of it as the leaves.  The weight gradients are
    autograd's; the bias gradients are the reference's bf16 sums of the
    pre-activations' gradients (:func:`~..models.mlp.xla_batch_sum`, the
    three biases side by side in one call).  ``grads_fn(p, xt, labels)
    -> (loss, grads)`` replaces autograd with a written-out backward
    (the multiclass family's, :func:`~..models.multiclass.train_grads`)."""
    from flowsentryx_tpu_torch.core import prng
    from flowsentryx_tpu_torch.models import mlp

    dev = resolve_device(device)
    xt = mlp.transform(torch.from_numpy(
        np.ascontiguousarray(X, np.float32)).to(dev)).to(torch.bfloat16)
    lab = torch.from_numpy(np.asarray(labels)).to(dev)
    served = family.init_params(prng.prng_key(seed), hidden, dev)
    cls, shapes = type(served), [t.shape for t in served]
    sizes = [t.numel() for t in served]
    flat = torch.cat([t.reshape(-1) for t in served]).to(torch.bfloat16)
    opt = optim.Adam([flat], lr)
    n = len(X)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(dev)
        for s in range(0, n, batch_size):
            idx = order[s:s + batch_size]
            views = [v.view(shape) for v, shape in
                     zip(flat.split(sizes), shapes)]
            if grads_fn is not None:
                loss, g = grads_fn(cls(*views), xt[idx], lab[idx])
                flat.grad = torch.cat([t.reshape(-1) for t in g])
            else:
                p = cls(*(v.detach().requires_grad_() for v in views))
                lg, acts = mlp.train_forward(p, xt[idx])
                loss = loss_of_logits(lg, lab[idx])
                gw1, gw2, gw3, *ga = torch.autograd.grad(
                    loss, [p.w1, p.w2, p.w3, *acts])
                gb = mlp.xla_batch_sum(torch.cat(ga, dim=1)).split(
                    [p.b1.numel(), p.b2.numel(), p.b3.numel()])
                flat.grad = torch.cat([gw1.reshape(-1), gb[0],
                                       gw2.reshape(-1), gb[1],
                                       gw3.reshape(-1), gb[2]])
            opt.step()
            if step_log is not None:
                step_log.append(loss.detach())
        losses.append(float(loss.detach()))
    return (cls(*(v.view(shape).float() for v, shape in
                  zip(flat.split(sizes), shapes))),
            np.asarray(losses, np.float32))


def train_mlp(X: np.ndarray, y: np.ndarray, epochs: int = 100,
              batch_size: int = 4096, lr: float = 1e-3, hidden: int = 32,
              seed: int = 0, device=None, step_log=None):
    """Minibatch Adam for the MLP family (``models/mlp.py``)."""
    from flowsentryx_tpu_torch.models import mlp

    return _minibatch_adam(
        mlp, lambda lg, lab: mlp.bce_mean(lg[:, 0], lab), X,
        np.asarray(y, np.float32), epochs, batch_size, lr, hidden, seed,
        device, step_log)


def train_multiclass(X: np.ndarray, y_class: np.ndarray, epochs: int = 60,
                     batch_size: int = 4096, lr: float = 1e-3,
                     hidden: int = 32, seed: int = 0, device=None,
                     step_log=None):
    """Minibatch Adam for the per-attack-class expert heads."""
    from flowsentryx_tpu_torch.models import multiclass

    return _minibatch_adam(multiclass, multiclass.softmax_ce_mean, X,
                           np.asarray(y_class, np.int32), epochs, batch_size,
                           lr, hidden, seed, device, step_log,
                           grads_fn=multiclass.train_grads)
