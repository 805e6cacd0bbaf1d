"""The slice of ``jax.random`` that the reference's model init uses,
bit for bit, in numpy ``uint32``.

The reference draws the default ``mlp`` and ``multiclass`` params from
``jax.random.PRNGKey(0)``: it splits the key in three and scales
``jax.random.normal`` draws (``models/mlp.py::init_params``).  This module
reproduces that with jax's default generator as this repository's jax
configures it: threefry2x32 with ``jax_threefry_partitionable`` on, so a
draw's counter is its flat index, as a ``(hi, lo)`` pair of words.

* :func:`threefry2x32` — the 20-round block function (rotations
  ``[13, 15, 26, 6]`` and ``[17, 29, 16, 24]``, key schedule with the
  parity word ``k0 ^ k1 ^ 0x1BD11BDA``, ``i`` injected after round group
  ``i``);
* :func:`prng_key` — ``PRNGKey(seed)``: the words ``(seed >> 32,
  seed & 0xFFFFFFFF)``;
* :func:`split` — key ``i`` of ``n`` is the block of counter ``(0, i)``;
* :func:`bits` — the two words of each counter's block, XORed;
* :func:`uniform` — ``max(lo, f * (hi - lo) + lo)`` with ``f`` in
  [0, 1) from the top 23 bits;
* :func:`normal` — ``sqrt(2) * erf_inv(u)`` for ``u`` uniform in
  (-1, 1), with XLA:CPU's ``erf_inv``
  (:func:`~flowsentryx_tpu_torch.core.device.xla_erf_inv`).

The integer work is exact; the float steps are single float32 roundings
or go through the port's XLA:CPU helpers, so the draws equal the
reference's on this repository's jax (``tests/test_torch_prng.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from flowsentryx_tpu_torch.core.device import fma32, xla_erf_inv

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block of counters ``(x0, x1)`` under ``key`` (two
    ``uint32`` words): 5 groups of 4 rounds, the key injected before the
    first group and after each."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**64``: the
    ``uint32[2]`` key words."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The ``(hi, lo)`` words of the flat indices ``0 .. n-1``."""
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: ``uint32[n, 2]``."""
    x0, x1 = threefry2x32(key, *_counters(n))
    return np.stack([x0, x1], axis=1)


def bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (32-bit words)."""
    x0, x1 = threefry2x32(key, *_counters(int(np.prod(shape))))
    return (x0 ^ x1).reshape(shape)


def uniform(key: np.ndarray, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 bits as the mantissa of a float in [1, 2), minus 1, scaled
    into ``[minval, maxval)`` with one rounding, clamped below."""
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    f = ((bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    # f * span + lo with one rounding (the reference's graph fuses it)
    v = fma32(torch.from_numpy(f), float(span), float(lo)).numpy()
    return np.maximum(lo, v)


def normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: ``sqrt(2) *
    erf_inv(u)`` with ``u`` uniform in ``[nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    e = xla_erf_inv(torch.from_numpy(u)).numpy()
    return np.float32(np.sqrt(2.0)) * e
