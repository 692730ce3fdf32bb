"""Common-coin-flip(v) — the paper's §3.2.1 primitive.

Every replica holds the same seed; the view-v leader is a PRNG draw keyed
by (seed, v). The reference draws it with ``jax.random``; the port computes
the same bits on the host with numpy uint32 arithmetic: JAX's threefry2x32
hash, ``PRNGKey``, ``fold_in``, ``split`` and ``randint``. ``coin_table``
pre-generates the coins of every view once per ``init_state``, so the draw
never enters the tick.

``partitionable`` selects JAX's ``jax_threefry_partitionable`` bit stream
(the default of current JAX) or the older one. ``common_coin_flip`` draws
one view's coin on the host, for the training control plane
(``runtime/sporades_rt.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) on uint32 arrays; returns the
    two output words."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):      # uint32 arithmetic wraps
        x = [np.asarray(x1, np.uint32) + ks[0],
             np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` as its two uint32 words."""
    return (np.uint32((seed >> 32) & 0xFFFFFFFF),
            np.uint32(seed & 0xFFFFFFFF))


def fold_in(key, data):
    """``jax.random.fold_in``; ``data`` may be a uint32 array (one key per
    element)."""
    data = np.asarray(data, np.uint32)
    return threefry2x32(key[0], key[1], np.zeros_like(data), data)


def split2(key, partitionable: bool = True):
    """``jax.random.split(key, 2)`` -> (key0, key1)."""
    if partitionable:
        zero = np.zeros_like(key[0])
        k0 = threefry2x32(key[0], key[1], zero, zero)
        k1 = threefry2x32(key[0], key[1], zero, zero + np.uint32(1))
        return k0, k1
    # counts iota(4) hashed as pairs (0, 2) and (1, 3), output words
    # concatenated and reshaped to (2, 2)
    a = threefry2x32(key[0], key[1], np.zeros_like(key[0]),
                     np.zeros_like(key[0]) + np.uint32(2))
    b = threefry2x32(key[0], key[1], np.zeros_like(key[0]) + np.uint32(1),
                     np.zeros_like(key[0]) + np.uint32(3))
    return (a[0], b[0]), (a[1], b[1])


def random_bits32(key, partitionable: bool = True) -> np.ndarray:
    """One 32-bit draw of ``jax.random.bits(key, ())``."""
    zero = np.zeros_like(key[0])
    o0, o1 = threefry2x32(key[0], key[1], zero, zero)
    return o0 ^ o1 if partitionable else o0


def randint(key, n: int, partitionable: bool = True) -> np.ndarray:
    """``jax.random.randint(key, (), 0, n)`` (int32)."""
    k_hi, k_lo = split2(key, partitionable)
    hi = random_bits32(k_hi, partitionable)
    lo = random_bits32(k_lo, partitionable)
    span = np.uint32(n)
    mult = np.uint32((1 << 16) % n)
    mult = np.uint32((int(mult) * int(mult)) % n)
    off = ((hi % span) * mult + lo % span) % span
    return off.astype(np.int32)


def common_coin_flip(v: int, n: int, seed: int = 0) -> np.int32:
    """Deterministic uniform int in [0, n) for view ``v``: the reference's
    ``common_coin_flip`` (``randint(fold_in(PRNGKey(seed), v), (), 0, n)``)
    as a numpy int32, equal to ``coin_table_np(V, n, seed)[v]``."""
    key = fold_in(prng_key(seed), np.uint32(v))
    return randint(key, n)


def coin_table_np(max_views: int, n: int, seed: int = 0,
                  partitionable: bool = True) -> np.ndarray:
    """Coins for views [0, max_views): [max_views] int32."""
    keys = fold_in(prng_key(seed), np.arange(max_views, dtype=np.uint32))
    return randint(keys, n, partitionable)


def coin_table(max_views: int, n: int, seed: int = 0, device=None
               ) -> torch.Tensor:
    """Pre-generated coins for views [0, max_views) as an int64 tensor on
    ``device`` — the paper's 'pre-generate random numbers for each view
    number' implementation — from JAX's default (partitionable) threefry
    stream."""
    return _device.to_device(coin_table_np(max_views, n, seed).astype(
        np.int64), "cpu" if device is None else device)
