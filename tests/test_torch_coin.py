"""The port's common coin (host numpy threefry2x32 / fold_in / randint,
repro_torch.core.coin) equals the reference's jax.random coin table
exactly."""
import jax
import numpy as np
import pytest
import torch

from repro.core.coin import coin_table as jax_coin_table
from repro_torch.core.coin import coin_table, coin_table_np


@pytest.mark.parametrize("n", range(3, 10))
def test_coin_table_matches_reference(n):
    ref = np.asarray(jax_coin_table(4096, n))
    got = coin_table(4096, n, device="cpu")
    assert got.dtype == torch.int64 and got.shape == (4096,)
    np.testing.assert_array_equal(ref, got.numpy())
    assert got.min() >= 0 and got.max() < n


@pytest.mark.parametrize("seed", [1, 12345])
def test_coin_table_other_seeds(seed):
    np.testing.assert_array_equal(
        np.asarray(jax_coin_table(512, 5, seed=seed)),
        coin_table_np(512, 5, seed=seed))


def test_coin_table_matches_unpartitionable_stream():
    """The older (non-partitionable) threefry bit stream too."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        ref = np.asarray(jax_coin_table(1024, 7))
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    np.testing.assert_array_equal(
        ref, coin_table_np(1024, 7, partitionable=False))
