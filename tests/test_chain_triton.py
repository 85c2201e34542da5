"""Triton chain-DP kernel vs the lax.scan oracle (interpret mode)."""

import numpy as np
import pytest

from flye_jax.ops import chain_triton
from flye_jax.ops.chain import _chain_dp_scan
from flye_jax.ops.chain_triton import chain_dp_triton


def make_matches(T, M, rng, span=6000, noise=60):
    cur = np.sort(rng.integers(0, span, size=(T, M)), axis=1)
    ext = cur + 300 + rng.integers(-noise, noise, size=(T, M))
    nvalid = rng.integers(1, M + 1, size=T)
    return (cur.astype(np.int32), ext.astype(np.int32),
            nvalid.astype(np.int32))


@pytest.mark.parametrize("T,M,lookback", [
    (4, 96, 32),      # window narrower than the list
    (3, 128, 16),     # long walk, short window
    (2, 100, 48),     # window rounded up to 64 (masked slots)
    (9, 64, 64),      # full window
])
def test_triton_matches_scan(T, M, lookback, rng):
    k, max_jump = 15, 1500
    cur, ext, nvalid = make_matches(T, M, rng)
    s_ref, p_ref = _chain_dp_scan(cur, ext, nvalid, k, max_jump, lookback)
    s, p = chain_dp_triton(cur, ext, nvalid, k, max_jump, lookback,
                           interpret=True)
    np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s))
    np.testing.assert_array_equal(np.asarray(p_ref), np.asarray(p))


def test_triton_empty_rows(rng):
    k, max_jump, lookback = 15, 1500, 16
    cur, ext, _ = make_matches(2, 32, rng)
    nvalid = np.array([0, 32], np.int32)
    s_ref, p_ref = _chain_dp_scan(cur, ext, nvalid, k, max_jump, lookback)
    s, p = chain_dp_triton(cur, ext, nvalid, k, max_jump, lookback,
                           interpret=True)
    np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s))
    np.testing.assert_array_equal(np.asarray(p_ref), np.asarray(p))


def test_window_and_warps():
    """The window block is the lookback (or M) rounded up to a power of
    two; warps grow with it, 1 to 8."""
    assert chain_triton.window(1024, 16384) == 1024
    assert chain_triton.window(1024, 300) == 512
    assert chain_triton.window(48, 100) == 64
    assert chain_triton.window(1024, 1) == 1
    assert chain_triton.num_warps(1024) == 4
    assert chain_triton.num_warps(64) == 1
    assert chain_triton.num_warps(4096) == 8


@pytest.mark.gpu
def test_triton_on_gpu(gpu_device, rng):
    """Compiled for the card, bit-exact against the scan at the engine's
    widest bucket shape."""
    import jax
    k, max_jump = 15, 1500
    cur, ext, nvalid = make_matches(8, 4096, rng, span=200000)
    with jax.default_device(jax.devices("cpu")[0]):
        s_ref, p_ref = _chain_dp_scan(cur, ext, nvalid, k, max_jump, 1024)
    with jax.default_device(gpu_device):
        s, p = chain_dp_triton(cur, ext, nvalid, k, max_jump, 1024)
    np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s))
    np.testing.assert_array_equal(np.asarray(p_ref), np.asarray(p))


def test_lowers_for_cuda():
    """The kernel passes the Pallas->Triton lowering for the card at the
    widest device bucket; no card is needed."""
    import jax
    import jax.numpy as jnp
    cur = jnp.zeros((8, 16384), jnp.int32)
    nv = jnp.full((8,), 16384, jnp.int32)
    low = jax.jit(lambda c, e, n: chain_dp_triton(
        c, e, n, k=15, max_jump=1500, lookback=1024)).trace(
        cur, cur, nv).lower(lowering_platforms=("cuda",))
    assert "@__gpu$xla.gpu.triton" in low.as_text()
