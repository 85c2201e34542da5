"""Mesh sharding: the same global input must produce bit-identical
results regardless of device count (SURVEY §5.2 determinism north star —
integer reductions via psum are order-independent by construction)."""

import numpy as np
import pytest

from flye_jax.parallel import make_mesh, sharded_pipeline_step


def run_step(n_devices, codes, lengths, cur, ext, nmatch):
    import jax

    mesh = make_mesh(n_devices, axes=("data",))
    fn, _ = sharded_pipeline_step(mesh, k=15, w=5)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("data"))
    args = tuple(jax.device_put(x, sharding)
                 for x in (codes, lengths, cur, ext, nmatch))
    hist, score, parent, n_sel = fn(*args)
    return (np.asarray(hist), np.asarray(score), np.asarray(parent),
            int(n_sel))


def test_sharding_determinism(rng):
    B, L, M = 8, 256, 64
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = np.full(B, L, np.int32)
    cur = np.sort(rng.integers(0, 4000, size=(B, M)), axis=1).astype(
        np.int32)
    ext = (cur + 100).astype(np.int32)
    nmatch = np.full(B, M, np.int32)

    results = {}
    for n in (1, 2, 4, 8):
        results[n] = run_step(n, codes, lengths, cur, ext, nmatch)

    base = results[1]
    for n in (2, 4, 8):
        hist, score, parent, n_sel = results[n]
        np.testing.assert_array_equal(hist, base[0],
                                      err_msg=f"histogram differs at n={n}")
        np.testing.assert_array_equal(score, base[1])
        np.testing.assert_array_equal(parent, base[2])
        assert n_sel == base[3]
