"""Per-platform route choice, device-memory batch sizing, exact table
gathers and compile-cache placement (all CPU-side logic)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from flye_jax.ops import routes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("plat,polish,chain,mesh", [
    ("cpu", "native", "scan", 8),
    ("gpu", "triton", "triton", 1),
])
def test_route_per_platform(plat, polish, chain, mesh):
    assert routes.polish_route(plat) == polish
    assert routes.chain_route(plat) == chain
    # default mesh over 8 visible devices: all CPU devices, one card
    assert routes.default_mesh_size(8, plat) == mesh


def test_routes_name_implementations():
    """Every route a platform picks has an implementation behind it."""
    from flye_jax.ops import chain, polish
    for plat in ("cpu", "gpu"):
        assert routes.chain_route(plat) in chain._CHAIN
        assert routes.polish_route(plat) in polish.ROUTES


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,expected", [
    ({"bytes_limit": 60 << 30, "bytes_in_use": 0}, 60 << 30),
    (None, 0),
    ({}, 0),
])
def test_device_memory_limit(monkeypatch, stats, expected):
    import jax
    monkeypatch.setattr(jax, "local_devices",
                        lambda: [_FakeDevice(stats)])
    assert routes.device_memory_limit() == expected


@pytest.mark.parametrize("limit,bucket,expected", [
    # 60 GiB card: only the kernel's streamed B rows scale with the
    # bucket; small buckets hit the 8192 cap
    (60 << 30, (24, 40, 32), 8192),
    (60 << 30, (32, 31, 8), 8192),
    (60 << 30, (64, 96, 56), 4096),
    (60 << 30, (160, 240, 56), 1024),
    (60 << 30, (384, 576, 56), 128),
    (16 << 30, (64, 96, 56), 1024),
    # no reported limit (CPU): the 1 GB budget, capped at 512
    (0, (64, 96, 8), 512),
    (0, (160, 240, 56), 20),
])
def test_polish_batch_from_memory(monkeypatch, limit, bucket, expected):
    from flye_jax.polishing import polisher
    monkeypatch.setattr(routes, "device_memory_limit", lambda: limit)
    cb, sb, rb = bucket
    got = polisher._max_batch(cb, sb, rb)
    assert got == expected
    if limit:
        assert got & (got - 1) == 0          # power of two
        assert got * polisher._lane_bytes(cb, sb, rb) <= \
            limit * routes.POLISH_MEMORY_SHARE


def test_branch_tables_exact_against_float64():
    """Match planes are exact gathers of the substitution table (no
    reduced-precision contraction); gap sums match float64 to float32
    rounding."""
    import jax.numpy as jnp

    from flye_jax.ops.polish import _branch_tables
    rng = np.random.default_rng(0)
    B, R, S = 6, 8, 50
    br = rng.integers(0, 4, (B, R, S)).astype(np.uint8)
    bl = rng.integers(10, S + 1, (B, R)).astype(np.int32)
    subs = np.log(rng.random((5, 5)) * 0.9 + 0.01)          # float64
    sw, gp, sg = (np.asarray(x) for x in _branch_tables(
        jnp.asarray(br), jnp.asarray(bl), jnp.asarray(subs, jnp.float32)))
    sub32 = subs.astype(np.float32)
    for x in range(4):
        np.testing.assert_array_equal(sw[x], sub32[x][br])
    gap = np.where(np.arange(S)[None, None] < bl[:, :, None],
                   subs[4][br], 0.0)
    gp64 = np.concatenate([np.zeros((B, R, 1)), np.cumsum(gap, 2)], 2)
    np.testing.assert_allclose(gp, gp64, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sg, gp64[:, :, -1:] - gp64, rtol=1e-5,
                               atol=1e-4)


def _cache_dir(env):
    code = ("import flye_jax, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in env.items()}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_from_env(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert _cache_dir(env) == str(tmp_path)


def test_compile_cache_default_in_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    assert _cache_dir(env) == os.path.join(REPO, ".jax_cache")
