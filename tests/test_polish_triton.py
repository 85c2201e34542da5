"""Triton polish-scoring kernel vs the jnp scan formulation (interpret
mode), and the on-device convergence loop around it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flye_jax.ops import polish as P
from flye_jax.ops import polish_triton as T


def _lanes(branches, blen, bmask):
    """Pad to 8-branch groups, one group per scoring lane."""
    B, R, S = branches.shape
    g = max(1, -(-R // 8))
    pad = g * 8 - R
    br = np.pad(branches, ((0, 0), (0, pad), (0, 0))).reshape(B * g, 8, S)
    bl = np.pad(blen, ((0, 0), (0, pad))).reshape(B * g, 8)
    bm = np.pad(bmask, ((0, 0), (0, pad))).reshape(B * g, 8)
    return g, br, bl, bm


def _triton_raw(cand, clen, br, bl, bm, subs):
    Bg, _, S = br.shape
    tables = T.prepare(jnp.asarray(br), jnp.asarray(bl), jnp.asarray(bm),
                       jnp.asarray(subs), T.padded_lanes(Bg, S))
    return T.score(jnp.asarray(cand), jnp.asarray(clen), jnp.asarray(subs),
                   tables, interpret=True)


@pytest.mark.parametrize("seed,shape", [
    (0, (5, 24, 3, 40)),     # W=64, one padded group
    (3, (5, 24, 3, 40)),
    (1, (4, 20, 12, 28)),    # W=32, 12 branches -> 2 groups
    (2, (4, 20, 18, 60)),    # W=64, 18 branches -> 3 groups + pad
    (5, (3, 16, 5, 130)),    # W=256, one lane per program
])
def test_score_edits_matches_jnp(seed, shape):
    rng = np.random.default_rng(seed)
    B, Cb, R, S = shape
    cand = rng.integers(0, 4, (B, Cb)).astype(np.uint8)
    clen = rng.integers(10, Cb + 1, B).astype(np.int32)
    branches = rng.integers(0, 4, (B, R, S)).astype(np.uint8)
    blen = rng.integers(8, S + 1, (B, R)).astype(np.int32)
    bmask = rng.random((B, R)) < 0.8
    bmask[:, 0] = True
    subs = np.log(rng.random((5, 5)) * 0.5 + 0.01).astype(np.float32)

    g, br, bl, bm = _lanes(branches, blen, bmask)
    cand_s, clen_s = np.repeat(cand, g, 0), np.repeat(clen, g, 0)
    ref_raw = P._score_edits_raw_jnp(
        jnp.asarray(cand_s), jnp.asarray(clen_s), jnp.asarray(br),
        jnp.asarray(bl), jnp.asarray(bm), jnp.asarray(subs))
    raw = _triton_raw(cand_s, clen_s, br, bl, bm, subs)
    ref = P._finish_scores(jnp.asarray(cand), jnp.asarray(clen), *ref_raw,
                           groups=g)
    out = P._finish_scores(jnp.asarray(cand), jnp.asarray(clen), *raw,
                           groups=g)
    names = ["total", "del", "ins", "ins_chr", "sub", "sub_chr"]
    for name, r, o in zip(names, ref, out):
        r, o = np.asarray(r), np.asarray(o)
        assert r.shape == o.shape, name
        if name.endswith("chr"):
            np.testing.assert_array_equal(r, o, err_msg=name)
        else:
            finite = r > -1e29
            assert np.array_equal(finite, o > -1e29), name
            diff = np.abs(np.where(finite, r - o, 0)).max()
            assert diff < 1e-3, (name, diff)


@pytest.mark.parametrize("R", [3, 24])
def test_converge_triton_matches_xla(R):
    """The full on-device hill climb with the interpret-mode kernel ends
    where the host-stepped loop around the XLA-compiled jnp scorer
    does, and fixes the planted errors."""
    rng = np.random.default_rng(7)
    B, C, Cb, S = 4, 30, 40, 60
    true = rng.integers(0, 4, (B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    for i in range(B):
        idx = rng.integers(0, C, 2)
        cand[i, idx] = (cand[i, idx] + 1) % 4
    clen = np.full(B, C, np.int32)
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :C] = true[:, None, :]
    blen = np.full((B, R), C, np.int32)
    bmask = np.ones((B, R), bool)
    subs = np.log(np.full((5, 5), 0.05, np.float32))
    np.fill_diagonal(subs[:4, :4], np.log(0.8))

    o_x = P.polish_bubbles(cand, clen, branches, blen, bmask, subs,
                           max_iters=24, route="stepped")
    g, br, bl, bm = _lanes(branches, blen, bmask)
    prog = P._converge_program(None, g, 64, True, 24, interpret=True)
    o_t = prog(*(jnp.asarray(a) for a in (cand, clen, br, bl, bm, subs)))
    for a, b in zip(o_x, o_t):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for i in range(B):
        n = int(o_t[1][i])
        assert n == C
        np.testing.assert_array_equal(np.asarray(o_t[0][i][:n]), true[i])


def test_block_size_choice():
    """Rows pad to a power of two >= S+1; a program's tile holds about
    TILE_ELEMS f32 per live row plane (>= 1 lane), and the lane batch
    pads to whole tiles."""
    assert T.row_width(40) == 64
    assert T.row_width(63) == 64
    assert T.row_width(96) == 128
    assert T.row_width(240) == 256
    assert T.row_width(8) == 16
    for S in (31, 63, 96, 127, 240, 576, 2304):
        W = T.row_width(S)
        tb = T.tile_lanes(W)
        assert tb >= 1
        assert tb * 8 * W <= max(T.TILE_ELEMS, 8 * W)
        assert T.padded_lanes(1000, S) % tb == 0
        assert 0 <= T.padded_lanes(1000, S) - 1000 < tb
    assert T.tile_lanes(64) == 4
    assert T.tile_lanes(4096) == 1


@pytest.mark.gpu
def test_score_on_gpu(gpu_device):
    """Compiled for the card: scores of one pass at the dominant
    production bucket within float32 rounding of the CPU jnp scorer."""
    rng = np.random.default_rng(11)
    B, Cb, S = 512, 64, 96
    cand = rng.integers(0, 4, (B, Cb)).astype(np.uint8)
    clen = np.full(B, 44, np.int32)
    br = rng.integers(0, 4, (B, 8, S)).astype(np.uint8)
    bl = rng.integers(30, 50, (B, 8)).astype(np.int32)
    bm = rng.random((B, 8)) < 0.9
    subs = np.log(rng.random((5, 5)) * 0.5 + 0.01).astype(np.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = P._score_edits_raw_jnp(cand, clen, br, bl, bm, subs)
    with jax.default_device(gpu_device):
        tables = T.prepare(jnp.asarray(br), jnp.asarray(bl),
                           jnp.asarray(bm), jnp.asarray(subs),
                           T.padded_lanes(B, S))
        out = T.score(jnp.asarray(cand), jnp.asarray(clen),
                      jnp.asarray(subs), tables)
    for r, o in zip(ref, out):
        r, o = np.asarray(r), np.asarray(o)
        finite = r > -1e29
        err = np.abs(np.where(finite, r - o, 0))
        assert (err <= np.maximum(1e-4, 1e-5 * np.abs(r))).all()


@pytest.mark.parametrize("route", ["stepped", "triton"])
def test_converge_sharded_matches_single(route):
    """Over a 4-device mesh each device climbs its slice of the batch;
    the result equals the one-device climb (the on-device loop with the
    interpret-mode kernel, and the host-stepped reference loop)."""
    from flye_jax.parallel.mesh import make_mesh
    from flye_jax.parallel.runtime import (ParallelContext, get_runtime,
                                           set_runtime)
    rng = np.random.default_rng(5)
    B, C, Cb, R, S = 8, 20, 32, 12, 40
    true = rng.integers(0, 4, (B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    cand[:, 5] = (cand[:, 5] + 1) % 4
    clen = np.full(B, C, np.int32)
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :C] = true[:, None, :]
    blen = np.full((B, R), C, np.int32)
    bmask = np.ones((B, R), bool)
    subs = np.log(np.full((5, 5), 0.05, np.float32))
    np.fill_diagonal(subs[:4, :4], np.log(0.8))
    mesh = make_mesh(4, axes=("data",))
    if route == "triton":
        g, br, bl, bm = _lanes(branches, blen, bmask)
        args = [jnp.asarray(a) for a in (cand, clen, br, bl, bm, subs)]
        one = P._converge_program(None, g, 64, True, 16,
                                  interpret=True)(*args)
        many = P._converge_program(mesh, g, 64, True, 16,
                                   interpret=True)(*args)
    else:
        args = (cand, clen, branches, blen, bmask, subs)
        prev = get_runtime()
        try:
            set_runtime(ParallelContext())
            one = P.polish_bubbles(*args, max_iters=16, route="stepped")
            set_runtime(ParallelContext(mesh))
            many = P.polish_bubbles(*args, max_iters=16, route="stepped")
        finally:
            set_runtime(prev)
    for a, b in zip(one, many):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_lowers_for_cuda():
    """The scoring kernel and the convergence loop around it pass the
    Pallas->Triton lowering for the card; no card is needed (the PTX
    compile happens only on one)."""
    B, Cb, S = 64, 24, 40
    cand = jnp.zeros((B, Cb), jnp.uint8)
    clen = jnp.full((B,), 16, jnp.int32)
    br = jnp.zeros((B, 8, S), jnp.uint8)
    bl = jnp.full((B, 8), 16, jnp.int32)
    bm = jnp.ones((B, 8), bool)
    subs = jnp.zeros((5, 5), jnp.float32)

    def score(cand, clen, br, bl, bm, subs):
        tables = T.prepare(br, bl, bm, subs, T.padded_lanes(B, S))
        return T.score(cand, clen, subs, tables)

    low = jax.jit(score).trace(cand, clen, br, bl, bm, subs).lower(
        lowering_platforms=("cuda",))
    assert "@__gpu$xla.gpu.triton" in low.as_text()
    prog = P._converge_program(None, 4, 64, True, 16)
    low = prog.trace(cand[:16], clen[:16], br, bl, bm, subs).lower(
        lowering_platforms=("cuda",))
    assert "@__gpu$xla.gpu.triton" in low.as_text()


def test_cummax_rule_names_jax_version(monkeypatch):
    """A JAX whose private Triton lowering lacks what the cummax rule
    builds on fails with the tested and the found version, not with an
    error deep inside the lowering."""
    from jax._src.pallas.triton import lowering as tl
    monkeypatch.delattr(tl, "lower_jaxpr_to_triton_ir")
    with pytest.raises(RuntimeError, match=T.TESTED_JAX):
        T._register_cummax()
