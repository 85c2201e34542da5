import numpy as np
import pytest

from flye_jax.ops.align import (SegmentBatcher, anchored_divergence,
                                edit_distance_batch, hpc_compress)
from flye_jax.ops.chain import backtrack_chains, chain_dp


def oracle_chain(cur, ext, k, max_jump):
    """Reference DP semantics (full lookback, latest-j tie-break)."""
    n = len(cur)
    score = np.full(n, k, dtype=np.int64)
    parent = np.full(n, -1, dtype=np.int64)
    for i in range(1, n):
        best, bestj = 0, -1
        for j in range(i):
            dc, de = cur[i] - cur[j], ext[i] - ext[j]
            if 0 < dc < max_jump and 0 < de < max_jump:
                match = min(dc, de, k)
                jd = abs(dc - de)
                gap = 2 * jd if jd > 100 else jd // 2
                s = score[j] + match - gap
                if s >= best:  # latest j wins ties
                    best, bestj = s, j
        score[i] = max(best, k)
        if best > k:
            parent[i] = bestj
    return score, parent


def random_matches(rng, n, noise=30, jump=80):
    cur = np.sort(rng.integers(0, 4000, size=n)).astype(np.int32)
    ext = (cur + 200 + rng.integers(-noise, noise, size=n)).astype(np.int32)
    return cur, ext


def test_chain_dp_vs_oracle(rng):
    k, max_jump = 15, 500
    T, M = 5, 60
    curs = np.zeros((T, M), np.int32)
    exts = np.zeros((T, M), np.int32)
    nv = np.zeros(T, np.int32)
    oracles = []
    for t in range(T):
        n = int(rng.integers(10, M + 1))
        cur, ext = random_matches(rng, n)
        curs[t, :n], exts[t, :n] = cur, ext
        nv[t] = n
        oracles.append(oracle_chain(cur, ext, k, max_jump))
    score, parent = (np.asarray(x) for x in
                     chain_dp(curs, exts, nv, k, max_jump, lookback=M))
    for t in range(T):
        oscore, oparent = oracles[t]
        np.testing.assert_array_equal(score[t, :nv[t]], oscore)
        np.testing.assert_array_equal(parent[t, :nv[t]], oparent)
        # padding rows zeroed
        assert (score[t, nv[t]:] == 0).all()
        assert (parent[t, nv[t]:] == -1).all()


def test_chain_dp_perfect_diagonal():
    # perfectly collinear matches chain into one long chain
    cur = np.arange(0, 300, 10, dtype=np.int32)[None, :]
    ext = cur + 500
    nv = np.array([cur.shape[1]], np.int32)
    score, parent = (np.asarray(x) for x in
                     chain_dp(cur, ext, nv, 15, 1500, lookback=64))
    chains = backtrack_chains(score[0], parent[0], int(nv[0]), 15)
    assert len(chains) == 1
    first, last, cscore, path = chains[0]
    assert first == 0 and last == cur.shape[1] - 1
    assert len(path) == cur.shape[1]
    assert path == sorted(path)


def test_backtrack_visited_marking():
    # two independent diagonals -> two chains, no shared matches
    cur = np.concatenate([np.arange(0, 100, 10), np.arange(2000, 2100, 10)])
    ext = np.concatenate([np.arange(0, 100, 10) + 50,
                          np.arange(2000, 2100, 10) + 5000])
    order = np.argsort(cur)
    cur, ext = cur[order].astype(np.int32), ext[order].astype(np.int32)
    nv = np.array([len(cur)], np.int32)
    score, parent = (np.asarray(x) for x in
                     chain_dp(cur[None], ext[None], nv, 15, 1500, lookback=32))
    chains = backtrack_chains(score[0], parent[0], int(nv[0]), 15)
    assert len(chains) == 2
    all_idx = [i for c in chains for i in c[3]]
    assert len(all_idx) == len(set(all_idx))


def oracle_lev(a, b):
    n, m = len(a), len(b)
    D = np.zeros((n + 1, m + 1), dtype=np.int64)
    D[:, 0] = np.arange(n + 1)
    D[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            D[i, j] = min(D[i - 1, j - 1] + (a[i - 1] != b[j - 1]),
                          D[i - 1, j] + 1, D[i, j - 1] + 1)
    return D[n, m]


def test_edit_distance_vs_oracle(rng):
    B, S = 8, 24
    a = rng.integers(0, 4, size=(B, S)).astype(np.uint8)
    b = rng.integers(0, 4, size=(B, S)).astype(np.uint8)
    al = rng.integers(0, S + 1, size=B).astype(np.int32)
    bl = rng.integers(0, S + 1, size=B).astype(np.int32)
    d = np.asarray(edit_distance_batch(a, al, b, bl))
    for t in range(B):
        assert d[t] == oracle_lev(a[t, :al[t]], b[t, :bl[t]]), t


def test_edit_distance_identical_and_empty():
    a = np.array([[0, 1, 2, 3, 0, 1, 2, 3]], dtype=np.uint8)
    d = np.asarray(edit_distance_batch(a, np.array([8], np.int32),
                                       a.copy(), np.array([8], np.int32)))
    assert d[0] == 0
    d = np.asarray(edit_distance_batch(a, np.array([0], np.int32),
                                       a, np.array([5], np.int32)))
    assert d[0] == 5


def test_hpc_compress():
    codes = np.array([0, 0, 0, 1, 1, 2, 0, 0], dtype=np.uint8)
    np.testing.assert_array_equal(hpc_compress(codes), [0, 1, 2, 0])


def test_anchored_divergence(rng):
    # two sequences identical except a few substitutions between anchors
    n = 400
    a = rng.integers(0, 4, size=n).astype(np.uint8)
    b = a.copy()
    mut = [50, 150, 250]
    for p in mut:
        b[p] = (b[p] + 1) % 4
    anchors = np.array([[0, 0], [100, 100], [200, 200], [300, 300],
                        [n - 1, n - 1]])
    div, per_seg, spans = anchored_divergence(a, b, anchors, k=15)
    assert per_seg.tolist() == [1, 1, 1, 0]
    assert div == pytest.approx(3 / (n - 1 + 15))


def test_segment_batcher_giant_segment(rng):
    batcher = SegmentBatcher()
    a = rng.integers(0, 4, size=2000).astype(np.uint8)
    i = batcher.add(a, a[:100])
    d = batcher.run()
    assert d[i] >= 1900  # mostly the length difference
