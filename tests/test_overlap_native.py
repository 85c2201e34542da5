"""The native batch path (chain_group_prep + finish_overlaps) must be
byte-identical to the pure-Python fallback in overlap/engine.py
(reference analog: src/sequence/overlap.cpp:99-427 — the reference runs
these loops in C++ too; determinism across implementations is the
engine's north star)."""

import numpy as np
import pytest

import flye_jax.native as native
from flye_jax.index import KmerIndex
from flye_jax.io import SequenceStore
from flye_jax.overlap import OverlapEngine
from flye_jax.utils.simulate import random_genome, simulate_reads


@pytest.fixture(scope="module")
def noisy_store():
    genome = random_genome(24000, seed=21)
    reads = simulate_reads(genome, coverage=10, mean_length=4000,
                           min_length=1500, error_rate=0.06,
                           circular=False, seed=22)
    store = SequenceStore()
    for name, codes in reads:
        store.add(name, codes)
    return store


def _engine(store, **kw):
    idx = KmerIndex.build_minimizers(store, 15, 5)
    return OverlapEngine(store, idx, max_jump=1500, min_overlap=1000,
                         max_overhang=1500, **kw)


def _as_tuples(res):
    out = {}
    for sid, ovlps in res.items():
        out[sid] = [(o.cur_id, o.ext_id, o.cur_begin, o.cur_end,
                     o.cur_len, o.ext_begin, o.ext_end, o.ext_len,
                     o.score, round(o.divergence, 12),
                     o.kmer_matches.tolist()) for o in ovlps]
    return out


@pytest.mark.parametrize("mode", ["only_max_ext", "all_primaries"])
def test_native_batch_matches_python(noisy_store, monkeypatch, mode):
    assert native.get() is not None, "native module must build"
    store = noisy_store
    kw = dict(only_max_ext=(mode == "only_max_ext"))
    sids = store.ids()[:40]

    eng_nat = _engine(store, **kw)
    res_nat = eng_nat.get_overlaps_batch(store, sids)

    eng_py = _engine(store, **kw)
    monkeypatch.setattr(native, "get", lambda: None)
    res_py = eng_py.get_overlaps_batch(store, sids)
    monkeypatch.undo()

    assert _as_tuples(res_nat) == _as_tuples(res_py)
    # divergence stat windows feed the auto-threshold: must match too
    assert np.allclose(sorted(eng_nat.div_stats), sorted(eng_py.div_stats))


def test_native_batch_max_overlaps_cap(noisy_store, monkeypatch):
    store = noisy_store
    sids = store.ids()[:24]
    eng_nat = _engine(store, only_max_ext=True)
    res_nat = eng_nat.get_overlaps_batch(store, sids, max_overlaps=3)
    eng_py = _engine(store, only_max_ext=True)
    monkeypatch.setattr(native, "get", lambda: None)
    res_py = eng_py.get_overlaps_batch(store, sids, max_overlaps=3)
    monkeypatch.undo()
    assert _as_tuples(res_nat) == _as_tuples(res_py)
    assert all(len(v) <= 3 + 1 for v in res_nat.values())


def test_native_device_bucket_path(noisy_store, monkeypatch):
    """Forcing a tiny host_dp_max pushes groups through the bucketed
    device-DP path; results must still match the Python fallback (which
    always uses the bucketed device DP)."""
    store = noisy_store
    sids = store.ids()[:16]
    eng_nat = _engine(store, only_max_ext=True)
    eng_nat.host_dp_max = 16  # almost everything -> device buckets
    res_nat = eng_nat.get_overlaps_batch(store, sids)
    eng_py = _engine(store, only_max_ext=True)
    monkeypatch.setattr(native, "get", lambda: None)
    res_py = eng_py.get_overlaps_batch(store, sids)
    monkeypatch.undo()
    assert _as_tuples(res_nat) == _as_tuples(res_py)


def test_chain_dp_host_matches_scan():
    """chain_dp_host must be bit-identical to the device scan oracle
    for groups within the lookback window."""
    import numpy as np

    from flye_jax.ops.chain import _chain_dp_scan

    mod = native.get()
    rng = np.random.default_rng(3)
    k, max_jump = 15, 1500
    glens = [1, 2, 7, 33, 200]
    gcur_l, gext_l = [], []
    for m in glens:
        c = np.sort(rng.integers(0, 20000, m)).astype(np.int32)
        e = (c + 300 + rng.integers(-200, 200, m)).astype(np.int32)
        gcur_l.append(c)
        gext_l.append(e)
    gcur = np.concatenate(gcur_l)
    gext = np.concatenate(gext_l)
    gstart = np.zeros(len(glens), np.int64)
    gstart[1:] = np.cumsum(glens)[:-1]
    scoff_b, hs_b, hp_b = mod.chain_dp_host(
        gcur, gext, gstart, np.asarray(glens, np.int64), len(glens),
        k, max_jump)
    hs = np.frombuffer(hs_b, np.int32)
    hp = np.frombuffer(hp_b, np.int32)
    scoff = np.frombuffer(scoff_b, np.int64)
    for i, m in enumerate(glens):
        cur = np.zeros((1, m), np.int32)
        ext = np.zeros((1, m), np.int32)
        cur[0] = gcur_l[i]
        ext[0] = gext_l[i]
        s, p = _chain_dp_scan(cur, ext, np.asarray([m], np.int32),
                              k, max_jump, m)
        np.testing.assert_array_equal(np.asarray(s)[0],
                                      hs[scoff[i]:scoff[i] + m])
        np.testing.assert_array_equal(np.asarray(p)[0],
                                      hp[scoff[i]:scoff[i] + m])
