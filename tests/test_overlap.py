import re

import numpy as np
import pytest

from flye_jax.index import KmerIndex
from flye_jax.io import SequenceStore
from flye_jax.io.seqstore import SeqId
from flye_jax.overlap import Overlap, OverlapEngine, OverlapStore
from flye_jax.utils.simulate import random_genome, simulate_reads


def parse_name(name):
    m = re.match(r"sim_\d+_pos(\d+)_len(\d+)([+-])", name)
    return int(m.group(1)), int(m.group(2)), m.group(3)


def true_overlap_len(store, a, b, glen):
    """Expected genome-interval intersection of two simulated reads
    (linear genome, no wraparound in these tests)."""
    s1, l1, _ = parse_name(store.name(a))
    s2, l2, _ = parse_name(store.name(b))
    return min(s1 + l1, s2 + l2) - max(s1, s2)


def build_engine(store, k=15, w=5, min_overlap=1000, **kw):
    idx = KmerIndex.build_minimizers(store, k, w)
    return OverlapEngine(store, idx, max_jump=1500, min_overlap=min_overlap,
                         max_overhang=1500, **kw)


@pytest.fixture(scope="module")
def sim_setup():
    genome = random_genome(20000, seed=11)
    reads = simulate_reads(genome, coverage=8, mean_length=4000,
                           min_length=1500, error_rate=0.0, circular=False,
                           seed=12)
    store = SequenceStore()
    for name, codes in reads:
        store.add(name, codes)
    return genome, store


def test_overlaps_error_free(sim_setup):
    genome, store = sim_setup
    eng = build_engine(store)
    ost = OverlapStore(eng, store)
    ids = store.ids()
    # pick a read with known large true overlaps
    found_pairs = set()
    for sid in ids:
        for ov in ost.lazy_overlaps(sid):
            found_pairs.add((sid & ~1, ov.ext_id & ~1))
            # coordinates must describe (near-)identical sequence
            assert ov.cur_range >= 1000
            assert abs(ov.cur_range - ov.ext_range) < 100
            assert ov.divergence < 0.05
    # every pair with true overlap >= 2000 must be found
    missed = 0
    total = 0
    for i, a in enumerate(ids):
        for b in ids[i + 1:]:
            t = true_overlap_len(store, a, b, len(genome))
            if t >= 2000:
                total += 1
                if ((a, b) not in found_pairs and (b, a) not in found_pairs):
                    missed += 1
    assert total > 10
    assert missed == 0, f"missed {missed}/{total} true overlaps"


def test_overlap_coordinates_error_free(sim_setup):
    genome, store = sim_setup
    eng = build_engine(store)
    ids = store.ids()
    sid = ids[0]
    ovlps = eng.get_overlaps(store, sid)
    assert ovlps
    for ov in ovlps:
        # overlapping subsequences must be highly similar: compare directly
        a = store.get(ov.cur_id)[ov.cur_begin:ov.cur_end]
        b = store.get(ov.ext_id)[ov.ext_begin:ov.ext_end]
        n = min(len(a), len(b))
        ident = (a[:n] == b[:n]).mean()
        assert ident > 0.95, (ov, ident)


def test_overlaps_with_errors():
    genome = random_genome(15000, seed=21)
    reads = simulate_reads(genome, coverage=10, mean_length=4000,
                           min_length=1500, error_rate=0.06, circular=False,
                           seed=22)
    store = SequenceStore()
    for name, codes in reads:
        store.add(name, codes)
    eng = build_engine(store, k=15, w=5)
    ost = OverlapStore(eng, store)
    n_ovlps = 0
    for sid in store.ids():
        for ov in ost.lazy_overlaps(sid):
            n_ovlps += 1
            assert ov.divergence < 0.25
    # plenty of overlaps must be found despite 6% errors
    assert n_ovlps >= len(store)


def test_complement_symmetry(sim_setup):
    genome, store = sim_setup
    eng = build_engine(store)
    sid = store.ids()[1]
    fwd = eng.get_overlaps(store, sid)
    rev = eng.get_overlaps(store, SeqId(sid).rc)
    assert len(fwd) == len(rev)
    fwd_keys = {(o.ext_id, o.cur_begin, o.cur_end) for o in fwd}
    rev_keys = {(SeqId(o.ext_id).rc,
                 o.cur_len - o.cur_end - 1,
                 o.cur_len - o.cur_begin - 1) for o in rev}
    assert fwd_keys == rev_keys


def test_base_level_divergence(sim_setup):
    genome, store = sim_setup
    eng = build_engine(store, nucl_alignment=True, max_divergence=0.1)
    ovlps = eng.get_overlaps(store, store.ids()[0])
    assert ovlps
    for ov in ovlps:
        assert ov.divergence < 0.02  # error-free reads: near-zero


def test_transitivity_and_filtering(sim_setup):
    genome, store = sim_setup
    eng = build_engine(store)
    ost = OverlapStore(eng, store)
    ost.find_all_overlaps()
    # symmetric: if (a -> b) exists then (b -> a) exists
    for sid in store.ids(both_strands=True):
        for ov in ost._unsafe(sid):
            back = ost._unsafe(ov.ext_id)
            assert any(bo.ext_id == ov.cur_id for bo in back), ov
    # deduplicated: no two near-identical overlaps to the same target
    for sid in store.ids(both_strands=True):
        lst = ost._unsafe(sid)
        for i in range(len(lst)):
            for j in range(i + 1, len(lst)):
                o1, o2 = lst[i], lst[j]
                if o1.ext_id != o2.ext_id:
                    continue
                assert (o1.cur_range - o1.cur_intersect(o2) >= eng.k or
                        o1.ext_range - o1.ext_intersect(o2) >= eng.k)


def test_estimate_divergence_threshold(sim_setup):
    genome, store = sim_setup
    eng = build_engine(store)
    ost = OverlapStore(eng, store)
    ost.estimate_overlaper_parameters(max_seqs=20)
    assert 0.0 <= ost.mean_true_divergence < 0.1
    ost.set_divergence_threshold(0.1, relative=True)
    assert eng.max_divergence == pytest.approx(
        ost.mean_true_divergence + 0.1)


def test_chunked_posting_gather_identical():
    """Forcing the bounded posting-expansion path (tiny gather_cap)
    must not change any overlap."""
    import numpy as np

    from flye_jax.index import KmerIndex
    from flye_jax.io import SequenceStore
    from flye_jax.overlap import OverlapEngine
    from flye_jax.utils.simulate import random_genome, simulate_reads

    genome = random_genome(15000, seed=31)
    reads = simulate_reads(genome, coverage=8, mean_length=4000,
                           min_length=1500, error_rate=0.03, seed=32)
    store = SequenceStore()
    for n, c in reads:
        store.add(n, c)
    idx = KmerIndex.build_minimizers(store, 15, 5)

    def run(cap):
        eng = OverlapEngine(store, idx, max_jump=1500, min_overlap=1500,
                            max_overhang=1500)
        eng.gather_cap = cap
        res = eng.get_overlaps_batch(store, store.ids()[:10])
        return {s: sorted((o.ext_id, o.cur_begin, o.cur_end,
                           o.ext_begin, o.ext_end) for o in v)
                for s, v in res.items()}

    assert run(200) == run(64 << 20)
