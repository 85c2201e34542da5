"""End-to-end polishing: noisy draft + reads -> high-identity sequence."""

import numpy as np
import pytest

from flye_jax.io import SequenceStore
from flye_jax.ops.align import edit_distance_batch
from flye_jax.polishing.polisher import polish
from flye_jax.utils.simulate import random_genome, simulate_reads


def identity(a: np.ndarray, b: np.ndarray) -> float:
    S = 1 << int(np.ceil(np.log2(max(len(a), len(b)))))
    av = np.zeros((1, S), np.uint8)
    bv = np.zeros((1, S), np.uint8)
    av[0, :len(a)] = a
    bv[0, :len(b)] = b
    d = int(np.asarray(edit_distance_batch(
        av, np.array([len(a)], np.int32),
        bv, np.array([len(b)], np.int32)))[0])
    return 1.0 - d / max(len(a), len(b))


def corrupt(rng, seq, rate):
    out = []
    for c in seq:
        r = rng.random()
        if r < rate * 0.4:
            out.append((c + rng.integers(1, 4)) % 4)  # sub
        elif r < rate * 0.7:
            out.append(c)
            out.append(rng.integers(0, 4))            # ins
        elif r < rate:
            continue                                   # del
        else:
            out.append(c)
    return np.array(out, dtype=np.uint8)


@pytest.mark.slow
def test_polish_recovers_genome(rng):
    genome = random_genome(8000, seed=301)
    draft = corrupt(rng, genome, 0.05)
    draft_ident = identity(draft, genome)
    assert draft_ident < 0.97

    reads = simulate_reads(genome, coverage=20, mean_length=4000,
                           min_length=1200, error_rate=0.08,
                           circular=False, seed=302)
    store = SequenceStore()
    for name, codes in reads:
        store.add(name, codes)

    # small bubbles keep the CPU test fast; the pipeline uses the
    # reference's 500bp windows
    polished = polish([("contig_1", draft)], store, "pacbio",
                      num_iters=1, max_bubble=120)
    assert len(polished) == 1
    name, seq = polished[0]
    ident = identity(seq, genome)
    assert ident > 0.985, f"identity {draft_ident:.4f} -> {ident:.4f}"
    assert ident > draft_ident + 0.02


def test_polish_no_reads_is_noop(rng):
    genome = random_genome(5000, seed=303)
    store = SequenceStore()  # no reads
    polished = polish([("c1", genome)], store, "pacbio", num_iters=1)
    np.testing.assert_array_equal(polished[0][1], genome)


def test_coalesce_buckets():
    """Small buckets merge upward into superset shapes; big ones stay."""
    from flye_jax.polishing.polisher import _coalesce
    items = {
        (64, 96, 8): list(range(5)),
        (64, 96, 16): list(range(3)),
        (160, 240, 8): list(range(100)),
        (384, 576, 56): list(range(2)),
    }
    out = _coalesce(items, min_batch=48)
    assert sum(len(v) for v in out.values()) == 110
    for (cb, sb, rb), lst in out.items():
        assert (cb, sb) in ((64, 96), (160, 240), (384, 576), (768, 1152),
                            (1536, 2304)) or cb >= 64
    # the two tiny 64-buckets merged forward into the 160 bucket
    assert any(len(v) >= 100 for v in out.values())
    # a single bucket in, single bucket out
    assert _coalesce({(64, 96, 8): list(range(3))}, 48) == {
        (64, 96, 8): [0, 1, 2]}
    # trailing small bucket folds back into the carried shape
    out2 = _coalesce({(64, 96, 8): list(range(60)),
                      (1536, 2304, 56): [0]}, 48)
    assert sum(len(v) for v in out2.values()) == 61
