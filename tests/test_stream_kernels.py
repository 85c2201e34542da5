"""Flat-stream kernels vs the per-read oracle formulation.

stream_select_packed / stream_probe_packed process all reads as one
concatenated stream (transfer-optimal); these tests pin their outputs
to the per-read canonical_kmers / minimizer_mask / probe_batch results.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from flye_jax.index.kmer_index import KmerIndex
from flye_jax.io.seqstore import SequenceStore
from flye_jax.ops.kmers import (canonical_kmers, minimizer_mask,
                                sample_mask, splitmix64)


def make_reads(rng, n=7, lo=40, hi=900):
    store = SequenceStore()
    for i in range(n):
        ln = int(rng.integers(lo, hi))
        store.add(f"r{i}", rng.integers(0, 4, size=ln).astype(np.uint8))
    return store


def oracle_selected(store, ids, k, w, sample):
    """Per-read reference path: padded canonical_kmers + selection."""
    out = []
    for sid in ids:
        codes = store.get(sid)
        pad = 1 << max(6, (len(codes) - 1).bit_length())
        batch = np.zeros((1, pad), np.uint8)
        batch[0, :len(codes)] = codes
        lens = np.asarray([len(codes)], np.int32)
        canon, is_fwd, valid = canonical_kmers(batch, lens, k)
        if w > 1:
            h = jnp.where(valid, splitmix64(canon),
                          jnp.uint64(0xFFFFFFFFFFFFFFFF))
            sel = minimizer_mask(h, valid, w)
        else:
            sel = sample_mask(valid, sample)
        sel = np.asarray(sel)[0]
        canon = np.asarray(canon)[0]
        is_fwd = np.asarray(is_fwd)[0]
        for p in np.flatnonzero(sel):
            out.append((sid >> 1, int(p), int(canon[p]), bool(is_fwd[p])))
    return out


@pytest.mark.parametrize("k,w,sample", [(15, 5, 1), (17, 1, 1),
                                        (17, 1, 3), (13, 10, 1),
                                        (31, 1, 1)])  # k=31: subasm
                                        # mode; canon<<2 fills uint64
def test_stream_extract_matches_per_read_oracle(k, w, sample):
    rng = np.random.default_rng(17)
    store = make_reads(rng)
    idx = KmerIndex(store, k)
    ids = store.ids()
    kmers, seq, pos, flip = idx._extract_selected(ids, w=w, sample=sample)
    got = list(zip(seq.tolist(), pos.tolist(), kmers.tolist(),
                   (~flip).tolist()))
    want = oracle_selected(store, ids, k, w, sample)
    assert sorted(got) == sorted(want)


def test_stream_extract_reads_shorter_than_k():
    store = SequenceStore()
    store.add("tiny", np.asarray([1, 2, 3], np.uint8))   # < k
    store.add("ok", np.tile(np.asarray([0, 1, 2, 3], np.uint8), 30))
    idx = KmerIndex(store, 15)
    kmers, seq, pos, flip = idx._extract_selected(store.ids(), w=1,
                                                  sample=1)
    assert (seq == 1).all()          # nothing from the tiny read
    assert len(kmers) == 120 - 15 + 1


def test_stream_extract_spans_many_rows():
    # one read much longer than the chunk width exercises row overlap
    rng = np.random.default_rng(3)
    store = SequenceStore()
    store.add("long", rng.integers(0, 4, size=40000).astype(np.uint8))
    k, w = 15, 5
    idx = KmerIndex(store, k)
    kmers, seq, pos, flip = idx._extract_selected(store.ids(), w=w,
                                                  sample=1)
    got = sorted(zip(seq.tolist(), pos.tolist(), kmers.tolist()))
    want = sorted((s, p, km) for s, p, km, _ in
                  oracle_selected(store, store.ids(), k, w, 1))
    assert got == want


def test_probe_stream_flat_matches_probe_batch():
    rng = np.random.default_rng(5)
    targets = make_reads(rng, n=3, lo=500, hi=2000)
    idx = KmerIndex.build_minimizers(targets, 13, 5)
    queries = make_reads(rng, n=5, lo=100, hi=700)
    sids = queries.ids(both_strands=True)

    g_hit, row_hit, fwd_hit, g_rep, starts, n_total = (
        idx.probe_stream_flat(queries, sids))
    # oracle: per-read padded probe
    for qi, sid in enumerate(sids):
        codes = queries.get(sid)
        pad = 1 << max(6, (len(codes) - 1).bit_length())
        batch = np.zeros((1, pad), np.uint8)
        batch[0, :len(codes)] = codes
        lens = np.asarray([len(codes)], np.int32)
        row, hit, rep, fwd = idx.probe_batch(batch, lens)
        qpos = np.flatnonzero(hit[0])
        lo, hi = np.searchsorted(g_hit, [starts[qi], starts[qi + 1]])
        np.testing.assert_array_equal(g_hit[lo:hi] - starts[qi], qpos)
        np.testing.assert_array_equal(row_hit[lo:hi], row[0][qpos])
        np.testing.assert_array_equal(fwd_hit[lo:hi], fwd[0][qpos])
        rpos = np.flatnonzero(rep[0])
        rlo, rhi = np.searchsorted(g_rep, [starts[qi], starts[qi + 1]])
        np.testing.assert_array_equal(g_rep[rlo:rhi] - starts[qi], rpos)
