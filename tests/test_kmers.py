import numpy as np
import pytest

from flye_jax.io.fasta import COMPLEMENT
from flye_jax.ops import (canonical_kmers, extract_kmers, kmer_hashes,
                          minimizer_mask, sample_mask, splitmix64)


def oracle_kmer(codes, p, k):
    v = 0
    for j in range(k):
        v = (v << 2) | int(codes[p + j])
    return v


def oracle_rc_kmer(codes, p, k):
    v = 0
    for j in range(k):
        v |= (3 - int(codes[p + j])) << (2 * j)
    return v


def make_batch(rng, B=3, L=50):
    codes = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    lengths = rng.integers(20, L + 1, size=B).astype(np.int32)
    for b in range(B):
        codes[b, lengths[b]:] = 0
    return codes, lengths


def test_extract_kmers_vs_oracle(rng):
    codes, lengths = make_batch(rng)
    k = 7
    fwd, rc, valid = (np.asarray(x) for x in extract_kmers(codes, lengths, k))
    for b in range(codes.shape[0]):
        for p in range(codes.shape[1]):
            if p <= lengths[b] - k:
                assert valid[b, p]
                assert fwd[b, p] == oracle_kmer(codes[b], p, k)
                assert rc[b, p] == oracle_rc_kmer(codes[b], p, k)
            else:
                assert not valid[b, p]


def test_rc_kmer_is_revcomp(rng):
    # rc kmer at p in fwd read == fwd kmer of the reverse-complemented read
    codes, lengths = make_batch(rng, B=1, L=40)
    n, k = int(lengths[0]), 9
    rc_read = COMPLEMENT[codes[0, :n][::-1]][None, :]
    fwd, rc, _ = (np.asarray(x) for x in extract_kmers(codes, lengths, k))
    fwd2, _, _ = (np.asarray(x) for x in
                  extract_kmers(rc_read, np.array([n], np.int32), k))
    for p in range(n - k + 1):
        assert rc[0, p] == fwd2[0, n - k - p]


def test_canonical_strand_symmetric(rng):
    codes, lengths = make_batch(rng, B=1, L=60)
    n, k = int(lengths[0]), 11
    rc_read = COMPLEMENT[codes[0, :n][::-1]][None, :]
    canon, _, _ = (np.asarray(x) for x in canonical_kmers(codes, lengths, k))
    canon2, _, _ = (np.asarray(x) for x in
                    canonical_kmers(rc_read, np.array([n], np.int32), k))
    for p in range(n - k + 1):
        assert canon[0, p] == canon2[0, n - k - p]


def test_splitmix64_known_values():
    import jax.numpy as jnp
    # splitmix64(0..2) canonical outputs (seed=i, first output)
    out = np.asarray(splitmix64(jnp.arange(3, dtype=jnp.uint64) +
                                jnp.uint64(0x9E3779B97F4A7C15)))
    assert out[0] == np.uint64(0xE220A8397B1DCDAF)


def test_minimizer_mask_vs_oracle(rng):
    codes, lengths = make_batch(rng, B=4, L=80)
    k, w = 5, 6
    _, h, valid = (np.asarray(x) for x in kmer_hashes(codes, lengths, k))
    mask = np.asarray(minimizer_mask(h, valid, w))
    for b in range(codes.shape[0]):
        nk = int(lengths[b]) - k + 1  # number of valid kmer positions
        expected = np.zeros(codes.shape[1], dtype=bool)
        for s in range(0, nk - w + 1):
            window = h[b, s:s + w]
            m = window.min()
            for j in range(w):
                if window[j] == m:
                    expected[s + j] = True
        if nk < w:  # too short: no full window
            expected[:] = False
        np.testing.assert_array_equal(mask[b], expected,
                                      err_msg=f"row {b} len {lengths[b]}")


def test_minimizer_strand_symmetric(rng):
    codes, lengths = make_batch(rng, B=1, L=100)
    n, k, w = int(lengths[0]), 7, 5
    rc_read = COMPLEMENT[codes[0, :n][::-1]][None, :]
    _, h1, v1 = kmer_hashes(codes, lengths, k)
    _, h2, v2 = kmer_hashes(rc_read, np.array([n], np.int32), k)
    m1 = np.asarray(minimizer_mask(h1, v1, w))[0]
    m2 = np.asarray(minimizer_mask(h2, v2, w))[0]
    for p in range(n - k + 1):
        assert m1[p] == m2[n - k - p]


def test_minimizer_density(rng):
    # expected density of minimizers is ~2/(w+1)
    codes = rng.integers(0, 4, size=(2, 5000)).astype(np.uint8)
    lengths = np.array([5000, 5000], np.int32)
    k, w = 15, 10
    _, h, valid = kmer_hashes(codes, lengths, k)
    mask = np.asarray(minimizer_mask(h, valid, w))
    density = mask.sum() / valid.sum().item()
    assert 0.15 < density < 0.25  # 2/11 ~ 0.18


def test_sample_mask():
    valid = np.ones((1, 10), dtype=bool)
    m = np.asarray(sample_mask(valid, 3))
    np.testing.assert_array_equal(
        m[0], [True, False, False, True, False, False, True, False, False,
               True])
