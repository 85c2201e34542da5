"""End-to-end disjointig assembly on simulated genomes (Milestone A)."""

import numpy as np
import pytest

from flye_jax.assemble import assemble_disjointigs
from flye_jax.config import Config
from flye_jax.io import SequenceStore
from flye_jax.utils.simulate import random_genome, simulate_reads


def kmer_set(codes, k=15):
    """K-mers of both strands (a disjointig may come out rc-oriented)."""
    from flye_jax.io.fasta import reverse_complement
    out = set()
    for seq in (codes, reverse_complement(codes)):
        v = 0
        mask = (1 << (2 * k)) - 1
        for i, c in enumerate(seq):
            v = ((v << 2) | int(c)) & mask
            if i >= k - 1:
                out.add(v)
    return out


def make_store(genome, coverage, error_rate, seed, mean_length=6000):
    reads = simulate_reads(genome, coverage=coverage,
                           mean_length=mean_length, min_length=2000,
                           error_rate=error_rate, circular=True, seed=seed)
    store = SequenceStore()
    for name, codes in reads:
        store.add(name, codes)
    return store


@pytest.mark.slow
def test_disjointigs_error_free():
    genome = random_genome(30000, seed=101)
    store = make_store(genome, coverage=15, error_rate=0.0, seed=102)
    cfg = Config("corrected", min_overlap=2000)
    disjointigs = assemble_disjointigs(store, cfg)
    assert 1 <= len(disjointigs) <= 3
    total = sum(len(s) for _, s in disjointigs)
    # circular genome: the disjointig can cover the genome ~once (up to
    # one extra read length of wrap)
    assert total >= 0.9 * len(genome)
    assert total <= 2.0 * len(genome)
    # every disjointig k-mer must come from the genome (error-free reads)
    gk = kmer_set(np.concatenate([genome, genome]))
    for name, seq in disjointigs:
        dk = kmer_set(seq)
        frac = len(dk & gk) / max(1, len(dk))
        assert frac > 0.999, (name, frac)


@pytest.mark.slow
def test_disjointigs_with_errors():
    genome = random_genome(30000, seed=201)
    store = make_store(genome, coverage=18, error_rate=0.06, seed=202)
    cfg = Config("raw", min_overlap=2000)
    disjointigs = assemble_disjointigs(store, cfg)
    assert len(disjointigs) >= 1
    total = sum(len(s) for _, s in disjointigs)
    assert total >= 0.85 * len(genome)
    # disjointig should consist of genuine read sequence: most of its
    # kmers at k=11 should appear in the genome (reads have 6% errors,
    # so ~50% of 11-mers are exact)
    gk = kmer_set(np.concatenate([genome, genome]), k=11)
    for name, seq in disjointigs:
        dk = kmer_set(seq, k=11)
        frac = len(dk & gk) / max(1, len(dk))
        assert frac > 0.35, (name, frac)
