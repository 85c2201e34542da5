"""Metagenome (uneven coverage) mode: two organisms at very different
abundances must both assemble (reference: --meta / uneven_coverage
chimera thresholds + per-read solid-kmer selection)."""

import numpy as np
import pytest

from flye_jax.assemble import assemble_disjointigs
from flye_jax.config import Config
from flye_jax.io import SequenceStore
from flye_jax.io.fasta import reverse_complement
from flye_jax.utils.simulate import random_genome, simulate_reads


def kmer_share(seq, genome, k=13):
    gset = set()
    for s in (genome, reverse_complement(genome)):
        v = 0
        mask = (1 << (2 * k)) - 1
        for i, c in enumerate(s):
            v = ((v << 2) | int(c)) & mask
            if i >= k - 1:
                gset.add(v)
    v = 0
    mask = (1 << (2 * k)) - 1
    hit = tot = 0
    for i, c in enumerate(seq):
        v = ((v << 2) | int(c)) & mask
        if i >= k - 1:
            tot += 1
            hit += v in gset
    return hit / max(1, tot)


@pytest.mark.slow
def test_meta_uneven_coverage():
    genome_hi = random_genome(25000, seed=701)
    genome_lo = random_genome(18000, seed=702)
    store = SequenceStore()
    for name, codes in simulate_reads(genome_hi, coverage=25,
                                      mean_length=6000, min_length=2500,
                                      error_rate=0.0, circular=False,
                                      seed=703):
        store.add("hi_" + name, codes)
    for name, codes in simulate_reads(genome_lo, coverage=10,
                                      mean_length=6000, min_length=2500,
                                      error_rate=0.0, circular=False,
                                      seed=704):
        store.add("lo_" + name, codes)

    cfg = Config("raw", min_overlap=2000, uneven_coverage=1)
    disjointigs = assemble_disjointigs(store, cfg)
    assert disjointigs

    # classify each disjointig by its dominant source genome
    hi_len = lo_len = 0
    for name, seq in disjointigs:
        if kmer_share(seq, genome_hi) > 0.5:
            hi_len += len(seq)
        elif kmer_share(seq, genome_lo) > 0.5:
            lo_len += len(seq)
    assert hi_len >= 0.7 * len(genome_hi), hi_len
    # the low-abundance organism must not be lost
    assert lo_len >= 0.5 * len(genome_lo), lo_len
