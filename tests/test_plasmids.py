import numpy as np
import pytest

from flye_jax.io import SequenceStore
from flye_jax.plasmids import recover_short_plasmids
from flye_jax.plasmids.plasmids import (find_circular_reads,
                                        find_unmapped_reads)
from flye_jax.utils.simulate import random_genome, simulate_reads


@pytest.mark.slow
def test_plasmid_recovery():
    # chromosome + a 3kb circular plasmid; reads from both
    chrom = random_genome(20000, seed=601)
    plasmid = random_genome(3000, seed=602)

    reads = SequenceStore()
    for name, codes in simulate_reads(chrom, coverage=6, mean_length=5000,
                                      min_length=1500, error_rate=0.03,
                                      circular=False, seed=603):
        reads.add("chr_" + name, codes)
    # plasmid reads: longer than the plasmid -> wrap the circle
    for name, codes in simulate_reads(plasmid, coverage=10,
                                      mean_length=4500, min_length=3500,
                                      error_rate=0.03, circular=True,
                                      seed=604):
        reads.add("pl_" + name, codes)

    contigs = SequenceStore()
    contigs.add("contig_1", chrom)

    # unmapped reads should be mostly the plasmid reads
    unmapped = find_unmapped_reads(reads, contigs)
    unmapped_names = {reads.name(s) for s in unmapped}
    assert all(n.startswith("pl_") for n in unmapped_names), unmapped_names
    assert len(unmapped) >= 3

    circ = find_circular_reads(reads, unmapped)
    assert circ, "no circular reads detected"
    for sid, circle_len in circ:
        assert 2500 <= circle_len <= 3600, circle_len

    plasmids = recover_short_plasmids(reads, contigs, "pacbio")
    assert 1 <= len(plasmids) <= 3
    name, seq = plasmids[0]
    assert 2500 <= len(seq) <= 3600
    # plasmid sequence should share most 15-mers with the true plasmid
    from flye_jax.io.fasta import reverse_complement

    def kset(c, k=15):
        out = set()
        for s in (c, reverse_complement(c)):
            v = 0
            mask = (1 << (2 * k)) - 1
            for i, ch in enumerate(s):
                v = ((v << 2) | int(ch)) & mask
                if i >= k - 1:
                    out.add(v)
        return out

    pk = kset(np.concatenate([plasmid, plasmid]))
    sk = kset(seq)
    assert len(sk & pk) / max(1, len(sk)) > 0.5
