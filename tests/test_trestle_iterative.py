"""Iterative read-partitioning for repeats longer than any single
read's reach: windows walk inward, recruiting reads to sides by edit
distance to the growing per-side consensus."""

import numpy as np

from flye_jax.io import SequenceStore
from flye_jax.overlap.structs import Overlap
from flye_jax.repeat.graph import EdgeSequence, GraphEdge, RepeatGraph
from flye_jax.repeat.processing import UnbranchingPath
from flye_jax.repeat.read_aligner import EdgeAlignment
from flye_jax.trestle.trestle import SimpleRepeat, _iterative_partition
import pytest

# full E2E runs: excluded from the fast unit gate (run with -m slow)
pytestmark = pytest.mark.slow

L = 1500


def _mk_edge(g, nl, nr, eid, seq_id=0, start=0, end=L, cov=30):
    e = GraphEdge(nl, nr, eid)
    e.seq_segments.append(EdgeSequence(seq_id, 60000, start, end))
    e.mean_coverage = cov
    g.add_edge(e)
    return e


def _flank_aln(edge, read_id):
    ov = Overlap(read_id, -1, 0, 100, 2000, 0, 100, edge.length(),
                 score=50)
    return EdgeAlignment(ov, edge)


def _rep_aln(rep_edge, read_id, lo, hi):
    n = hi - lo
    ov = Overlap(read_id, -1, 0, n, n, lo, hi, L, score=n)
    return EdgeAlignment(ov, rep_edge)


def test_iterative_partition_long_repeat():
    rng = np.random.default_rng(11)
    copy_b = rng.integers(0, 4, L).astype(np.uint8)
    copy_a = copy_b.copy()
    for p in range(50, L, 100):          # a SNP every 100 bp
        copy_a[p] = (copy_a[p] + 1) % 4

    store = SequenceStore()
    pad = np.zeros(60000, np.uint8)
    pad[:L] = copy_b                     # edge sequence = copy B
    store.add("asm", pad)
    g = RepeatGraph(store)
    n = [g.add_node() for _ in range(14)]
    in1 = _mk_edge(g, n[0], n[2], 0, end=9000)
    _mk_edge(g, n[3], n[1], 1, end=9000)
    in2 = _mk_edge(g, n[4], n[2], 2, end=9000)
    _mk_edge(g, n[3], n[5], 3, end=9000)
    rep = _mk_edge(g, n[2], n[6], 4, cov=60)
    _mk_edge(g, n[7], n[3], 5, cov=60)
    out1 = _mk_edge(g, n[6], n[8], 6, end=9000)
    _mk_edge(g, n[9], n[7], 7, end=9000)
    out2 = _mk_edge(g, n[6], n[10], 8, end=9000)
    _mk_edge(g, n[11], n[7], 9, end=9000)
    rep.repetitive = True

    path = UnbranchingPath(rep.edge_id, [rep])
    simple = SimpleRepeat(path, [in1, in2], [out1, out2])

    reads = SequenceStore()
    chains = []

    def add_read(copy, lo, hi, entry=None, exit_e=None):
        rid = reads.add(f"r{len(chains)}", np.ascontiguousarray(
            copy[lo:hi]))
        chain = []
        if entry is not None:
            chain.append(_flank_aln(entry, int(rid)))
        chain.append(_rep_aln(rep, int(rid), lo, hi))
        if exit_e is not None:
            chain.append(_flank_aln(exit_e, int(rid)))
        chains.append(chain)

    for _ in range(3):
        add_read(copy_a, 0, 900, entry=in1)       # side 0 anchors
        add_read(copy_b, 0, 900, entry=in2)       # side 1 anchors
        add_read(copy_a, 200, 1300)               # middles, unassigned
        add_read(copy_b, 200, 1300)
        add_read(copy_a, 700, L, exit_e=out1)     # exits, unassigned
        add_read(copy_b, 700, L, exit_e=out2)

    chains_by_edge = {}
    for chain in chains:
        for a in chain:
            chains_by_edge.setdefault(a.edge.edge_id, []).append(chain)

    pairing = _iterative_partition(g, reads, simple, chains_by_edge)
    assert pairing is not None
    (pin1, pout1), (pin2, pout2) = pairing
    got = {(pin1.edge_id, pout1.edge_id), (pin2.edge_id, pout2.edge_id)}
    assert got == {(in1.edge_id, out1.edge_id),
                   (in2.edge_id, out2.edge_id)}
