"""Statistical divergent-position calling + position-based phasing
(reference: flye/trestle/divergence.py:146, trestle.py:1075,
trestle_config.py:19-21) — including the must-not-bridge cases."""

import numpy as np

from flye_jax.io import SequenceStore
from flye_jax.overlap.structs import Overlap
from flye_jax.repeat.graph import EdgeSequence, GraphEdge, RepeatGraph
from flye_jax.repeat.processing import UnbranchingPath
from flye_jax.repeat.read_aligner import EdgeAlignment
from flye_jax.trestle.divergence import (banded_ops,
                                         call_divergent_positions,
                                         classify_by_positions,
                                         consensus_signature,
                                         pileup_profile,
                                         position_signatures)
from flye_jax.trestle.trestle import SimpleRepeat, _position_partition
from flye_jax.utils.simulate import random_genome

L = 1500


def test_banded_ops_roundtrip():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, 500).astype(np.uint8)
    ops = banded_ops(a, a)
    assert (ops == 0).all() and len(ops) == 500
    # deletion + insertion
    b = np.concatenate([a[:100], a[120:]])  # 20 bases deleted from a
    ops = banded_ops(a, b)
    assert (ops == 1).sum() == 20  # 20 a-chars consumed without b
    assert (ops == 2).sum() == 0
    n_a = int((ops != 2).sum())
    n_b = int((ops != 1).sum())
    assert n_a == len(a) and n_b == len(b)


def _noisy(seq, er, seed):
    r = np.random.default_rng(seed)
    out = []
    for c in seq:
        x = r.random()
        if x < er * 0.4:
            out.append((c + r.integers(1, 4)) % 4)
        elif x < er * 0.7:
            pass
        else:
            out.append(c)
            if x > 1 - er * 0.3:
                out.append(r.integers(0, 4))
    return np.asarray(out, np.uint8)


def test_divergent_positions_and_classification():
    template = random_genome(2500, seed=1)
    snps = [400, 1100, 1900]
    copy_b = template.copy()
    for p in snps:
        copy_b[p] = (copy_b[p] + 1) % 4
    segs = [(_noisy(template, 0.05, i), 0) for i in range(10)]
    segs += [(_noisy(copy_b, 0.05, 100 + i), 0) for i in range(10)]
    pile = pileup_profile(template, segs)
    pos = call_divergent_positions(template, pile)
    called = set(pos["total"].tolist())
    assert all(p in called for p in snps)
    sigs = position_signatures(pile, pos["total"])
    side = {0: consensus_signature(template, template, pos["total"]),
            1: consensus_signature(template, copy_b, pos["total"])}
    labels = classify_by_positions(sigs, side)
    correct = sum(1 for i, l in enumerate(labels)
                  if l == (0 if i < 10 else 1))
    assert correct >= 18


def test_no_positions_on_identical_copies():
    template = random_genome(2000, seed=2)
    segs = [(template.copy(), 0) for _ in range(12)]
    pile = pileup_profile(template, segs)
    pos = call_divergent_positions(template, pile)
    assert len(pos["total"]) == 0


# ---- graph-level fixture (mirrors tests/test_trestle_iterative.py) ----

def _mk_edge(g, nl, nr, eid, end=L, cov=30):
    e = GraphEdge(nl, nr, eid)
    e.seq_segments.append(EdgeSequence(0, 60000, 0, end))
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


def _build_case(copy_a, copy_b, noise=0.0):
    store = SequenceStore()
    pad = np.zeros(60000, np.uint8)
    pad[:L] = copy_b
    store.add("asm", pad)
    g = RepeatGraph(store)
    n = [g.add_node() for _ in range(12)]
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
    seed_ctr = [0]

    def add_read(copy, lo, hi, entry=None, exit_e=None):
        codes = copy[lo:hi]
        if noise:
            seed_ctr[0] += 1
            codes = _noisy(codes, noise, seed_ctr[0])
        rid = reads.add(f"r{len(chains)}", np.ascontiguousarray(codes))
        chain = []
        if entry is not None:
            chain.append(_flank_aln(entry, int(rid)))
        chain.append(_rep_aln(rep, int(rid), lo, hi))
        if exit_e is not None:
            chain.append(_flank_aln(exit_e, int(rid)))
        chains.append(chain)

    for _ in range(3):
        add_read(copy_a, 0, 900, entry=in1)
        add_read(copy_b, 0, 900, entry=in2)
        add_read(copy_a, 200, 1300)
        add_read(copy_b, 200, 1300)
        add_read(copy_a, 700, L, exit_e=out1)
        add_read(copy_b, 700, L, exit_e=out2)

    chains_by_edge = {}
    for chain in chains:
        for a in chain:
            chains_by_edge.setdefault(a.edge.edge_id, []).append(chain)
    return g, reads, simple, chains_by_edge, (in1, in2, out1, out2)


def test_position_partition_phases_long_repeat():
    rng = np.random.default_rng(11)
    copy_b = rng.integers(0, 4, L).astype(np.uint8)
    copy_a = copy_b.copy()
    for p in range(50, L, 150):
        copy_a[p] = (copy_a[p] + 1) % 4
    g, reads, simple, cbe, (in1, in2, out1, out2) = _build_case(
        copy_a, copy_b, noise=0.03)
    pairing = _position_partition(g, reads, simple, cbe)
    assert pairing is not None
    (p1, q1), (p2, q2) = pairing
    got = {(p1.edge_id, q1.edge_id), (p2.edge_id, q2.edge_id)}
    assert got == {(in1.edge_id, out1.edge_id),
                   (in2.edge_id, out2.edge_id)}


def test_position_partition_refuses_identical_copies():
    """Must-not-bridge: repeat copies with NO divergence can't be
    phased; Trestle must refuse rather than guess."""
    rng = np.random.default_rng(12)
    copy = rng.integers(0, 4, L).astype(np.uint8)
    g, reads, simple, cbe, _ = _build_case(copy, copy, noise=0.0)
    assert _position_partition(g, reads, simple, cbe) is None
    # noisy reads over identical copies must also refuse (random errors
    # may call a few positions, but side consensuses stay identical)
    g, reads, simple, cbe, _ = _build_case(copy, copy, noise=0.04)
    assert _position_partition(g, reads, simple, cbe) is None
