"""Unit tests for repeat classification/resolution machinery added on
top of the basic coverage rules: read-extension voting, tandem-copy
detection, chimeric-junction fixing, resolved-repeat clearing, and the
superbubble/roundabout masking (meta mode)."""

import numpy as np

from flye_jax.config import Config
from flye_jax.io import SequenceStore
from flye_jax.overlap.structs import Overlap
from flye_jax.repeat.graph import EdgeSequence, GraphEdge, RepeatGraph
from flye_jax.repeat.haplotype import HaplotypeResolver
from flye_jax.repeat.processing import fix_chimeric_junctions
from flye_jax.repeat.read_aligner import EdgeAlignment
from flye_jax.repeat.resolver import RepeatResolver


class FakeInferer:
    def __init__(self, mean=30, unique=52.5):
        self.mean_coverage = mean
        self.unique_cov_threshold = unique


class FakeAligner:
    def __init__(self, alignments):
        self.alignments = alignments

    def update_alignments(self):
        pass


def _mk_edge(g, nl, nr, eid, length=6000, cov=30):
    e = GraphEdge(nl, nr, eid)
    e.seq_segments.append(EdgeSequence(0, 60000, 0, length))
    e.mean_coverage = cov
    g.add_edge(e)
    return e


def _aln(edge, cur_begin, cur_end, cur_len=30000, read_id=0):
    ov = Overlap(read_id, -1, cur_begin, cur_end, cur_len,
                 0, edge.length(), edge.length(), score=100)
    return EdgeAlignment(ov, edge)


def make_fork_graph():
    """repeat R with one entrance U0 and two exits U1, U2 (plus
    complement strand), all with similar coverage so only read voting
    can mark R repetitive."""
    store = SequenceStore()
    store.add("d", np.zeros(60000, np.uint8))
    g = RepeatGraph(store)
    n = [g.add_node() for _ in range(10)]
    u0 = _mk_edge(g, n[0], n[1], 0)
    _mk_edge(g, n[2], n[3], 1)
    r = _mk_edge(g, n[1], n[4], 2)
    rc = _mk_edge(g, n[5], n[2], 3)
    u1 = _mk_edge(g, n[4], n[6], 4)
    _mk_edge(g, n[7], n[5], 5)
    u2 = _mk_edge(g, n[4], n[8], 6)
    _mk_edge(g, n[9], n[5], 7)
    return g, u0, r, rc, u1, u2


def _voting_alignments(u0, r, u1, u2, n_each=4):
    alns = []
    for i in range(n_each):
        alns.append([_aln(u0, 0, 9000, read_id=2 * i),
                     _aln(r, 9000, 15000, read_id=2 * i),
                     _aln(u1, 15000, 24000, read_id=2 * i)])
        alns.append([_aln(u0, 0, 9000, read_id=2 * i + 100),
                     _aln(r, 9000, 15000, read_id=2 * i + 100),
                     _aln(u2, 15000, 24000, read_id=2 * i + 100)])
    return alns


def test_read_extension_voting_marks_fork_repeat():
    g, u0, r, rc, u1, u2 = make_fork_graph()
    cfg = Config("raw", min_overlap=2000)
    aligner = FakeAligner(_voting_alignments(u0, r, u1, u2))
    res = RepeatResolver(g, None, aligner, cfg, FakeInferer())
    res.find_repeats()
    # reads extend from r into two distinct well-supported unique
    # edges -> r is repetitive; the unique edges stay unique
    assert r.repetitive and rc.repetitive
    assert not u1.repetitive and not u2.repetitive


def test_single_extension_stays_unique():
    g, u0, r, rc, u1, u2 = make_fork_graph()
    # remove the second exit so all reads agree
    g.remove_node(u2.node_right)
    g.remove_node(g.complement_edge(u2).node_left)
    cfg = Config("raw", min_overlap=2000)
    alns = []
    for i in range(8):
        alns.append([_aln(u0, 0, 9000, read_id=i),
                     _aln(r, 9000, 15000, read_id=i),
                     _aln(u1, 15000, 24000, read_id=i)])
    res = RepeatResolver(g, None, FakeAligner(alns), cfg, FakeInferer())
    res.find_repeats()
    assert not r.repetitive


def test_tandem_copies_mark_repeat():
    g, u0, r, rc, u1, u2 = make_fork_graph()
    cfg = Config("raw", min_overlap=2000)
    # 5 reads each containing r twice in the interior
    alns = []
    for i in range(5):
        alns.append([_aln(u0, 0, 9000, read_id=i),
                     _aln(r, 9000, 15000, read_id=i),
                     _aln(r, 15000, 21000, read_id=i),
                     _aln(u1, 21000, 29000, read_id=i)])
    res = RepeatResolver(g, None, FakeAligner(alns), cfg, FakeInferer())
    res.find_repeats()
    assert r.repetitive


def test_mask_unsupported_low_coverage():
    g, u0, r, rc, u1, u2 = make_fork_graph()
    u2.mean_coverage = 2
    g.complement_edge(u2).mean_coverage = 2
    cfg = Config("raw", min_overlap=2000)
    res = RepeatResolver(g, None, FakeAligner([]), cfg,
                         FakeInferer(mean=30))
    res.find_repeats()
    # below mean/graph_cov_drop_rate = 30/5 = 6
    assert u2.repetitive
    assert not u0.repetitive


def test_fix_chimeric_junction_simple():
    store = SequenceStore()
    store.add("d", np.zeros(60000, np.uint8))
    g = RepeatGraph(store)
    a, b = g.add_node(), g.add_node()
    e = _mk_edge(g, a, b, 0)       # fwd: a->b
    ec = _mk_edge(g, b, a, 1)      # its rc: b->a  (chimeric fold-back)
    assert e.edge_id == ec.edge_id ^ 1
    n = fix_chimeric_junctions(g)
    assert n >= 1
    # the junction at b is split: e's right node no longer feeds ec
    assert ec.node_left is not e.node_right


def test_fix_chimeric_junction_double():
    store = SequenceStore()
    store.add("d", np.zeros(60000, np.uint8))
    g = RepeatGraph(store)
    n = [g.add_node() for _ in range(5)]
    e0 = _mk_edge(g, n[0], n[2], 0)
    e0c = _mk_edge(g, n[2], n[1], 1)
    e1 = _mk_edge(g, n[3], n[2], 2)
    e1c = _mk_edge(g, n[2], n[4], 3)
    assert len(n[2].in_edges) == 2 and len(n[2].out_edges) == 2
    count = fix_chimeric_junctions(g)
    assert count == 1
    # each in-edge now feeds only its non-complement out-edge
    assert e0.node_right is not e0c.node_left or \
        e1.node_right is not e1c.node_left


def test_separate_path_and_clear_resolved():
    g, u0, r, rc, u1, u2 = make_fork_graph()
    cfg = Config("raw", min_overlap=2000)
    reads = SequenceStore()
    reads.add("read0", np.zeros(30000, np.uint8))
    aligner = FakeAligner(_voting_alignments(u0, r, u1, u2))
    res = RepeatResolver(g, reads, aligner, cfg, FakeInferer())
    res.find_repeats()
    assert r.repetitive
    from flye_jax.repeat.resolver import Connection
    conn = Connection([u0, r, u1], 0, 100, 20000)
    res.resolve_connections([conn] * 6, 0.5)
    # middle edge resolved and a bridge spliced in
    assert r.resolved
    assert len(u0.node_right.out_edges) == 1
    bridge = u0.node_right.out_edges[0]
    assert bridge.length() == 19900
    assert bridge.node_right.out_edges == [u1]
    # coverage subtraction is deferred until finalize
    cov_before = r.mean_coverage
    res.finalize_graph()
    assert r.mean_coverage < cov_before


def test_resolve_simple_repeats():
    """Two entrances and two exits around one repeat path, paired
    one-to-one by reads -> both connections spliced."""
    store = SequenceStore()
    store.add("d", np.zeros(60000, np.uint8))
    g = RepeatGraph(store)
    n = [g.add_node() for _ in range(14)]
    in1 = _mk_edge(g, n[0], n[2], 0)
    _mk_edge(g, n[3], n[1], 1)
    in2 = _mk_edge(g, n[4], n[2], 2)
    _mk_edge(g, n[3], n[5], 3)
    rep = _mk_edge(g, n[2], n[6], 4, cov=60)
    _mk_edge(g, n[7], n[3], 5, cov=60)
    out1 = _mk_edge(g, n[6], n[8], 6)
    _mk_edge(g, n[9], n[7], 7)
    out2 = _mk_edge(g, n[6], n[10], 8)
    _mk_edge(g, n[11], n[7], 9)
    rep.repetitive = True
    g.complement_edge(rep).repetitive = True

    reads = SequenceStore()
    for i in range(6):
        reads.add(f"r{i}", np.zeros(30000, np.uint8))
    alns = []
    for i, (a, b) in enumerate([(in1, out1)] * 3 + [(in2, out2)] * 3):
        rid = 2 * i
        alns.append([_aln(a, 0, 9000, read_id=rid),
                     _aln(rep, 9000, 15000, read_id=rid),
                     _aln(b, 15000, 24000, read_id=rid)])
    cfg = Config("raw", min_overlap=2000)
    res = RepeatResolver(g, reads, FakeAligner(alns), cfg, FakeInferer())
    n_resolved = res.resolve_simple_repeats()
    assert n_resolved == 2
    # each entrance is rerouted through its own bridge to its exit
    b1 = in1.node_right.out_edges[0]
    assert b1.node_right.out_edges == [out1]
    b2 = in2.node_right.out_edges[0]
    assert b2.node_right.out_edges == [out2]


def make_superbubble_graph():
    """start -> (x1|x2) -> end with both branches short, plus strand."""
    store = SequenceStore()
    store.add("d", np.zeros(60000, np.uint8))
    g = RepeatGraph(store)
    n = [g.add_node() for _ in range(8)]
    start = _mk_edge(g, n[0], n[1], 0, length=9000)
    _mk_edge(g, n[2], n[3], 1, length=9000)
    x1 = _mk_edge(g, n[1], n[4], 2, length=800)
    _mk_edge(g, n[5], n[2], 3, length=800)
    x2 = _mk_edge(g, n[1], n[4], 4, length=900)
    _mk_edge(g, n[5], n[2], 5, length=900)
    end = _mk_edge(g, n[4], n[6], 6, length=9000)
    _mk_edge(g, n[7], n[5], 7, length=9000)
    return g, start, x1, x2, end


def test_find_superbubbles():
    g, start, x1, x2, end = make_superbubble_graph()
    cfg = Config("raw", min_overlap=2000)
    hap = HaplotypeResolver(g, cfg)
    found = hap.find_superbubbles()
    assert found == 1
    assert x1.alt_haplotype and x2.alt_haplotype
    assert g.complement_edge(x1).alt_haplotype
    assert not start.alt_haplotype and not end.alt_haplotype
    assert start.right_link is end


def test_roundabout_masking():
    g, start, x1, x2, end = make_superbubble_graph()
    cfg = Config("raw", min_overlap=2000)
    reads = SequenceStore()
    for i in range(8):
        reads.add(f"read{i}", np.zeros(30000, np.uint8))
    alns = []
    for i in range(4):
        for rid, branch in ((2 * i, x1), (2 * (i + 4), x2)):
            chain = [_aln(start, 0, 9000, read_id=rid),
                     _aln(branch, 9000, 9000 + branch.length(),
                          read_id=rid),
                     _aln(end, 9000 + branch.length(),
                          18000 + branch.length(), read_id=rid)]
            alns.append(chain)
            # the complement chain, as the real ReadAligner emits
            alns.append([EdgeAlignment(a.overlap.complement(),
                                       g.complement_edge(a.edge))
                         for a in reversed(chain)])
    hap = HaplotypeResolver(g, cfg, aligner=FakeAligner(alns),
                            reads=reads)
    found = hap.find_roundabouts()
    assert found == 1
    assert x1.alt_haplotype and x2.alt_haplotype
    assert start.right_link is end
