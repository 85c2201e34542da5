"""End-to-end repeat graph + contigger on simulated genomes."""

import numpy as np
import pytest

from flye_jax.assemble import assemble_disjointigs
from flye_jax.config import Config
from flye_jax.contigger import generate_contigs
from flye_jax.io import SequenceStore
from flye_jax.repeat.driver import analyse_repeats
from flye_jax.repeat.processing import get_unbranching_paths
from flye_jax.utils.simulate import random_genome, simulate_reads


def build_stores(genome, coverage, seed, error_rate=0.0):
    reads = simulate_reads(genome, coverage=coverage, mean_length=6000,
                           min_length=2000, error_rate=error_rate,
                           circular=False, seed=seed)
    store = SequenceStore()
    for name, codes in reads:
        store.add(name, codes)
    return store


@pytest.mark.slow
def test_repeat_stage_simple_genome(tmp_path):
    # no repeats: expect a near-linear graph and ~1 contig
    genome = random_genome(30000, seed=401)
    reads = build_stores(genome, 15, 402)
    cfg = Config("corrected", min_overlap=2000)
    disjointigs = assemble_disjointigs(reads, cfg)
    assert disjointigs

    dstore = SequenceStore()
    for name, codes in disjointigs:
        dstore.add(name, codes)
    graph, aligner, inferer = analyse_repeats(
        dstore, reads, cfg, out_dir=str(tmp_path))
    assert len(graph.edges) >= 2  # fwd + rc of at least one edge
    assert not graph.validate()
    assert len(aligner.alignments) > 0
    assert inferer.mean_coverage > 5

    contigs, links = generate_contigs(graph, aligner, cfg,
                                      out_dir=str(tmp_path))
    assert contigs
    total = sum(c.length for c in contigs)
    assert total >= 0.85 * len(genome)
    # dumps written
    assert (tmp_path / "repeat_graph_dump").exists()
    assert (tmp_path / "contigs.fasta").exists()
    assert (tmp_path / "graph_final.gfa").exists()
    stats = (tmp_path / "contigs_stats.txt").read_text()
    assert stats.startswith("#seq_name")


@pytest.mark.slow
def test_repeat_stage_with_repeat(tmp_path):
    # genome with a long exact repeat: the graph should not be a single
    # edge — the repeat creates structure; contigs should still cover
    # most of the genome
    rng = np.random.default_rng(500)
    unique1 = rng.integers(0, 4, size=12000).astype(np.uint8)
    repeat = rng.integers(0, 4, size=4000).astype(np.uint8)
    unique2 = rng.integers(0, 4, size=12000).astype(np.uint8)
    unique3 = rng.integers(0, 4, size=12000).astype(np.uint8)
    genome = np.concatenate([unique1, repeat, unique2, repeat, unique3])

    reads = build_stores(genome, 18, 501)
    cfg = Config("corrected", min_overlap=2000)
    disjointigs = assemble_disjointigs(reads, cfg)
    assert disjointigs

    dstore = SequenceStore()
    for name, codes in disjointigs:
        dstore.add(name, codes)
    graph, aligner, inferer = analyse_repeats(
        dstore, reads, cfg, out_dir=str(tmp_path))
    assert not graph.validate()

    contigs, links = generate_contigs(graph, aligner, cfg,
                                      out_dir=str(tmp_path))
    assert contigs
    total = sum(c.length for c in contigs)
    # unique portion of the genome is 36kb + one repeat copy 4kb
    assert total >= 0.7 * (len(genome) - 4000)


def test_graph_dump_roundtrip(tmp_path):
    # construct a tiny graph by hand and round-trip the dump
    from flye_jax.repeat.graph import (EdgeSequence, GraphEdge,
                                       RepeatGraph)
    store = SequenceStore()
    store.add("d1", np.zeros(1000, np.uint8))
    g = RepeatGraph(store)
    n1, n2 = g.add_node(), g.add_node()
    e = GraphEdge(n1, n2, 0)
    e.seq_segments.append(EdgeSequence(0, 1000, 10, 500))
    e.mean_coverage = 7
    g.add_edge(e)
    ce = GraphEdge(n2, n1, 1)
    ce.seq_segments.append(EdgeSequence(0, 1000, 10, 500).complement())
    g.add_edge(ce)

    path = str(tmp_path / "dump")
    g.store(path)
    g2 = RepeatGraph.load(store, path)
    assert len(g2.edges) == 2
    assert g2.edges[0].mean_coverage == 7
    assert g2.edges[0].seq_segments[0].start == 10
    assert g2.edges[1].seq_segments[0].orig_seq_id == 1


def _mk_edge_pair(g, n1, n2, n1c, n2c, base_id, cov=0):
    from flye_jax.repeat.graph import GraphEdge
    e = GraphEdge(n1, n2, base_id)
    e.mean_coverage = cov
    g.add_edge(e)
    ce = GraphEdge(n2c, n1c, base_id ^ 1)
    ce.mean_coverage = cov
    g.add_edge(ce)
    return e, ce


class _FakeAligner:
    def __init__(self, graph, alignments):
        self.graph = graph
        self.alignments = alignments

    def update_alignments(self):
        from flye_jax.repeat.read_aligner import ReadAligner
        ReadAligner.update_alignments(self)


def test_split_nodes_chimeric_junction():
    """A 2-in/2-out node whose reads only connect A->C and B->D must
    split into two nodes (reference splitNodes behavior)."""
    from flye_jax.repeat.graph import RepeatGraph
    from flye_jax.repeat.multiplicity import MultiplicityInferer
    from flye_jax.repeat.read_aligner import EdgeAlignment

    store = SequenceStore()
    g = RepeatGraph(store)
    a1, b1, mid, c2, d2 = (g.add_node() for _ in range(5))
    a1c, b1c, midc, c2c, d2c = (g.add_node() for _ in range(5))
    A, Ac = _mk_edge_pair(g, a1, mid, a1c, midc, 0)
    B, Bc = _mk_edge_pair(g, b1, mid, b1c, midc, 2)
    C, Cc = _mk_edge_pair(g, mid, c2, midc, c2c, 4)
    D, Dc = _mk_edge_pair(g, mid, d2, midc, d2c, 6)

    chains = [
        [EdgeAlignment(None, A), EdgeAlignment(None, C)],
        [EdgeAlignment(None, Cc), EdgeAlignment(None, Ac)],
        [EdgeAlignment(None, B), EdgeAlignment(None, D)],
        [EdgeAlignment(None, Dc), EdgeAlignment(None, Bc)],
    ]
    aligner = _FakeAligner(g, chains)
    cfg = Config("corrected", min_overlap=2000)
    inf = MultiplicityInferer(g, aligner, cfg)

    assert inf.split_nodes() == 1
    assert A.node_right is C.node_left
    assert B.node_right is D.node_left
    assert A.node_right is not B.node_right
    # complements mirrored
    assert Cc.node_right is Ac.node_left
    assert Dc.node_right is Bc.node_left
    assert Cc.node_right is not Dc.node_right
    # alignments still valid chains after the split
    assert len(aligner.alignments) == 4
    # second call is a no-op
    assert inf.split_nodes() == 0


def test_disconnect_minor_paths_detaches_weak_path():
    from flye_jax.repeat.graph import RepeatGraph
    from flye_jax.repeat.multiplicity import MultiplicityInferer

    store = SequenceStore()
    g = RepeatGraph(store)
    nl, nr = g.add_node(), g.add_node()
    nlc, nrc = g.add_node(), g.add_node()
    outer = [g.add_node() for _ in range(8)]
    outerc = [g.add_node() for _ in range(8)]
    # deep edges around both junctions (cov 30)
    _mk_edge_pair(g, outer[0], nl, outerc[0], nlc, 0, cov=30)
    _mk_edge_pair(g, outer[1], nl, outerc[1], nlc, 2, cov=30)
    _mk_edge_pair(g, nl, outer[2], nlc, outerc[2], 4, cov=30)
    _mk_edge_pair(g, nr, outer[3], nrc, outerc[3], 6, cov=30)
    _mk_edge_pair(g, nr, outer[4], nrc, outerc[4], 8, cov=30)
    _mk_edge_pair(g, outer[5], nr, outerc[5], nrc, 10, cov=30)
    # the weak path in between (cov 2)
    W, Wc = _mk_edge_pair(g, nl, nr, nlc, nrc, 12, cov=2)

    aligner = _FakeAligner(g, [])
    cfg = Config("corrected", min_overlap=2000)
    inf = MultiplicityInferer(g, aligner, cfg)

    assert inf.disconnect_minor_paths() == 1
    # W fully detached: its endpoints are fresh degree-1 nodes
    assert len(W.node_left.in_edges) == 0
    assert W.node_left.out_edges == [W]
    assert len(W.node_right.out_edges) == 0
    assert W.node_right.in_edges == [W]
    assert Wc.node_left.out_edges == [Wc]
    assert Wc.node_right.in_edges == [Wc]
    # deep junctions no longer see W
    assert W not in nl.out_edges and Wc not in nrc.out_edges
    assert inf.disconnect_minor_paths() == 0


def test_contig_extension_into_repeat():
    """A unique path flanked by an unresolved repeat edge is extended
    by the longest spanning read (reference generateContigs behavior),
    and the absorbed repeat is not emitted as its own contig."""
    from flye_jax.contigger.extender import generate_contigs
    from flye_jax.repeat.graph import EdgeSequence, RepeatGraph
    from flye_jax.repeat.read_aligner import EdgeAlignment
    from flye_jax.overlap.structs import Overlap

    rng = np.random.default_rng(11)
    uniq = rng.integers(0, 4, 8000, dtype=np.uint8)
    rep = rng.integers(0, 4, 3000, dtype=np.uint8)

    store = SequenceStore()
    store.add("d", np.concatenate([uniq, rep]))
    g = RepeatGraph(store)
    n = [g.add_node() for _ in range(8)]
    U, Uc = _mk_edge_pair(g, n[0], n[1], n[2], n[3], 0, cov=30)
    U.seq_segments.append(EdgeSequence(0, 11000, 0, 8000))
    Uc.seq_segments.append(EdgeSequence(0, 11000, 0, 8000).complement())
    R, Rc = _mk_edge_pair(g, n[1], n[4], n[5], n[2], 2, cov=60)
    R.repetitive = Rc.repetitive = True
    R.seq_segments.append(EdgeSequence(0, 11000, 8000, 11000))
    Rc.seq_segments.append(EdgeSequence(0, 11000, 8000, 11000).complement())
    # a second exit from the repeat so R is not a trivial dead end
    X, Xc = _mk_edge_pair(g, n[4], n[6], n[7], n[5], 4, cov=30)
    # a second entrance into n1 so U and R stay separate unbranching
    # paths (otherwise n1 is 1-in-1-out and they merge)
    m1, m2 = g.add_node(), g.add_node()
    W, Wc = _mk_edge_pair(g, m1, n[1], n[2], m2, 6, cov=30)

    reads = SequenceStore()
    # read covers last 2kb of U and all of R
    read_codes = np.concatenate([uniq[6000:], rep])
    rid = reads.add("spanning_read", read_codes)

    class A:
        pass
    aligner = A()
    aligner.reads = reads
    ov_u = Overlap(int(rid), 0, 0, 2000, len(read_codes), 6000, 8000, 8000)
    ov_r = Overlap(int(rid), 2, 2000, 5000, len(read_codes), 0, 3000, 3000)
    aligner.alignments = [[EdgeAlignment(ov_u, U), EdgeAlignment(ov_r, R)]]

    cfg = Config("raw", min_overlap=1000)
    contigs, _links = generate_contigs(g, aligner, cfg)
    by_path = {c.graph_path: c for c in contigs}
    # the unique contig was extended through the repeat edge
    ext = [c for c in contigs if c.graph_path in ("1,2", "1,-2", "1,2,",)]
    assert any(c.graph_path.startswith("1,") and "2" in c.graph_path
               for c in contigs), by_path.keys()
    main = next(c for c in contigs if c.graph_path.startswith("1,"))
    # core (8000) + read extension (3000 of repeat)
    assert main.length == 11000
    assert np.array_equal(main.sequence[8000:], rep)
    # absorbed repeat not emitted separately
    assert not any(c.repetitive for c in contigs)
