import numpy as np

from flye_jax.config import Config
from flye_jax.io import SequenceStore
from flye_jax.repeat.graph import EdgeSequence, GraphEdge, RepeatGraph
from flye_jax.repeat.haplotype import HaplotypeResolver


def make_bubble_graph():
    """in -> (branchA | branchB) -> out, plus complements."""
    store = SequenceStore()
    store.add("d", np.zeros(20000, np.uint8))
    g = RepeatGraph(store)
    nodes = [g.add_node() for _ in range(6)]  # fwd: 0-1-2; rc: 3-4-5

    def mk(eid, a, b, start, end, cov):
        e = GraphEdge(nodes[a], nodes[b], eid)
        e.seq_segments.append(EdgeSequence(0, 20000, start, end))
        e.mean_coverage = cov
        g.add_edge(e)
        return e

    e_in = mk(0, 0, 1, 0, 5000, 30)
    mk(1, 4, 3, 0, 5000, 30)           # complement of in
    br_a = mk(2, 1, 2, 5000, 6000, 18)
    mk(3, 5, 4, 5000, 6000, 18)
    br_b = mk(4, 1, 2, 5000, 6050, 9)  # lower coverage branch
    mk(5, 5, 4, 5000, 6050, 9)
    e_out = mk(6, 2, 0 + 0, 6000, 20000, 30)
    # fix: out edge goes 2 -> its own node
    g.edges[6].node_right.in_edges.remove(g.edges[6])
    extra = g.add_node()
    g.edges[6].node_right = extra
    extra.in_edges.append(g.edges[6])
    mk(7, 5 - 5, 5, 6000, 20000, 30)
    g.edges[7].node_left.out_edges.remove(g.edges[7])
    extra2 = g.add_node()
    g.edges[7].node_left = extra2
    extra2.out_edges.append(g.edges[7])
    return g, br_a, br_b


def test_find_and_collapse_bulge():
    g, br_a, br_b = make_bubble_graph()
    cfg = Config("raw", min_overlap=2000)
    hap = HaplotypeResolver(g, cfg)
    n = hap.find_heterozygous_bulges()
    assert n == 1
    # BOTH sides masked (reference behavior); groups assigned
    assert br_b.alt_haplotype and br_a.alt_haplotype
    assert g.complement_edge(br_b).alt_haplotype
    assert br_b.alt_group_id >= 0
    # flanking edges linked
    assert g.edges[0].right_link is g.edges[6]

    collapsed = hap.collapse_haplotypes()
    assert collapsed == 1
    # no sequence is deleted: both branches stay in the graph as a
    # separated alt component
    assert br_b.edge_id in g.edges
    assert br_a.edge_id in g.edges
    # the flanks are rerouted through a new bridge edge that carries
    # the lower-coverage branch's sequence (1050bp here)
    e_in, e_out = g.edges[0], g.edges[6]
    assert len(e_in.node_right.out_edges) == 1
    bridge = e_in.node_right.out_edges[0]
    assert bridge is not br_a and bridge is not br_b
    assert bridge.length() == 1050
    assert bridge.node_right.out_edges == [e_out]
    # branches no longer reachable from the entrance
    assert br_a.node_left is not e_in.node_right
    # complement strand mirrored: comp(out) -> comp bridge -> comp(in)
    c_in = g.complement_edge(e_out)
    c_out = g.complement_edge(e_in)
    assert len(c_in.node_right.out_edges) == 1
    c_bridge = c_in.node_right.out_edges[0]
    assert c_bridge.length() == 1050
    assert c_bridge.node_right.out_edges == [c_out]
    assert c_bridge.edge_id == bridge.edge_id ^ 1
    # reset clears masking state
    hap.reset_edges()
    assert not br_a.alt_haplotype and not br_b.alt_haplotype
    assert e_in.right_link is None


def test_keep_haplotypes_flag():
    cfg = Config("raw", keep_haplotypes=1)
    assert cfg.keep_haplotypes == 1
