import numpy as np

from flye_jax.io import SequenceStore
from flye_jax.overlap.structs import Overlap
from flye_jax.repeat.graph import EdgeSequence, GraphEdge, RepeatGraph
from flye_jax.repeat.read_aligner import EdgeAlignment
from flye_jax.trestle import resolve_unbridged_repeats
from flye_jax.trestle.trestle import get_simple_repeats


class FakeAligner:
    def __init__(self, alignments):
        self.alignments = alignments


def build_repeat_graph():
    """inA/inB -> repeat (mult 2) -> outX/outY, plus complements."""
    store = SequenceStore()
    store.add("d", np.zeros(60000, np.uint8))
    g = RepeatGraph(store)
    nL = g.add_node()   # repeat entrance node
    nR = g.add_node()   # repeat exit node
    edges = {}

    def mk(eid, a, b, cov, rep=False, length=(0, 5000)):
        e = GraphEdge(a, b, eid)
        e.seq_segments.append(EdgeSequence(0, 60000, *length))
        e.mean_coverage = cov
        e.repetitive = rep
        g.add_edge(e)
        edges[eid] = e
        return e

    in_a = mk(0, g.add_node(), nL, 20)
    mk(1, g.add_node(), g.add_node(), 20)       # its complement (loose)
    in_b = mk(2, g.add_node(), nL, 20)
    mk(3, g.add_node(), g.add_node(), 20)
    repeat = mk(4, nL, nR, 40, rep=True, length=(10000, 14000))
    mk(5, g.add_node(), g.add_node(), 40, rep=True, length=(10000, 14000))
    out_x = mk(6, nR, g.add_node(), 20)
    mk(7, g.add_node(), g.add_node(), 20)
    out_y = mk(8, nR, g.add_node(), 20)
    mk(9, g.add_node(), g.add_node(), 20)
    return g, in_a, in_b, repeat, out_x, out_y


def make_chain(edges_seq, read_id=0):
    chain = []
    for i, e in enumerate(edges_seq):
        ov = Overlap(read_id, 100 + e.edge_id, i * 1000, (i + 1) * 1000,
                     10000, 0, 1000, 4000, score=500)
        chain.append(EdgeAlignment(ov, e))
    return chain


def test_get_simple_repeats():
    g, in_a, in_b, repeat, out_x, out_y = build_repeat_graph()
    reps = get_simple_repeats(g, mean_coverage=20)
    assert len(reps) == 1
    assert reps[0].path.path[0] is repeat
    assert {e.edge_id for e in reps[0].in_edges} == {0, 2}
    assert {e.edge_id for e in reps[0].out_edges} == {6, 8}


def test_resolve_by_spanning_votes():
    g, in_a, in_b, repeat, out_x, out_y = build_repeat_graph()
    store = SequenceStore()
    store.add("d2", np.zeros(60000, np.uint8))
    chains = []
    # 6 reads span A->repeat->X, 6 span B->repeat->Y, 1 noisy A->Y
    for i in range(6):
        chains.append(make_chain([in_a, repeat, out_x], read_id=2 * i))
        chains.append(make_chain([in_b, repeat, out_y], read_id=2 * i))
    chains.append(make_chain([in_a, repeat, out_y]))
    n_edges_before = len(g.edges)
    resolved = resolve_unbridged_repeats(g, g.asm, FakeAligner(chains),
                                         mean_coverage=20)
    assert resolved == 1
    assert repeat.resolved
    # two bridges spliced in, each with its complement edge
    assert len(g.edges) == n_edges_before + 4
    # entrances now reach their paired exits through the bridges
    assert in_a.node_right.out_edges
    bridge_a = in_a.node_right.out_edges[0]
    assert bridge_a.node_right.out_edges[0] is out_x


def test_insufficient_votes_no_resolution():
    g, in_a, in_b, repeat, out_x, out_y = build_repeat_graph()
    chains = [make_chain([in_a, repeat, out_x])] * 2  # below min count
    resolved = resolve_unbridged_repeats(g, g.asm, FakeAligner(chains),
                                         mean_coverage=20)
    assert resolved == 0
    assert not repeat.resolved
