"""Maximum-weight matching port (repeat/matching.py) against brute force
and against matchings recorded from the library it was ported from."""

import itertools
import random

import pytest

from flye_jax.repeat.matching import add_edge, max_weight_matching


def _build(edges):
    adj = {}
    for a, b, w in edges:
        add_edge(adj, a, b, adj.get(a, {}).get(b, 0) + w)
    return adj


def _brute_force_best(adj):
    """Best total weight over every subset of edges that is a matching."""
    edges = [(u, v, w) for u in adj for v, w in adj[u].items() if u < v]
    best = 0
    for r in range(len(edges) + 1):
        for sub in itertools.combinations(edges, r):
            nodes = [x for u, v, _ in sub for x in (u, v)]
            if len(nodes) == len(set(nodes)):
                best = max(best, sum(w for _, _, w in sub))
    return best


def _check_matching(adj, matching):
    seen = set()
    for u, v in matching:
        assert v in adj[u]
        assert u not in seen and v not in seen
        seen.update((u, v))
    return sum(adj[u][v] for u, v in matching)


@pytest.mark.parametrize("seed", range(6))
def test_matches_brute_force(seed):
    rng = random.Random(seed)
    for _ in range(40):
        n = rng.randint(2, 7)
        edges = []
        for _ in range(rng.randint(0, 10)):
            a, b = rng.randrange(n), rng.randrange(n)
            if a != b:
                edges.append((a, b, rng.randint(1, 9)))
        adj = _build(edges)
        got = _check_matching(adj, max_weight_matching(adj))
        assert got == _brute_force_best(adj)


# (edges in insertion order, matching) recorded from
# networkx.max_weight_matching 3.6: ties must break the same way
_RECORDED = [
    ([(4, 5, 3), (8, 0, 2), (3, 0, 1), (1, 5, 2), (3, 6, 3), (1, 3, 1),
      (3, 6, 2), (2, 6, 1), (1, 2, 3), (7, 2, 1), (4, 5, 1)],
     [(0, 8), (1, 2), (3, 6), (4, 5)]),
    ([(8, 3, 1), (3, 6, 2), (0, 5, 2), (4, 1, 2), (4, 0, 3), (5, 1, 2),
      (5, 4, 2), (5, 2, 2), (7, 2, 1), (4, 0, 3), (5, 6, 1), (8, 6, 2),
      (6, 0, 2)],
     [(0, 4), (1, 5), (2, 7), (6, 8)]),
    ([(0, 2, 3), (3, 1, 1), (7, 5, 3), (5, 8, 2), (7, 1, 3), (5, 4, 1),
      (6, 1, 1), (5, 8, 3), (5, 2, 2), (4, 8, 1), (4, 5, 2), (2, 1, 3),
      (2, 4, 2), (2, 0, 1)],
     [(0, 2), (1, 7), (5, 8)]),
    ([(8, 6, 1), (3, 5, 2), (7, 6, 1), (7, 5, 1), (6, 1, 1), (6, 5, 1),
      (0, 6, 2), (2, 7, 3), (2, 8, 2), (7, 5, 2), (7, 6, 1)],
     [(0, 6), (2, 8), (5, 7)]),
    ([(1, 6, 3), (2, 7, 2), (2, 1, 2), (4, 8, 3), (8, 5, 1), (5, 0, 2),
      (5, 8, 3), (4, 7, 2), (4, 5, 3), (2, 0, 2), (8, 4, 2), (4, 7, 2),
      (8, 5, 2), (4, 5, 3)],
     [(0, 2), (1, 6), (4, 7), (5, 8)]),
    ([(6, 5, 1), (7, 5, 2), (8, 2, 3), (2, 3, 2), (7, 4, 3), (1, 6, 1),
      (8, 6, 2), (8, 4, 3), (0, 3, 1), (7, 2, 1), (2, 0, 2), (3, 2, 1),
      (2, 1, 2), (2, 7, 1)],
     [(1, 6), (2, 3), (4, 8), (5, 7)]),
]


@pytest.mark.parametrize("edges,expected", _RECORDED)
def test_recorded_tie_breaking(edges, expected):
    adj = _build(edges)
    got = sorted(tuple(sorted(e)) for e in max_weight_matching(adj))
    assert got == expected


def test_empty_graph():
    assert max_weight_matching({}) == set()
