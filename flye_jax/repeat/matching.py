"""Maximum-weight general matching (Edmonds' blossom algorithm).

A port of ``networkx.algorithms.matching.max_weight_matching``
(NetworkX 3.x, BSD-3-Clause, Copyright (C) 2004-2024 NetworkX
Developers), itself derived from Joris van Rantwijk's ``mwmatching.py``
and Galil's survey ("Efficient Algorithms for Finding Maximum Matching
in Graphs", ACM Computing Surveys, 1986).  The repeat resolver used the
library call; this copy keeps its exact visiting order, so results and
tie-breaking are unchanged, without the dependency.

Only the ``maxcardinality=False`` mode is kept.  The graph is a
dict-of-dicts adjacency ``{u: {v: weight}}`` whose insertion order
plays the role of NetworkX's node and neighbour order (see
``add_edge``).
"""

from __future__ import annotations

from itertools import repeat
from typing import Dict, Hashable, Set, Tuple

Adjacency = Dict[Hashable, Dict[Hashable, int]]


def add_edge(adj: Adjacency, u, v, weight) -> None:
    """Add (or overwrite) an undirected edge, ordering nodes and
    neighbours as ``networkx.Graph.add_edge`` does."""
    adj.setdefault(u, {})
    adj.setdefault(v, {})
    adj[u][v] = weight
    adj[v][u] = weight


def _edges(adj: Adjacency):
    """Each undirected edge once, in ``networkx.Graph.edges`` order."""
    seen = set()
    for u, nbrs in adj.items():
        for v, wt in nbrs.items():
            if v not in seen:
                yield u, v, wt
        seen.add(u)


class _NoNode:
    """Dummy value which is different from any node."""


class _Blossom:
    """A non-trivial blossom or sub-blossom.

    childs: ordered sub-blossoms, starting with the base and going round
    the blossom.  edges[i] = (v, w) connects childs[i] (holding v) to
    childs[i+1] (holding w).  mybestedges: for a top-level S-blossom,
    the least-slack edges to neighbouring S-blossoms (or None)."""

    __slots__ = ["childs", "edges", "mybestedges"]

    def leaves(self):
        stack = [*self.childs]
        while stack:
            t = stack.pop()
            if isinstance(t, _Blossom):
                stack.extend(t.childs)
            else:
                yield t


def max_weight_matching(adj: Adjacency) -> Set[Tuple]:
    """A maximum-weight matching of the undirected graph ``adj``, as a
    set of (u, v) pairs, each matched edge once.  O(nodes ** 3)."""
    NoNode = _NoNode
    Blossom = _Blossom
    gnodes = list(adj)
    if not gnodes:
        return set()

    maxweight = 0
    allinteger = True
    for i, j, wt in _edges(adj):
        if i != j and wt > maxweight:
            maxweight = wt
        allinteger = allinteger and isinstance(wt, int)

    # mate[v]: v's partner; single vertices are absent
    mate = {}
    # label[b]: None free, 1 S-blossom, 2 T-blossom (top-level blossoms;
    # for vertices inside T-blossoms, 2 iff reachable from outside)
    label = {}
    # labeledge[b] = (v, w): edge through which b got its label
    labeledge = {}
    # inblossom[v]: top-level blossom holding vertex v
    inblossom = dict(zip(gnodes, gnodes))
    # blossomparent[b]: immediate parent (sub-)blossom, None at top level
    blossomparent = dict(zip(gnodes, repeat(None)))
    # blossombase[b]: base vertex of (sub-)blossom b
    blossombase = dict(zip(gnodes, gnodes))
    # bestedge[w]: least-slack edge from an S-vertex (free w), or to a
    # different S-blossom (top-level S-blossom w)
    bestedge = {}
    # dualvar[v] = 2 * u(v); integer weights keep everything integral
    dualvar = dict(zip(gnodes, repeat(maxweight)))
    # blossomdual[b] = z(b) of non-trivial blossoms
    blossomdual = {}
    # edges known to have zero slack
    allowedge = {}
    # newly discovered S-vertices
    queue = []

    def slack(v, w):
        """2 * slack of edge (v, w) (not valid inside blossoms)."""
        return dualvar[v] + dualvar[w] - 2 * adj[v][w]

    def assignLabel(w, t, v):
        b = inblossom[w]
        assert label.get(w) is None and label.get(b) is None
        label[w] = label[b] = t
        if v is not None:
            labeledge[w] = labeledge[b] = (v, w)
        else:
            labeledge[w] = labeledge[b] = None
        bestedge[w] = bestedge[b] = None
        if t == 1:
            if isinstance(b, Blossom):
                queue.extend(b.leaves())
            else:
                queue.append(b)
        elif t == 2:
            base = blossombase[b]
            assignLabel(mate[base], 1, base)

    def scanBlossom(v, w):
        """Trace back from v and w: the base of a new blossom, or
        NoNode when an augmenting path was found."""
        path = []
        base = NoNode
        while v is not NoNode:
            b = inblossom[v]
            if label[b] & 4:
                base = blossombase[b]
                break
            assert label[b] == 1
            path.append(b)
            label[b] = 5
            if labeledge[b] is None:
                assert blossombase[b] not in mate
                v = NoNode
            else:
                assert labeledge[b][0] == mate[blossombase[b]]
                v = labeledge[b][0]
                b = inblossom[v]
                assert label[b] == 2
                v = labeledge[b][0]
            if w is not NoNode:
                v, w = w, v
        for b in path:
            label[b] = 1
        return base

    def addBlossom(base, v, w):
        bb = inblossom[base]
        bv = inblossom[v]
        bw = inblossom[w]
        b = Blossom()
        blossombase[b] = base
        blossomparent[b] = None
        blossomparent[bb] = b
        b.childs = path = []
        b.edges = edgs = [(v, w)]
        while bv != bb:
            blossomparent[bv] = b
            path.append(bv)
            edgs.append(labeledge[bv])
            assert label[bv] == 2 or (
                label[bv] == 1
                and labeledge[bv][0] == mate[blossombase[bv]])
            v = labeledge[bv][0]
            bv = inblossom[v]
        path.append(bb)
        path.reverse()
        edgs.reverse()
        while bw != bb:
            blossomparent[bw] = b
            path.append(bw)
            edgs.append((labeledge[bw][1], labeledge[bw][0]))
            assert label[bw] == 2 or (
                label[bw] == 1
                and labeledge[bw][0] == mate[blossombase[bw]])
            w = labeledge[bw][0]
            bw = inblossom[w]
        assert label[bb] == 1
        label[b] = 1
        labeledge[b] = labeledge[bb]
        blossomdual[b] = 0
        for v in b.leaves():
            if label[inblossom[v]] == 2:
                queue.append(v)
            inblossom[v] = b
        bestedgeto = {}
        for bv in path:
            if isinstance(bv, Blossom):
                if bv.mybestedges is not None:
                    nblist = bv.mybestedges
                    bv.mybestedges = None
                else:
                    nblist = [(v, w) for v in bv.leaves()
                              for w in adj[v] if v != w]
            else:
                nblist = [(bv, w) for w in adj[bv] if bv != w]
            for k in nblist:
                (i, j) = k
                if inblossom[j] == b:
                    i, j = j, i
                bj = inblossom[j]
                if (bj != b and label.get(bj) == 1
                        and ((bj not in bestedgeto)
                             or slack(i, j) < slack(*bestedgeto[bj]))):
                    bestedgeto[bj] = k
            bestedge[bv] = None
        b.mybestedges = list(bestedgeto.values())
        mybestedge = None
        mybestslack = None
        bestedge[b] = None
        for k in b.mybestedges:
            kslack = slack(*k)
            if mybestedge is None or kslack < mybestslack:
                mybestedge = k
                mybestslack = kslack
        bestedge[b] = mybestedge

    def expandBlossom(b, endstage):
        # recursion flattened into a trampoline of generators
        def _recurse(b, endstage):
            for s in b.childs:
                blossomparent[s] = None
                if isinstance(s, Blossom):
                    if endstage and blossomdual[s] == 0:
                        yield s
                    else:
                        for v in s.leaves():
                            inblossom[v] = s
                else:
                    inblossom[s] = s
            if (not endstage) and label.get(b) == 2:
                # relabel the sub-blossoms of an expanding T-blossom,
                # from its entry child round to the base
                entrychild = inblossom[labeledge[b][1]]
                j = b.childs.index(entrychild)
                if j & 1:
                    j -= len(b.childs)
                    jstep = 1
                else:
                    jstep = -1
                v, w = labeledge[b]
                while j != 0:
                    if jstep == 1:
                        p, q = b.edges[j]
                    else:
                        q, p = b.edges[j - 1]
                    label[w] = None
                    label[q] = None
                    assignLabel(w, 2, v)
                    allowedge[(p, q)] = allowedge[(q, p)] = True
                    j += jstep
                    if jstep == 1:
                        v, w = b.edges[j]
                    else:
                        w, v = b.edges[j - 1]
                    allowedge[(v, w)] = allowedge[(w, v)] = True
                    j += jstep
                bw = b.childs[j]
                label[w] = label[bw] = 2
                labeledge[w] = labeledge[bw] = (v, w)
                bestedge[bw] = None
                j += jstep
                while b.childs[j] != entrychild:
                    bv = b.childs[j]
                    if label.get(bv) == 1:
                        j += jstep
                        continue
                    if isinstance(bv, Blossom):
                        for v in bv.leaves():
                            if label.get(v):
                                break
                    else:
                        v = bv
                    if label.get(v):
                        assert label[v] == 2
                        assert inblossom[v] == bv
                        label[v] = None
                        label[mate[blossombase[bv]]] = None
                        assignLabel(v, 2, labeledge[v][0])
                    j += jstep
            label.pop(b, None)
            labeledge.pop(b, None)
            bestedge.pop(b, None)
            del blossomparent[b]
            del blossombase[b]
            del blossomdual[b]

        stack = [_recurse(b, endstage)]
        while stack:
            top = stack[-1]
            for s in top:
                stack.append(_recurse(s, endstage))
                break
            else:
                stack.pop()

    def augmentBlossom(b, v):
        """Swap matched/unmatched edges on the alternating path through
        blossom b between vertex v and the base."""
        def _recurse(b, v):
            t = v
            while blossomparent[t] != b:
                t = blossomparent[t]
            if isinstance(t, Blossom):
                yield (t, v)
            i = j = b.childs.index(t)
            if i & 1:
                j -= len(b.childs)
                jstep = 1
            else:
                jstep = -1
            while j != 0:
                j += jstep
                t = b.childs[j]
                if jstep == 1:
                    w, x = b.edges[j]
                else:
                    x, w = b.edges[j - 1]
                if isinstance(t, Blossom):
                    yield (t, w)
                j += jstep
                t = b.childs[j]
                if isinstance(t, Blossom):
                    yield (t, x)
                mate[w] = x
                mate[x] = w
            b.childs = b.childs[i:] + b.childs[:i]
            b.edges = b.edges[i:] + b.edges[:i]
            blossombase[b] = blossombase[b.childs[0]]
            assert blossombase[b] == v

        stack = [_recurse(b, v)]
        while stack:
            top = stack[-1]
            for args in top:
                stack.append(_recurse(*args))
                break
            else:
                stack.pop()

    def augmentMatching(v, w):
        for s, j in ((v, w), (w, v)):
            while 1:
                bs = inblossom[s]
                assert label[bs] == 1
                assert (labeledge[bs] is None
                        and blossombase[bs] not in mate) or (
                    labeledge[bs][0] == mate[blossombase[bs]])
                if isinstance(bs, Blossom):
                    augmentBlossom(bs, s)
                mate[s] = j
                if labeledge[bs] is None:
                    break
                t = labeledge[bs][0]
                bt = inblossom[t]
                assert label[bt] == 2
                s, j = labeledge[bt]
                assert blossombase[bt] == t
                if isinstance(bt, Blossom):
                    augmentBlossom(bt, j)
                mate[j] = s

    def verifyOptimum():
        assert min(dualvar.values()) >= 0
        assert len(blossomdual) == 0 or min(blossomdual.values()) >= 0
        for i, j, wt in _edges(adj):
            if i == j:
                continue
            s = dualvar[i] + dualvar[j] - 2 * wt
            iblossoms = [i]
            jblossoms = [j]
            while blossomparent[iblossoms[-1]] is not None:
                iblossoms.append(blossomparent[iblossoms[-1]])
            while blossomparent[jblossoms[-1]] is not None:
                jblossoms.append(blossomparent[jblossoms[-1]])
            iblossoms.reverse()
            jblossoms.reverse()
            for bi, bj in zip(iblossoms, jblossoms):
                if bi != bj:
                    break
                s += 2 * blossomdual[bi]
            assert s >= 0
            if mate.get(i) == j or mate.get(j) == i:
                assert mate[i] == j and mate[j] == i
                assert s == 0
        for v in gnodes:
            assert (v in mate) or dualvar[v] == 0
        for b in blossomdual:
            if blossomdual[b] > 0:
                assert len(b.edges) % 2 == 1
                for i, j in b.edges[1::2]:
                    assert mate[i] == j and mate[j] == i

    # each iteration is a stage that finds one augmenting path
    while 1:
        label.clear()
        labeledge.clear()
        bestedge.clear()
        for b in blossomdual:
            b.mybestedges = None
        allowedge.clear()
        queue[:] = []
        for v in gnodes:
            if (v not in mate) and label.get(inblossom[v]) is None:
                assignLabel(v, 1, None)

        augmented = 0
        while 1:
            # substage: label until an augmenting path is found, else
            # pump slack out of the dual variables
            while queue and not augmented:
                v = queue.pop()
                assert label[inblossom[v]] == 1
                for w in adj[v]:
                    if w == v:
                        continue
                    bv = inblossom[v]
                    bw = inblossom[w]
                    if bv == bw:
                        continue
                    if (v, w) not in allowedge:
                        kslack = slack(v, w)
                        if kslack <= 0:
                            allowedge[(v, w)] = allowedge[(w, v)] = True
                    if (v, w) in allowedge:
                        if label.get(bw) is None:
                            assignLabel(w, 2, v)
                        elif label.get(bw) == 1:
                            base = scanBlossom(v, w)
                            if base is not NoNode:
                                addBlossom(base, v, w)
                            else:
                                augmentMatching(v, w)
                                augmented = 1
                                break
                        elif label.get(w) is None:
                            assert label[bw] == 2
                            label[w] = 2
                            labeledge[w] = (v, w)
                    elif label.get(bw) == 1:
                        if (bestedge.get(bv) is None
                                or kslack < slack(*bestedge[bv])):
                            bestedge[bv] = (v, w)
                    elif label.get(w) is None:
                        if (bestedge.get(w) is None
                                or kslack < slack(*bestedge[w])):
                            bestedge[w] = (v, w)

            if augmented:
                break

            # delta1: minimum vertex dual
            deltatype = 1
            delta = min(dualvar.values())
            deltaedge = deltablossom = None
            # delta2: minimum slack between an S-vertex and a free one
            for v in gnodes:
                if (label.get(inblossom[v]) is None
                        and bestedge.get(v) is not None):
                    d = slack(*bestedge[v])
                    if d < delta:
                        delta = d
                        deltatype = 2
                        deltaedge = bestedge[v]
            # delta3: half the minimum slack between two S-blossoms
            for b in blossomparent:
                if (blossomparent[b] is None and label.get(b) == 1
                        and bestedge.get(b) is not None):
                    kslack = slack(*bestedge[b])
                    if allinteger:
                        assert (kslack % 2) == 0
                        d = kslack // 2
                    else:
                        d = kslack / 2.0
                    if d < delta:
                        delta = d
                        deltatype = 3
                        deltaedge = bestedge[b]
            # delta4: minimum z of a T-blossom
            for b in blossomdual:
                if (blossomparent[b] is None and label.get(b) == 2
                        and blossomdual[b] < delta):
                    delta = blossomdual[b]
                    deltatype = 4
                    deltablossom = b

            for v in gnodes:
                if label.get(inblossom[v]) == 1:
                    dualvar[v] -= delta
                elif label.get(inblossom[v]) == 2:
                    dualvar[v] += delta
            for b in blossomdual:
                if blossomparent[b] is None:
                    if label.get(b) == 1:
                        blossomdual[b] += delta
                    elif label.get(b) == 2:
                        blossomdual[b] -= delta

            if deltatype == 1:
                break
            elif deltatype == 2:
                (v, w) = deltaedge
                assert label[inblossom[v]] == 1
                allowedge[(v, w)] = allowedge[(w, v)] = True
                queue.append(v)
            elif deltatype == 3:
                (v, w) = deltaedge
                allowedge[(v, w)] = allowedge[(w, v)] = True
                assert label[inblossom[v]] == 1
                queue.append(v)
            elif deltatype == 4:
                expandBlossom(deltablossom, False)

        for v in mate:
            assert mate[mate[v]] == v
        if not augmented:
            break
        # end of stage: expand S-blossoms with zero dual
        for b in list(blossomdual.keys()):
            if b not in blossomdual:
                continue
            if (blossomparent[b] is None and label.get(b) == 1
                    and blossomdual[b] == 0):
                expandBlossom(b, True)

    if allinteger:
        verifyOptimum()

    matching = set()
    for u, v in mate.items():
        if (v, u) not in matching:
            matching.add((u, v))
    return matching
