"""Repeat graph construction from disjointig self-alignments.

Behavioral port of RepeatGraph (reference: src/repeat_graph/repeat_graph.{h,cpp}):
gluepoint computation by two-stage endpoint clustering
(repeat_graph.cpp:108-424), strand-symmetric node creation, and edge
initialization by mutual-projection segment clustering
(repeat_graph.cpp:697-997).  All overlaps come from the device-backed
overlap engine with base-level divergence and bad-mapping partitioning,
matching the reference's asmOverlapper configuration
(repeat_graph.cpp:84-93).

Graph representation is plain Python objects — this layer is irregular,
pointer-heavy host work by design (SURVEY §2 note); only the alignment
compute underneath runs on device.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flye_jax.io.seqstore import SeqId, SequenceStore
from flye_jax.utils.ds import DisjointSet

logger = logging.getLogger("flye_jax")


@dataclass
class EdgeSequence:
    """A disjointig segment supporting a graph edge
    (reference: repeat_graph.h:15-95)."""
    orig_seq_id: int
    orig_seq_len: int
    start: int
    end: int
    # id of the edge-consensus sequence in the edge-seq store (set when
    # sequences are generated)
    edge_seq_id: int = -1

    @property
    def length(self) -> int:
        return self.end - self.start

    def complement(self) -> "EdgeSequence":
        return EdgeSequence(SeqId(self.orig_seq_id).rc, self.orig_seq_len,
                            self.orig_seq_len - self.end - 1,
                            self.orig_seq_len - self.start - 1,
                            SeqId(self.edge_seq_id).rc
                            if self.edge_seq_id >= 0 else -1)

    def key(self):
        return (self.orig_seq_id, self.start, self.end)


class GraphNode:
    __slots__ = ("node_id", "in_edges", "out_edges")

    def __init__(self, node_id: int):
        self.node_id = node_id
        self.in_edges: List["GraphEdge"] = []
        self.out_edges: List["GraphEdge"] = []

    @property
    def is_bifurcation(self) -> bool:
        return len(self.out_edges) != 1 or len(self.in_edges) != 1

    def degree(self):
        n_in = sum(1 for e in self.in_edges if not e.is_looped)
        n_out = sum(1 for e in self.out_edges if not e.is_looped)
        return n_in, n_out

    @property
    def is_end(self) -> bool:
        n_in, n_out = self.degree()
        return (n_in == 1 and n_out == 0) or (n_in == 0 and n_out == 1)

    def neighbors(self):
        out = set()
        for e in self.in_edges:
            if e.node_left is not self:
                out.add(e.node_left)
        for e in self.out_edges:
            if e.node_right is not self:
                out.add(e.node_right)
        return out


class GraphEdge:
    __slots__ = ("node_left", "node_right", "edge_id", "seq_segments",
                 "repetitive", "self_complement", "resolved",
                 "alt_haplotype", "alt_group_id", "mean_coverage",
                 "left_link", "right_link")

    def __init__(self, node_left: GraphNode, node_right: GraphNode,
                 edge_id: int):
        self.node_left = node_left
        self.node_right = node_right
        self.edge_id = edge_id
        self.seq_segments: List[EdgeSequence] = []
        self.repetitive = False
        self.self_complement = False
        self.resolved = False
        self.alt_haplotype = False
        self.alt_group_id = -1
        self.mean_coverage = 0
        self.left_link: Optional["GraphEdge"] = None
        self.right_link: Optional["GraphEdge"] = None

    @property
    def is_looped(self) -> bool:
        return self.node_left is self.node_right

    def length(self) -> int:
        if not self.seq_segments:
            return 0
        return sum(s.length for s in self.seq_segments) // \
            len(self.seq_segments)

    def __repr__(self):
        sign = "-" if self.edge_id % 2 else "+"
        return f"Edge({sign}{self.edge_id // 2 + 1})"


@dataclass
class GluePoint:
    point_id: int
    seq_id: int
    position: int


class RepeatGraph:
    def __init__(self, asm_store: SequenceStore):
        self.asm = asm_store
        # sequences beyond this count were spliced in during resolution
        # (read bridges) and are dumped alongside the graph
        self.base_seq_count = len(asm_store)
        self.nodes: List[GraphNode] = []
        self.edges: Dict[int, GraphEdge] = {}
        self._next_edge_id = 0
        self._next_node_id = 0
        self.glue_points: Dict[int, List[GluePoint]] = {}
        # consensus sequences for edges, filled by output generation
        self.edge_seqs: Optional[SequenceStore] = None

    # ------------------------------------------------------------------
    # primitives
    # ------------------------------------------------------------------

    def add_node(self) -> GraphNode:
        node = GraphNode(self._next_node_id)
        self._next_node_id += 1
        self.nodes.append(node)
        return node

    def add_edge(self, edge: GraphEdge) -> GraphEdge:
        self.edges[edge.edge_id] = edge
        edge.node_left.out_edges.append(edge)
        edge.node_right.in_edges.append(edge)
        # keep the id allocator ahead of any explicitly-assigned id
        self._next_edge_id = max(self._next_edge_id,
                                 (edge.edge_id | 1) + 1)
        return edge

    def remove_edge(self, edge: GraphEdge) -> None:
        edge.node_left.out_edges.remove(edge)
        edge.node_right.in_edges.remove(edge)
        del self.edges[edge.edge_id]

    def remove_node(self, node: GraphNode) -> None:
        """Remove a node together with all its edges
        (reference: repeat_graph.h:333-357 removeNode)."""
        to_remove = set()
        for edge in node.out_edges:
            if edge.node_right is not node:
                edge.node_right.in_edges.remove(edge)
            to_remove.add(edge.edge_id)
        for edge in node.in_edges:
            if edge.node_left is not node:
                edge.node_left.out_edges.remove(edge)
            to_remove.add(edge.edge_id)
        node.out_edges.clear()
        node.in_edges.clear()
        for eid in to_remove:
            self.edges.pop(eid, None)
        try:
            self.nodes.remove(node)
        except ValueError:
            pass

    def complement_edge(self, edge: GraphEdge) -> GraphEdge:
        if edge.self_complement:
            return edge
        return self.edges[edge.edge_id ^ 1]

    def complement_node(self, node: GraphNode) -> GraphNode:
        """The node holding the complements of this node's edges
        (derived from edge complements; the reference keeps an explicit
        map, reference: repeat_graph.h complementNode)."""
        for e in node.in_edges:
            return self.complement_edge(e).node_left
        for e in node.out_edges:
            return self.complement_edge(e).node_right
        return node

    def disconnect_right(self, edge: GraphEdge) -> None:
        """Detach edge's right end into a fresh node
        (reference: repeat_graph.h:372-378)."""
        new_node = self.add_node()
        edge.node_right.in_edges.remove(edge)
        edge.node_right = new_node
        new_node.in_edges.append(edge)

    def disconnect_left(self, edge: GraphEdge) -> None:
        """(reference: repeat_graph.h:380-386)."""
        new_node = self.add_node()
        edge.node_left.out_edges.remove(edge)
        edge.node_left = new_node
        new_node.out_edges.append(edge)

    def complement_path(self, path: Sequence[GraphEdge]) -> List[GraphEdge]:
        return [self.complement_edge(e) for e in reversed(path)]

    def iter_edges(self) -> List[GraphEdge]:
        return [self.edges[k] for k in sorted(self.edges)]

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    def build(self, ovlp_store, max_separation: int, min_overlap: int):
        """Full construction: gluepoints then edges
        (reference: repeat_graph.cpp:71-106 build)."""
        overlaps_by_seq = {
            sid: list(ovlp_store.lazy_overlaps(sid))
            for sid in self.asm.ids(both_strands=True)}
        self._get_gluepoints(overlaps_by_seq, max_separation, min_overlap)
        self._initialize_edges(overlaps_by_seq, max_separation)

    # -- gluepoints ----------------------------------------------------

    def _covering(self, overlaps_by_seq, seq_id, begin, end):
        return [o for o in overlaps_by_seq.get(seq_id, [])
                if o.cur_begin <= end and o.cur_end >= begin]

    def _get_gluepoints(self, overlaps_by_seq, max_sep: int,
                        min_overlap: int):
        """(reference: repeat_graph.cpp:108-424 getGluepoints)."""
        logger.debug("Computing gluepoints")
        # stage 1: cluster alignment endpoints along each sequence
        points: List[Tuple[int, int, int, int]] = []  # (curId,curPos,extId,extPos)
        for sid, ovlps in overlaps_by_seq.items():
            for o in ovlps:
                points.append((o.cur_id, o.cur_begin, o.ext_id, o.ext_begin))
                points.append((o.cur_id, o.cur_end, o.ext_id, o.ext_end))
        ds = DisjointSet()
        by_seq: Dict[int, List[int]] = {}
        for i, p in enumerate(points):
            ds.add(i)
            by_seq.setdefault(p[0], []).append(i)
        for sid, idxs in by_seq.items():
            idxs.sort(key=lambda i: points[i][1])
            for a, b in zip(idxs[:-1], idxs[1:]):
                if abs(points[a][1] - points[b][1]) < max_sep:
                    ds.union(a, b)
        clusters = ds.groups()

        # stage 2: per cluster, split by projections (Y) and insert the
        # resulting 1-d gluepoints (+ complements) into per-seq sorted
        # structures with their own union-find
        gp_records: Dict[int, List[dict]] = {}  # seq -> sorted point dicts
        gp_ds = DisjointSet()
        gp_counter = [0]
        comp_of: Dict[int, int] = {}

        def insert_point(seq_id: int, pos: int):
            lst = gp_records.setdefault(seq_id, [])
            import bisect
            keys = [r["pos"] for r in lst]
            i = bisect.bisect_left(keys, pos)
            rec = {"id": gp_counter[0], "seq": seq_id, "pos": pos}
            gp_counter[0] += 1
            gp_ds.add(rec["id"])
            merged = []
            if i > 0 and pos - lst[i - 1]["pos"] < max_sep:
                merged.append(lst[i - 1]["id"])
            if i < len(lst) and lst[i]["pos"] - pos < max_sep:
                merged.append(lst[i]["id"])
            lst.insert(i, rec)
            return rec["id"], merged

        for root, members in sorted(
                clusters.items(),
                key=lambda kv: (points[min(kv[1])][0],
                                points[min(kv[1])][1])):
            cl_pts = [points[i] for i in members]
            clust_seq = cl_pts[0][0]
            if clust_seq % 2 == 1:
                continue  # forward strands only
            xpos = int(np.median([p[1] for p in cl_pts]))

            # projections of the cluster X position through covering
            # overlaps (repeat hierarchy handling)
            ext_coords = [(p[2], p[3]) for p in cl_pts]
            for o in self._covering(overlaps_by_seq, clust_seq,
                                    xpos - 1, xpos + 1):
                if (o.cur_end - xpos > max_sep and
                        xpos - o.cur_begin > max_sep):
                    ext_coords.append((o.ext_id, o.project(xpos)))

            # cluster by (extId, extPos)
            ext_coords.sort()
            cluster_points = [(clust_seq, xpos)]
            run: List[Tuple[int, int]] = []
            for c in ext_coords + [(-9, -9)]:
                if run and (c[0] != run[-1][0] or
                            abs(c[1] - run[-1][1]) >= max_sep):
                    ypos = int(np.median([r[1] for r in run]))
                    cluster_points.append((run[0][0], ypos))
                    run = []
                if c[0] != -9:
                    run.append(c)

            # insert all cluster points + complements; union the whole
            # cluster together, mirroring every union on the complement
            # strand (reference: repeat_graph.cpp:288-295)
            to_merge: List[int] = []
            for seq_id, pos in cluster_points:
                slen = self.asm.length(seq_id)
                fid, merged = insert_point(seq_id, pos)
                cid, _ = insert_point(SeqId(seq_id).rc, slen - pos - 1)
                comp_of[fid] = cid
                comp_of[cid] = fid
                to_merge.extend(merged)
                to_merge.append(fid)
            for a, b in zip(to_merge, to_merge[1:]):
                gp_ds.union(a, b)
                gp_ds.union(comp_of[a], comp_of[b])

        # final consensus points per seq, splitting tandem runs
        point_id_map: Dict[int, int] = {}
        next_point = [0]

        def set_to_point(root) -> int:
            if root not in point_id_map:
                point_id_map[root] = next_point[0]
                next_point[0] += 1
            return point_id_map[root]

        self.glue_points = {}
        for seq_id, lst in gp_records.items():
            out = self.glue_points.setdefault(seq_id, [])
            group: List[dict] = []
            for rec in lst + [None]:
                if rec is not None and (
                        not group or
                        rec["pos"] - group[-1]["pos"] < max_sep):
                    group.append(rec)
                    continue
                if group:
                    pid = set_to_point(gp_ds.find(group[0]["id"]))
                    span = group[-1]["pos"] - group[0]["pos"]
                    if span > max_sep:
                        # tandem: multiple points sharing the id
                        repeats = span // max_sep
                        mode = span // max(1, repeats)
                        out.append(GluePoint(pid, seq_id, group[0]["pos"]))
                        for t in range(1, repeats):
                            out.append(GluePoint(
                                pid, seq_id, group[0]["pos"] + mode * t))
                        out.append(GluePoint(pid, seq_id, group[-1]["pos"]))
                    else:
                        pos = int(np.median([g["pos"] for g in group]))
                        out.append(GluePoint(pid, seq_id, pos))
                group = [rec] if rec else []

        # enforce forward/reverse symmetry
        for sid in self.asm.ids():
            fwd = self.glue_points.setdefault(sid, [])
            rev = self.glue_points.setdefault(SeqId(sid).rc, [])
            slen = self.asm.length(sid)
            if len(fwd) != len(rev):
                # resymmetrize from the forward strand with fresh ids
                # (the reference treats this as a hard error,
                # repeat_graph.cpp:725-728; we repair instead)
                logger.warning("resymmetrizing gluepoints on %s",
                               self.asm.name(sid))
                rev.clear()
                for gp in reversed(fwd):
                    rev.append(GluePoint(next_point[0], SeqId(sid).rc,
                                         slen - gp.position - 1))
                    next_point[0] += 1
            else:
                for i, gp in enumerate(fwd):
                    rev[len(fwd) - i - 1].position = slen - gp.position - 1

        # propagate gluepoints through covering overlaps until every
        # point projects onto a point on each overlapping sequence
        # (reference: repeat_graph.cpp:429-566 checkGluepointProjections)
        self._check_gluepoint_projections(overlaps_by_seq, max_sep,
                                          next_point)

        # contig endpoints (reference: repeat_graph.cpp:395-419)
        max_tip = min_overlap
        for sid in self.asm.ids():
            fwd = self.glue_points[sid]
            rev = self.glue_points[SeqId(sid).rc]
            slen = self.asm.length(sid)
            if not fwd or fwd[0].position > max_tip:
                fwd.insert(0, GluePoint(next_point[0], sid, 0))
                next_point[0] += 1
                rev.append(GluePoint(next_point[0], SeqId(sid).rc,
                                     slen - 1))
                next_point[0] += 1
            if len(fwd) == 1 or slen - fwd[-1].position > max_tip:
                fwd.append(GluePoint(next_point[0], sid, slen - 1))
                next_point[0] += 1
                rev.insert(0, GluePoint(next_point[0], SeqId(sid).rc, 0))
                next_point[0] += 1

        n = sum(len(v) for v in self.glue_points.values())
        logger.debug("Created %d gluepoints", n)

    def _check_gluepoint_projections(self, overlaps_by_seq, max_sep: int,
                                     next_point) -> None:
        """Fixpoint pass: every gluepoint must have a counterpart within
        max_sep on every sequence whose overlap covers it — merge ids
        when a counterpart exists, add a projected point when it
        doesn't, mirroring on the complement strand
        (reference: repeat_graph.cpp:429-566)."""
        import bisect

        for _ in range(100):
            added: Dict[int, List[GluePoint]] = {}
            merge_ds = DisjointSet()

            def union_pts(a: int, b: int) -> None:
                merge_ds.add(a)
                merge_ds.add(b)
                merge_ds.union(a, b)

            for sid in self.asm.ids():
                gps = self.glue_points.get(sid)
                if not gps:
                    continue
                rc_gps = self.glue_points[SeqId(sid).rc]
                for i, pt in enumerate(gps):
                    pt_compl = rc_gps[len(gps) - i - 1]
                    for o in self._covering(overlaps_by_seq, sid,
                                            pt.position - 1,
                                            pt.position + 1):
                        if not (o.cur_begin <= pt.position <= o.cur_end):
                            continue
                        try:
                            proj = o.project(pt.position)
                        except ValueError:
                            continue
                        ext_pts = self.glue_points.get(o.ext_id, [])
                        ext_rc = self.glue_points.get(
                            SeqId(o.ext_id).rc, [])
                        keys = [g.position for g in ext_pts]
                        lo = bisect.bisect_left(keys, proj - max_sep)
                        hi = bisect.bisect_left(keys, proj + max_sep)
                        valid = False
                        for j in range(lo, hi):
                            if abs(ext_pts[j].position - proj) > max_sep:
                                continue
                            if pt.point_id != ext_pts[j].point_id:
                                union_pts(pt.point_id,
                                          ext_pts[j].point_id)
                                comp_j = ext_rc[len(ext_pts) - j - 1]
                                union_pts(pt_compl.point_id,
                                          comp_j.point_id)
                            valid = True
                        if not valid:
                            slen = self.asm.length(o.ext_id)
                            proj = max(0, min(proj, slen - 1))
                            added.setdefault(o.ext_id, []).append(
                                GluePoint(pt.point_id, o.ext_id, proj))
                            added.setdefault(
                                SeqId(o.ext_id).rc, []).append(
                                GluePoint(pt_compl.point_id,
                                          SeqId(o.ext_id).rc,
                                          slen - proj - 1))

            total_added = 0
            for sid2 in sorted(added):
                if sid2 % 2 == 1:
                    continue
                pts = added[sid2]
                comp_pts = added[SeqId(sid2).rc]
                order = sorted(range(len(pts)),
                               key=lambda x: pts[x].position)
                last = None
                for pidx in order:
                    pt = pts[pidx]
                    cpt = comp_pts[pidx]
                    if last is None or abs(pt.position - last) > max_sep:
                        self.glue_points.setdefault(sid2, []).append(pt)
                        self.glue_points.setdefault(
                            SeqId(sid2).rc, []).append(cpt)
                        last = pt.position
                        total_added += 1
                self.glue_points[sid2].sort(key=lambda g: g.position)
                self.glue_points[SeqId(sid2).rc].sort(
                    key=lambda g: g.position)

            for lst in self.glue_points.values():
                for g in lst:
                    root = merge_ds.find(g.point_id)
                    if root is not None:
                        g.point_id = root
            logger.debug("Added %d gluepoint projections", total_added)
            if not total_added:
                break

    # -- edges ---------------------------------------------------------

    def _initialize_edges(self, overlaps_by_seq, max_sep: int):
        """(reference: repeat_graph.cpp:697-997 initializeEdges)."""
        logger.debug("Initializing edges")
        node_index: Dict[int, GraphNode] = {}

        def id_to_node(point_id: int) -> GraphNode:
            if point_id not in node_index:
                node_index[point_id] = self.add_node()
            return node_index[point_id]

        parallel: Dict[Tuple[int, int], List[EdgeSequence]] = {}
        compl_pair: Dict[Tuple[int, int], Tuple[int, int]] = {}
        checksum = 0
        for sid in self.asm.ids():
            gps = self.glue_points.get(sid, [])
            if len(gps) < 2:
                continue
            cgps = self.glue_points[SeqId(sid).rc]
            if len(gps) != len(cgps):
                logger.warning("asymmetric gluepoints on %s",
                               self.asm.name(sid))
                continue
            slen = self.asm.length(sid)
            for i in range(len(gps) - 1):
                gl, gr = gps[i], gps[i + 1]
                cl, cr = cgps[len(gps) - i - 2], cgps[len(gps) - i - 1]
                fwd_pair = (id_to_node(gl.point_id).node_id,
                            id_to_node(gr.point_id).node_id)
                rev_pair = (id_to_node(cl.point_id).node_id,
                            id_to_node(cr.point_id).node_id)
                seg = EdgeSequence(sid, slen, gl.position, gr.position)
                parallel.setdefault(fwd_pair, []).append(seg)
                parallel.setdefault(rev_pair, []).append(seg.complement())
                compl_pair[fwd_pair] = rev_pair
                compl_pair[rev_pair] = fwd_pair
                checksum += (gr.position - gl.position) ** 2
        logger.debug("Edges length checksum: %d", checksum)

        def seg_intersect(seg: EdgeSequence, b: int, e: int) -> int:
            return max(0, min(e, seg.end) - max(b, seg.start))

        used_pairs = set()
        singletons_filtered = 0
        for pair in sorted(parallel):
            if pair in used_pairs:
                continue
            used_pairs.add(compl_pair[pair])
            segs = parallel[pair]

            # cluster segments by mutual overlap projection
            ds = DisjointSet()
            for i in range(len(segs)):
                ds.add(i)
            by_seq: Dict[int, List[int]] = {}
            for i, s in enumerate(segs):
                by_seq.setdefault(s.orig_seq_id, []).append(i)
            for i, s in enumerate(segs):
                for o in self._covering(overlaps_by_seq, s.orig_seq_id,
                                        s.start, s.end):
                    if seg_intersect(s, o.cur_begin, o.cur_end) <= 0:
                        continue
                    try:
                        proj_s = o.project(s.start)
                        proj_e = o.project(s.end)
                    except ValueError:
                        continue
                    for j in by_seq.get(o.ext_id, []):
                        if ds.find(i) == ds.find(j):
                            continue
                        t = segs[j]
                        inter = seg_intersect(t, proj_s, proj_e)
                        if (inter > s.length / 2 and inter > t.length / 2):
                            ds.union(i, j)

            clusters = sorted(
                ds.groups().values(),
                key=lambda idxs: min((segs[i].orig_seq_id, segs[i].start)
                                     for i in idxs))

            used_segments = set()
            for idxs in clusters:
                # singleton segments fully covered by an overlap were
                # meant to be glued elsewhere -> drop
                if len(clusters) > 1 and len(idxs) == 1:
                    s = segs[idxs[0]]
                    covered = any(
                        seg_intersect(s, o.cur_begin, o.cur_end) == s.length
                        for o in self._covering(overlaps_by_seq,
                                                s.orig_seq_id, s.start,
                                                s.end))
                    if covered:
                        singletons_filtered += 1
                        continue
                any_seg = segs[idxs[0]]
                if any_seg.key() in used_segments:
                    continue
                left = self.nodes_by_id(pair[0])
                right = self.nodes_by_id(pair[1])
                base_id = self._next_edge_id
                edge = GraphEdge(left, right, base_id)
                for i in idxs:
                    edge.seq_segments.append(segs[i])
                    used_segments.add(segs[i].complement().key())
                edge.self_complement = any_seg.key() in used_segments
                self.add_edge(edge)
                if not edge.self_complement:
                    cpair = compl_pair[pair]
                    cedge = GraphEdge(self.nodes_by_id(cpair[0]),
                                      self.nodes_by_id(cpair[1]),
                                      base_id + 1)
                    for i in idxs:
                        cedge.seq_segments.append(segs[i].complement())
                    self.add_edge(cedge)
                self._next_edge_id = base_id + 2
        logger.debug("Filtered %d singleton segments", singletons_filtered)

    def nodes_by_id(self, node_id: int) -> GraphNode:
        return self.nodes[node_id]

    # ------------------------------------------------------------------
    # validation & serialization
    # ------------------------------------------------------------------

    def validate(self) -> List[str]:
        """Invariant checks (reference: repeat_graph.cpp:1117
        validateGraph)."""
        problems = []
        for edge in self.edges.values():
            if edge not in edge.node_left.out_edges:
                problems.append(f"{edge} missing from left node")
            if edge not in edge.node_right.in_edges:
                problems.append(f"{edge} missing from right node")
            if not edge.self_complement:
                if (edge.edge_id ^ 1) not in self.edges:
                    problems.append(f"{edge} missing complement")
                else:
                    ce = self.edges[edge.edge_id ^ 1]
                    if len(ce.seq_segments) != len(edge.seq_segments):
                        problems.append(f"{edge} complement segment "
                                        "count mismatch")
        return problems

    def store(self, path: str) -> None:
        """Reference-compatible text dump
        (reference: repeat_graph.cpp:1085-1292 storeGraph; python mirror
        flye/repeat_graph/repeat_graph.py). Bridge sequences spliced in
        during resolution go to <path>_extra.fasta (the reference keeps
        edge sequences in repeat_graph_edges.fasta)."""
        if len(self.asm) > self.base_seq_count:
            from flye_jax.io.fasta import write_fasta
            extras = [(self.asm.name(2 * i), self.asm.get(2 * i))
                      for i in range(self.base_seq_count, len(self.asm))]
            write_fasta(extras, path + "_extra.fasta")
        with open(path, "w") as f:
            for edge in self.iter_edges():
                sign = "+" if edge.edge_id % 2 == 0 else "-"
                eid = edge.edge_id // 2 + 1
                f.write(f"Edge\t{sign}{eid}\t{edge.node_left.node_id}\t"
                        f"{edge.node_right.node_id}\t"
                        f"{int(edge.repetitive)}\t"
                        f"{int(edge.self_complement)}\t"
                        f"{int(edge.resolved)}\t{edge.mean_coverage}\t"
                        f"{int(edge.alt_haplotype)}\n")
                for seg in edge.seq_segments:
                    ssign = "+" if seg.orig_seq_id % 2 == 0 else "-"
                    sid = seg.orig_seq_id // 2 + 1
                    f.write(f"\tSequence\t{ssign}{sid}\t{seg.orig_seq_len}"
                            f"\t{seg.start}\t{seg.end}\n")

    @classmethod
    def load(cls, asm_store: SequenceStore, path: str) -> "RepeatGraph":
        import os

        from flye_jax.io.fasta import read_seq_file
        graph = cls(asm_store)
        if os.path.exists(path + "_extra.fasta"):
            for name, codes in read_seq_file(path + "_extra.fasta"):
                asm_store.add(name, codes)
        node_map: Dict[int, GraphNode] = {}

        def node(nid: int) -> GraphNode:
            if nid not in node_map:
                node_map[nid] = graph.add_node()
            return node_map[nid]

        cur_edge = None
        with open(path) as f:
            for line in f:
                parts = line.strip().split("\t")
                if parts[0] == "Edge":
                    signed = parts[1]
                    eid = (int(signed[1:]) - 1) * 2 + (signed[0] == "-")
                    cur_edge = GraphEdge(node(int(parts[2])),
                                         node(int(parts[3])), eid)
                    cur_edge.repetitive = bool(int(parts[4]))
                    cur_edge.self_complement = bool(int(parts[5]))
                    cur_edge.resolved = bool(int(parts[6]))
                    cur_edge.mean_coverage = int(parts[7])
                    if len(parts) > 8:
                        cur_edge.alt_haplotype = bool(int(parts[8]))
                    graph.add_edge(cur_edge)
                    graph._next_edge_id = max(graph._next_edge_id,
                                              eid + 2)
                elif parts[0] == "Sequence":
                    signed = parts[1]
                    sid = (int(signed[1:]) - 1) * 2 + (signed[0] == "-")
                    cur_edge.seq_segments.append(EdgeSequence(
                        sid, int(parts[2]), int(parts[3]), int(parts[4])))
        return graph
