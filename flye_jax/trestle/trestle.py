"""Trestle: resolution of unbridged multiplicity-2 repeats.

Behavioral port of the Trestle stage essentials
(reference: flye/trestle/trestle.py:33-127 pipeline,
graph_resolver.py:45 get_simple_repeats, trestle_config.py:9-27).

A "simple" repeat is a repetitive unbranching path with exactly two
entrances and two exits that no single read bridges. The reference
resolves it by calling divergent positions between the two repeat
copies and iteratively partitioning reads by side; here the same idea
runs through our primitives:

1. reads entering from each in-edge are known-side by construction;
2. each side's reads polish their own copy of the repeat template
   (the polisher IS the divergent-position machinery — side-specific
   consensus encodes the copy's private variants);
3. each side's exiting reads vote for an out-edge; a confident,
   consistent vote bridges in->out and the graph is edited exactly like
   a read-bridged connection.

For repeats much longer than the reads, neither spanning votes nor a
single middle window can phase the copies: the reference iterates
divergent-position calling and read partitioning from both flanks
inward (reference: trestle.py:1075, divergence.py:146).  Here
`_iterative_partition` walks windows from the repeat start: each
window's per-side consensus comes from the reads assigned so far,
unassigned reads covering the window join the side with the smaller
edit distance, and the walk continues while the two side consensuses
stay distinguishable.  Reads that exit the repeat then vote entrance ->
exit pairings exactly like the spanning case.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from flye_jax.io.seqstore import SeqId, SequenceStore
from flye_jax.repeat.graph import EdgeSequence, GraphEdge, RepeatGraph
from flye_jax.repeat.output import path_sequence
from flye_jax.repeat.processing import UnbranchingPath, get_unbranching_paths

logger = logging.getLogger("flye_jax")

CONFIG = {
    # reference: flye/trestle/trestle_config.py:9-27
    "max_iter": 10,
    "buffer_count": 3,
    "min_edge_cov": 10,
    "min_aln_rate": 0.5,
    "min_bridge_count": 5,
    "min_bridge_factor": 2,
    "min_mult": 2,
    "max_mult": 3,
    "flanking_len": 10_000,
    "sub_thresh": 0.1,
    "del_thresh": 0.2,
    "ins_thresh": 0.3,
    "num_pol_iters": 1,
}


@dataclass
class SimpleRepeat:
    path: UnbranchingPath
    in_edges: List[GraphEdge]
    out_edges: List[GraphEdge]


def get_simple_repeats(graph: RepeatGraph,
                       mean_coverage: int) -> List[SimpleRepeat]:
    """Repetitive unbranching paths with exactly 2 entrances and 2 exits
    (reference: graph_resolver.py:45 get_simple_repeats)."""
    out = []
    seen = set()
    for path in get_unbranching_paths(graph):
        first, last = path.path[0], path.path[-1]
        if not path.repetitive or first.self_complement:
            continue
        if path.id in seen:
            continue
        comp_id = graph.complement_edge(last).edge_id
        seen.add(path.id)
        seen.add(comp_id)
        ins = [e for e in first.node_left.in_edges
               if not e.repetitive and not e.is_looped]
        outs = [e for e in last.node_right.out_edges
                if not e.repetitive and not e.is_looped]
        if len(ins) != 2 or len(outs) != 2:
            continue
        if len(first.node_left.in_edges) != 2 or \
                len(last.node_right.out_edges) != 2:
            continue
        mult = round(path.mean_coverage / max(1, mean_coverage))
        if not (CONFIG["min_mult"] <= mult <= CONFIG["max_mult"]):
            continue
        out.append(SimpleRepeat(path, ins, outs))
    return out


def resolve_unbridged_repeats(graph: RepeatGraph, reads: SequenceStore,
                              aligner, mean_coverage: int) -> int:
    """Resolve simple unbridged repeats by side voting. Returns the
    number of repeats resolved."""
    repeats = get_simple_repeats(graph, mean_coverage)
    if not repeats:
        return 0
    logger.info("Trestle: %d simple repeats to analyze", len(repeats))

    # index read chains by the edges they traverse
    chains_by_edge: Dict[int, List] = {}
    for chain in aligner.alignments:
        for a in chain:
            chains_by_edge.setdefault(a.edge.edge_id, []).append(chain)

    resolved = 0
    for rep in repeats:
        pairing = _vote_sides(rep, chains_by_edge)
        if pairing is None:
            pairing = _position_partition(graph, reads, rep,
                                          chains_by_edge)
        if pairing is None:
            pairing = _divergence_vote(graph, reads, rep, chains_by_edge)
        if pairing is None:
            pairing = _iterative_partition(graph, reads, rep,
                                           chains_by_edge)
        if pairing is None:
            continue
        (in_a, out_a), (in_b, out_b) = pairing
        for in_e, out_e in ((in_a, out_a), (in_b, out_b)):
            _bridge(graph, rep, in_e, out_e)
        for e in rep.path.path:
            e.resolved = True
        resolved += 1
        logger.debug("Trestle resolved repeat %s: %r->%r, %r->%r",
                     rep.path.name, in_a, out_a, in_b, out_b)
    if resolved:
        logger.info("Trestle: resolved %d unbridged repeats", resolved)
    return resolved


def _vote_sides(rep: SimpleRepeat, chains_by_edge) -> Optional[Tuple]:
    """Pair entrances with exits using reads that reach from a flank
    into the repeat and out again, or transitively via repeat-interior
    consistency. Requires min_bridge_count supporting chains and a
    min_bridge_factor majority (reference thresholds,
    trestle_config.py)."""
    votes: Dict[Tuple[int, int], int] = {}
    repeat_ids = {e.edge_id for e in rep.path.path}
    for in_e in rep.in_edges:
        for chain in chains_by_edge.get(in_e.edge_id, []):
            edge_ids = [a.edge.edge_id for a in chain]
            if in_e.edge_id not in edge_ids:
                continue
            pos = edge_ids.index(in_e.edge_id)
            # walk forward through the repeat to an exit
            for eid in edge_ids[pos + 1:]:
                if eid in repeat_ids:
                    continue
                for out_e in rep.out_edges:
                    if eid == out_e.edge_id:
                        key = (in_e.edge_id, out_e.edge_id)
                        votes[key] = votes.get(key, 0) + 1
                break
    if not votes:
        return None
    in_ids = [e.edge_id for e in rep.in_edges]
    out_ids = [e.edge_id for e in rep.out_edges]
    # two possible pairings
    p1 = ((in_ids[0], out_ids[0]), (in_ids[1], out_ids[1]))
    p2 = ((in_ids[0], out_ids[1]), (in_ids[1], out_ids[0]))
    s1 = votes.get(p1[0], 0) + votes.get(p1[1], 0)
    s2 = votes.get(p2[0], 0) + votes.get(p2[1], 0)
    best, alt, pairing = ((s1, s2, p1) if s1 >= s2 else (s2, s1, p2))
    if best < CONFIG["min_bridge_count"]:
        return None
    if alt > 0 and best < CONFIG["min_bridge_factor"] * alt:
        return None
    edge_map = {e.edge_id: e for e in rep.in_edges + rep.out_edges}
    return ((edge_map[pairing[0][0]], edge_map[pairing[0][1]]),
            (edge_map[pairing[1][0]], edge_map[pairing[1][1]]))


def _mid_segments(reads, rep, chains, repeat_edge, mid_lo, mid_hi):
    """Read substrings covering the repeat's middle interval, projected
    through their edge alignments."""
    segs = []
    for chain in chains:
        for a in chain:
            if a.edge is not repeat_edge:
                continue
            ov = a.overlap
            if ov.ext_begin > mid_lo or ov.ext_end < mid_hi:
                continue
            # ov: cur=read, ext=edge; project edge coords to read coords
            rev = ov.reverse()
            try:
                r0 = rev.project(mid_lo)
                r1 = rev.project(mid_hi)
            except ValueError:
                continue
            if r1 > r0:
                segs.append(reads.get(ov.cur_id)[r0:r1])
            break
    return segs


def _divergence_vote(graph: RepeatGraph, reads: SequenceStore,
                     rep: SimpleRepeat, chains_by_edge
                     ) -> Optional[Tuple]:
    """The genuinely-unbridged case: no read spans in->out, but entering
    and exiting reads overlap in the repeat middle. Build a
    side-specific consensus of the middle from each entrance's reads
    and match each exit's reads to the closer consensus
    (the polisher stands in for the reference's divergent-position
    calling + read partitioning, reference: flye/trestle/divergence.py,
    trestle.py:1075)."""
    from flye_jax.ops.align import SegmentBatcher
    from flye_jax.polishing.polisher import polish_bubble_set
    from flye_jax.polishing.windows import Bubble

    if len(rep.path.path) != 1:
        return None
    edge = rep.path.path[0]
    L = edge.length()
    w = min(500, L // 3)
    if w < 100:
        return None
    mid_lo, mid_hi = L // 2 - w // 2, L // 2 + w // 2
    template = path_sequence(graph, rep.path)[mid_lo:mid_hi]
    if not len(template):
        return None

    in_segs = {}
    for in_e in rep.in_edges:
        segs = _mid_segments(reads, rep,
                             chains_by_edge.get(in_e.edge_id, []),
                             edge, mid_lo, mid_hi)
        if len(segs) < 2:
            return None
        in_segs[in_e.edge_id] = segs
    out_segs = {}
    for out_e in rep.out_edges:
        segs = _mid_segments(reads, rep,
                             chains_by_edge.get(out_e.edge_id, []),
                             edge, mid_lo, mid_hi)
        if len(segs) < 2:
            return None
        out_segs[out_e.edge_id] = segs

    # side-specific middle consensuses via the polisher
    bubbles = []
    for in_id, segs in in_segs.items():
        b = Bubble(0, 0, 0, len(template), template.copy())
        b.branches = segs[:16]
        bubbles.append((in_id, b))
    polish_bubble_set([b for _, b in bubbles], "pacbio")
    consensus = {in_id: (b.polished if b.polished is not None
                         else b.candidate) for in_id, b in bubbles}

    # match exits to the nearer consensus
    batcher = SegmentBatcher()
    keys = []
    for out_id, segs in out_segs.items():
        for in_id, cons in consensus.items():
            for seg in segs[:8]:
                keys.append((out_id, in_id, batcher.add(seg, cons)))
    dists = batcher.run()
    score: Dict[Tuple[int, int], int] = {}
    for out_id, in_id, idx in keys:
        score[(out_id, in_id)] = score.get((out_id, in_id), 0) + \
            int(dists[idx])

    in_ids = [e.edge_id for e in rep.in_edges]
    out_ids = [e.edge_id for e in rep.out_edges]
    p1 = score.get((out_ids[0], in_ids[0]), 0) + \
        score.get((out_ids[1], in_ids[1]), 0)
    p2 = score.get((out_ids[0], in_ids[1]), 0) + \
        score.get((out_ids[1], in_ids[0]), 0)
    if p1 == p2:
        return None
    edge_map = {e.edge_id: e for e in rep.in_edges + rep.out_edges}
    if p1 < p2:  # lower edit distance = better match
        pairing = ((in_ids[0], out_ids[0]), (in_ids[1], out_ids[1]))
    else:
        pairing = ((in_ids[0], out_ids[1]), (in_ids[1], out_ids[0]))
    return ((edge_map[pairing[0][0]], edge_map[pairing[0][1]]),
            (edge_map[pairing[1][0]], edge_map[pairing[1][1]]))


def _path_offsets(rep: SimpleRepeat) -> Dict[int, int]:
    offsets = {}
    off = 0
    for e in rep.path.path:
        offsets[e.edge_id] = off
        off += e.length()
    return offsets


def _chain_repeat_segments(reads, rep, offsets, chain):
    """Read substrings projected onto repeat-path coordinates:
    [(path_lo, path_hi, codes)] for every repeat-path alignment."""
    segs = []
    for a in chain:
        off = offsets.get(a.edge.edge_id)
        if off is None:
            continue
        ov = a.overlap
        rev = ov.reverse()
        lo = off + ov.ext_begin
        hi = off + ov.ext_end
        if hi - lo < 50:
            continue
        codes = reads.get(ov.cur_id)[ov.cur_begin:ov.cur_end]
        segs.append((lo, hi, codes, rev))
    return segs


def _window_slice(segs, reads, lo, hi):
    """Read codes covering repeat window [lo, hi], via projection."""
    out = []
    for p_lo, p_hi, _codes, rev in segs:
        if p_lo > lo or p_hi < hi:
            continue
        try:
            r0 = rev.project(lo - (p_lo - rev.cur_begin))
            r1 = rev.project(hi - (p_lo - rev.cur_begin))
        except ValueError:
            continue
        if r1 > r0:
            out.append((r0, r1))
    return out


def _collect_repeat_chains(reads, rep, offsets, chains_by_edge,
                           in_ids, out_ids):
    """Unique read chains touching the repeat, annotated with entry /
    exit flank edges and their repeat-path segments."""
    repeat_ids = set(offsets)
    seen = set()
    chains = []
    for eid in list(repeat_ids) + in_ids + out_ids:
        for chain in chains_by_edge.get(eid, []):
            if id(chain) in seen:
                continue
            seen.add(id(chain))
            edge_ids = [a.edge.edge_id for a in chain]
            if not any(e in repeat_ids for e in edge_ids):
                continue
            entry = exit_e = None
            for a, b in zip(edge_ids[:-1], edge_ids[1:]):
                if a in in_ids and b in repeat_ids:
                    entry = a
                if a in repeat_ids and b in out_ids:
                    exit_e = b
            chains.append({"chain": chain, "entry": entry,
                           "exit": exit_e, "side": None,
                           "segs": _chain_repeat_segments(
                               reads, rep, offsets, chain)})
    return chains


def _pair_from_votes(chains, in_ids, out_ids, rep) -> Optional[Tuple]:
    """Entrance->exit pairing from phased chains' exit votes, with the
    reference's support thresholds (min_bridge_count / factor)."""
    votes: Dict[Tuple[int, int], int] = {}
    for rec in chains:
        if rec["side"] is None or rec["exit"] is None:
            continue
        key = (in_ids[rec["side"]], rec["exit"])
        votes[key] = votes.get(key, 0) + 1
    if not votes:
        return None
    p1 = ((in_ids[0], out_ids[0]), (in_ids[1], out_ids[1]))
    p2 = ((in_ids[0], out_ids[1]), (in_ids[1], out_ids[0]))
    s1 = votes.get(p1[0], 0) + votes.get(p1[1], 0)
    s2 = votes.get(p2[0], 0) + votes.get(p2[1], 0)
    best, alt, pairing = ((s1, s2, p1) if s1 >= s2 else (s2, s1, p2))
    if best < CONFIG["min_bridge_count"]:
        return None
    if alt > 0 and best < CONFIG["min_bridge_factor"] * alt:
        return None
    edge_map = {e.edge_id: e for e in rep.in_edges + rep.out_edges}
    return ((edge_map[pairing[0][0]], edge_map[pairing[0][1]]),
            (edge_map[pairing[1][0]], edge_map[pairing[1][1]]))


def _position_partition(graph: RepeatGraph, reads: SequenceStore,
                        rep: SimpleRepeat, chains_by_edge
                        ) -> Optional[Tuple]:
    """Statistical phasing by divergent positions — the reference's
    main Trestle loop (reference: flye/trestle/trestle.py:1075+ with
    divergence.py:146 find_divergence, thresholds
    trestle_config.py:19-21):

    1. pileup all repeat-covering reads against the repeat template and
       call tentative divergent positions (sub/del/ins thresholds);
    2. seed read sides from their entry flank; iterate: polish each
       side's FULL-repeat consensus with the polisher, take each side's
       base signature at the divergent positions, re-assign every
       unseeded read to the side whose signature it agrees with most;
    3. phased reads vote entrance->exit pairings.

    Refuses (returns None) when no divergent positions exist or the two
    side consensuses are identical at every called position — the
    must-not-bridge case."""
    from flye_jax.polishing.polisher import polish
    from flye_jax.trestle.divergence import (call_divergent_positions,
                                             consensus_signature,
                                             pileup_profile)

    L = rep.path.length
    offsets = _path_offsets(rep)
    template = path_sequence(graph, rep.path)
    if len(template) < L:
        L = len(template)
    if L < 300:
        return None
    in_ids = [e.edge_id for e in rep.in_edges]
    out_ids = [e.edge_id for e in rep.out_edges]
    chains = _collect_repeat_chains(reads, rep, offsets, chains_by_edge,
                                    in_ids, out_ids)
    sides = {in_ids[0]: 0, in_ids[1]: 1}
    n_seed = 0
    for rec in chains:
        if rec["entry"] is not None:
            rec["side"] = sides[rec["entry"]]
            n_seed += 1
    if n_seed < 4:
        return None

    # pileup over all repeat segments; merge a chain's segments into
    # one per-position signature row
    seg_list = []
    seg_owner = []
    for ci, rec in enumerate(chains):
        for (lo, hi, codes, rev) in rec["segs"]:
            if len(codes) < 100:
                continue
            seg_list.append((codes, lo))
            seg_owner.append(ci)
    if not seg_list:
        return None
    pile = pileup_profile(template[:L], seg_list)
    positions = call_divergent_positions(
        template[:L], pile, sub_thresh=CONFIG["sub_thresh"],
        del_thresh=CONFIG["del_thresh"],
        ins_thresh=CONFIG["ins_thresh"])["total"]
    if len(positions) == 0:
        logger.debug("Trestle %s: no divergent positions — refusing "
                     "to bridge", rep.path.name)
        return None
    seg_sigs = pile.read_base[:, positions]
    n_chains = len(chains)
    sigs = np.full((n_chains, len(positions)), -1, np.int8)
    for row, ci in enumerate(seg_owner):
        m = seg_sigs[row] >= 0
        sigs[ci, m] = seg_sigs[row, m]

    seeded = [rec["side"] for rec in chains]
    for _ in range(CONFIG["max_iter"]):
        side_sig = {}
        distinct = False
        for s in (0, 1):
            side_reads = SequenceStore()
            for ci, rec in enumerate(chains):
                if rec["side"] != s:
                    continue
                for si, (codes, lo) in enumerate(seg_list):
                    if seg_owner[si] == ci:
                        side_reads.add(f"r{ci}_{si}",
                                       np.ascontiguousarray(codes))
            if len(side_reads) < 2:
                return None
            cons = polish([(f"side{s}", template[:L].copy())],
                          side_reads, "pacbio",
                          num_iters=CONFIG["num_pol_iters"])[0][1]
            if not len(cons):
                cons = template[:L]
            side_sig[s] = consensus_signature(template[:L], cons,
                                              positions)
        if np.any((side_sig[0] != side_sig[1])
                  & (side_sig[0] >= 0) & (side_sig[1] >= 0)):
            distinct = True
        if not distinct:
            logger.debug("Trestle %s: side consensuses identical at "
                         "all divergent positions — refusing to bridge",
                         rep.path.name)
            return None
        # only positions where the sides differ are informative
        informative = np.flatnonzero(
            (side_sig[0] != side_sig[1])
            & (side_sig[0] >= 0) & (side_sig[1] >= 0))
        changed = False
        for ci, rec in enumerate(chains):
            if seeded[ci] is not None:
                continue
            sig = sigs[ci, informative]
            cov = sig >= 0
            if cov.sum() < 2:
                continue
            a0 = int(((sig == side_sig[0][informative]) & cov).sum())
            a1 = int(((sig == side_sig[1][informative]) & cov).sum())
            new = 0 if a0 > a1 else 1 if a1 > a0 else None
            if new is not None and rec["side"] != new:
                rec["side"] = new
                changed = True
        if not changed:
            break

    pairing = _pair_from_votes(chains, in_ids, out_ids, rep)
    if pairing is not None:
        logger.debug("Trestle %s: position-phased %d chains over %d "
                     "divergent positions", rep.path.name,
                     sum(1 for r in chains if r["side"] is not None),
                     len(positions))
    return pairing


def _iterative_partition(graph: RepeatGraph, reads: SequenceStore,
                         rep: SimpleRepeat, chains_by_edge
                         ) -> Optional[Tuple]:
    """Phase repeats longer than the reads: walk windows from the
    repeat start, building per-side consensuses from the reads assigned
    so far and recruiting unassigned reads to the closer side
    (reference: the iterative divergence/partition loop,
    flye/trestle/trestle.py:1075, divergence.py:146)."""
    from flye_jax.ops.align import SegmentBatcher
    from flye_jax.polishing.polisher import polish_bubble_set
    from flye_jax.polishing.windows import Bubble

    window = 500
    L = rep.path.length
    if L < 2 * window:
        return None
    offsets = _path_offsets(rep)
    template = path_sequence(graph, rep.path)
    if len(template) < L:
        L = len(template)

    in_ids = [e.edge_id for e in rep.in_edges]
    out_ids = [e.edge_id for e in rep.out_edges]
    repeat_ids = set(offsets)

    # collect unique chains touching the repeat; classify entry/exit
    seen = set()
    chains = []
    for eid in list(repeat_ids) + in_ids + out_ids:
        for chain in chains_by_edge.get(eid, []):
            if id(chain) in seen:
                continue
            seen.add(id(chain))
            edge_ids = [a.edge.edge_id for a in chain]
            if not any(e in repeat_ids for e in edge_ids):
                continue
            entry = exit_e = None
            for a, b in zip(edge_ids[:-1], edge_ids[1:]):
                if a in in_ids and b in repeat_ids:
                    entry = a
                if a in repeat_ids and b in out_ids:
                    exit_e = b
            chains.append({"chain": chain, "entry": entry,
                           "exit": exit_e, "side": None})

    sides = {in_ids[0]: 0, in_ids[1]: 1}
    for rec in chains:
        if rec["entry"] is not None:
            rec["side"] = sides[rec["entry"]]
        rec["segs"] = _chain_repeat_segments(reads, rep, offsets,
                                             rec["chain"])

    def read_codes(rec, r0, r1):
        # rev.ext_id is the (strand-aware) read id after reverse()
        rid = rec["segs"][0][3].ext_id if rec["segs"] else None
        return reads.get(rid)[r0:r1] if rid is not None else None

    # walk windows forward, phasing as we go
    pos = 0
    phased_to = 0
    while pos + window <= L:
        lo, hi = pos, pos + window
        side_wins = {0: [], 1: []}
        for rec in chains:
            if rec["side"] is None:
                continue
            for r0, r1 in _window_slice(rec["segs"], reads, lo, hi):
                codes = read_codes(rec, r0, r1)
                if codes is not None and len(codes):
                    side_wins[rec["side"]].append(codes)
                break
        if len(side_wins[0]) < 2 or len(side_wins[1]) < 2:
            break
        bubbles = []
        for s in (0, 1):
            b = Bubble(0, 0, lo, hi, template[lo:hi].copy())
            b.branches = side_wins[s][:16]
            bubbles.append(b)
        polish_bubble_set(bubbles, "pacbio")
        cons = [(b.polished if b.polished is not None else b.candidate)
                for b in bubbles]

        batcher = SegmentBatcher()
        diff_idx = batcher.add(cons[0], cons[1])
        cand_keys = []
        for ci, rec in enumerate(chains):
            if rec["side"] is not None:
                continue
            for r0, r1 in _window_slice(rec["segs"], reads, lo, hi):
                codes = read_codes(rec, r0, r1)
                if codes is None or not len(codes):
                    break
                k0 = batcher.add(codes, cons[0])
                k1 = batcher.add(codes, cons[1])
                cand_keys.append((ci, k0, k1))
                break
        dists = batcher.run()
        if dists[diff_idx] == 0:
            # copies locally identical: reads cannot be phased past here
            break
        for ci, k0, k1 in cand_keys:
            d0, d1 = int(dists[k0]), int(dists[k1])
            if d0 != d1:
                chains[ci]["side"] = 0 if d0 < d1 else 1
        phased_to = hi
        pos += window // 2

    if phased_to == 0:
        return None

    # exit votes from phased chains
    votes: Dict[Tuple[int, int], int] = {}
    for rec in chains:
        if rec["side"] is None or rec["exit"] is None:
            continue
        key = (in_ids[rec["side"]], rec["exit"])
        votes[key] = votes.get(key, 0) + 1
    if not votes:
        return None
    p1 = ((in_ids[0], out_ids[0]), (in_ids[1], out_ids[1]))
    p2 = ((in_ids[0], out_ids[1]), (in_ids[1], out_ids[0]))
    s1 = votes.get(p1[0], 0) + votes.get(p1[1], 0)
    s2 = votes.get(p2[0], 0) + votes.get(p2[1], 0)
    best, alt, pairing = ((s1, s2, p1) if s1 >= s2 else (s2, s1, p2))
    if best < CONFIG["min_bridge_count"]:
        return None
    if alt > 0 and best < CONFIG["min_bridge_factor"] * alt:
        return None
    logger.debug("Trestle iterative phasing: %s phased to %d/%d, "
                 "votes %d vs %d", rep.path.name, phased_to, L, best, alt)
    edge_map = {e.edge_id: e for e in rep.in_edges + rep.out_edges}
    return ((edge_map[pairing[0][0]], edge_map[pairing[0][1]]),
            (edge_map[pairing[1][0]], edge_map[pairing[1][1]]))


def _bridge(graph: RepeatGraph, rep: SimpleRepeat,
            in_edge: GraphEdge, out_edge: GraphEdge) -> None:
    """Splice a copy of the repeat sequence between a paired entrance
    and exit, and symmetrically on the complement strand
    (reference: graph_resolver.py:170 apply_changes)."""
    repeat_seq = path_sequence(graph, rep.path)
    bid = graph.asm.add(
        f"trestle_{rep.path.name}_{in_edge.edge_id}_{out_edge.edge_id}",
        np.ascontiguousarray(repeat_seq))
    comp_in = graph.complement_edge(out_edge)   # enters comp repeat
    comp_out = graph.complement_edge(in_edge)   # exits comp repeat
    base_id = graph._next_edge_id
    pairs = [(in_edge, out_edge, int(bid), base_id)]
    if comp_in is not out_edge:  # not palindromic
        pairs.append((comp_in, comp_out, int(SeqId(bid).rc), base_id + 1))
    for ie, oe, seq_id, eid in pairs:
        new_left = graph.add_node()
        ie.node_right.in_edges.remove(ie)
        ie.node_right = new_left
        new_left.in_edges.append(ie)
        new_right = graph.add_node()
        oe.node_left.out_edges.remove(oe)
        oe.node_left = new_right
        new_right.out_edges.append(oe)
        bridge = GraphEdge(new_left, new_right, eid)
        bridge.seq_segments.append(
            EdgeSequence(seq_id, len(repeat_seq), 0, len(repeat_seq)))
        bridge.mean_coverage = ie.mean_coverage
        graph.add_edge(bridge)
    graph._next_edge_id = base_id + 2
