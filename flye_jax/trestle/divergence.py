"""Statistical divergent-position calling between repeat copies.

Behavioral port of the reference's Trestle divergence machinery
(reference: flye/trestle/divergence.py:54-143 _contig_profile /
_count_freqs / _call_position, thresholds from trestle_config.py:19-21):
reads covering the repeat template are base-aligned to it (banded C++
alignment with traceback instead of the reference's SAM pipeline), a
per-position pileup counts matches / the most frequent substitution /
deletions / the most frequent insertion, and positions whose frequency
exceeds the per-type thresholds become "tentative divergent positions"
— the signal the iterative read partitioning phases reads with.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("flye_jax")

# reference: flye/trestle/trestle_config.py:19-21
SUB_THRESH = 0.1
DEL_THRESH = 0.2
INS_THRESH = 0.3


def banded_ops(a: np.ndarray, b: np.ndarray, band: int = 0) -> np.ndarray:
    """Alignment ops of a vs b: 0 = diagonal, 1 = delete a-char,
    2 = insert b-char.  Uses the native banded aligner; pure-NumPy
    full-DP fallback for short sequences when the toolchain is absent."""
    from flye_jax import native
    if band <= 0:
        band = max(32, int(0.15 * max(len(a), len(b))) + 8)
    mod = native.get()
    if mod is not None and hasattr(mod, "banded_align"):
        ops = mod.banded_align(
            np.ascontiguousarray(a, np.uint8).tobytes(),
            np.ascontiguousarray(b, np.uint8).tobytes(), int(band))
        return np.frombuffer(ops, np.uint8)
    # fallback: full DP (small inputs only)
    n, m = len(a), len(b)
    D = np.zeros((n + 1, m + 1), np.int32)
    D[:, 0] = np.arange(n + 1)
    D[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        sub = (b != a[i - 1]).astype(np.int32)
        row = D[i]
        prev = D[i - 1]
        row[0] = i
        for j in range(1, m + 1):
            row[j] = min(prev[j - 1] + sub[j - 1], prev[j] + 1,
                         row[j - 1] + 1)
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        if (i > 0 and j > 0 and
                D[i, j] == D[i - 1, j - 1] + (a[i - 1] != b[j - 1])):
            ops.append(0)
            i -= 1
            j -= 1
        elif i > 0 and D[i, j] == D[i - 1, j] + 1:
            ops.append(1)
            i -= 1
        else:
            ops.append(2)
            j -= 1
    return np.asarray(ops[::-1], np.uint8)


@dataclass
class Pileup:
    """Per-template-position counts.  matches[p, c] counts read base c
    (0-3) aligned to position p; matches[p, 4] counts deletions of p;
    insertions[p, c] counts base c inserted immediately before p."""
    matches: np.ndarray
    insertions: np.ndarray
    read_base: np.ndarray  # [n_reads, L] int8: read base at position
    #                        (-1 uncovered, 4 deletion)


def pileup_profile(template: np.ndarray,
                   segments: Sequence[Tuple[np.ndarray, int]],
                   band: int = 0) -> Pileup:
    """Align each read segment to the template and accumulate the
    pileup (reference: divergence.py:54-88 _contig_profile).

    segments: (read_codes, t_start) pairs; read_codes is the slice of
    the read covering template[t_start : ...].
    """
    L = len(template)
    matches = np.zeros((L, 5), np.int32)
    insertions = np.zeros((L, 4), np.int32)
    read_base = np.full((len(segments), L), -1, np.int8)
    for ri, (codes, t0) in enumerate(segments):
        t0 = max(0, int(t0))
        if t0 >= L or len(codes) == 0:
            continue
        tseq = template[t0:min(L, t0 + len(codes) + len(codes) // 4 + 32)]
        ops = banded_ops(codes, tseq, band)
        ti = t0
        qi = 0
        for op in ops:
            if op == 0:
                if ti < L:
                    matches[ti, codes[qi]] += 1
                    read_base[ri, ti] = codes[qi]
                ti += 1
                qi += 1
            elif op == 2:  # template char consumed, read gap: deletion
                if ti < L:
                    matches[ti, 4] += 1
                    read_base[ri, ti] = 4
                ti += 1
            else:  # op == 1: read char inserted before template pos ti
                if ti < L:
                    insertions[ti, codes[qi]] += 1
                qi += 1
    return Pileup(matches, insertions, read_base)


def call_divergent_positions(template: np.ndarray, pile: Pileup,
                             sub_thresh: float = SUB_THRESH,
                             del_thresh: float = DEL_THRESH,
                             ins_thresh: float = INS_THRESH
                             ) -> Dict[str, np.ndarray]:
    """Positions whose most frequent substitution / deletion / insertion
    exceeds its frequency threshold (reference: divergence.py:89-143
    _count_freqs + _call_position).  Returns {"sub","del","ins","total"}
    position arrays (template coordinates)."""
    L = len(template)
    cov = pile.matches.sum(axis=1).astype(np.float64)
    cov_safe = np.maximum(cov, 1)
    tmpl = template.astype(np.int64)
    base_counts = pile.matches[:, :4].copy()
    # exclude the template's own base from substitution candidates
    base_counts[np.arange(L), tmpl] = 0
    sub_ct = base_counts.max(axis=1)
    del_ct = pile.matches[:, 4]
    ins_ct = pile.insertions.max(axis=1)
    has_cov = cov > 0
    sub_pos = np.flatnonzero(has_cov & (sub_ct / cov_safe >= sub_thresh))
    del_pos = np.flatnonzero(has_cov & (del_ct / cov_safe >= del_thresh))
    ins_pos = np.flatnonzero(has_cov & (ins_ct / cov_safe >= ins_thresh))
    total = np.unique(np.concatenate([sub_pos, del_pos, ins_pos]))
    logger.debug("Divergent positions: %d total (%d sub, %d del, %d ins)"
                 " over %d bp", len(total), len(sub_pos), len(del_pos),
                 len(ins_pos), L)
    return {"sub": sub_pos, "del": del_pos, "ins": ins_pos,
            "total": total}


def position_signatures(pile: Pileup,
                        positions: np.ndarray) -> np.ndarray:
    """[n_reads, n_pos] int8 matrix of each read's base at the called
    positions (-1 where the read doesn't cover the position)."""
    if len(positions) == 0:
        return np.zeros((pile.read_base.shape[0], 0), np.int8)
    return pile.read_base[:, positions]


def classify_by_positions(signatures: np.ndarray,
                          side_sigs: Dict[int, np.ndarray],
                          min_covered: int = 2) -> List[int]:
    """Assign each read to the side whose consensus signature it agrees
    with most (margin >= 1 over the runner-up and >= min_covered
    informative positions); -1 = unassigned.

    This is the statistical core of the reference's iterative read
    partitioning (reference: trestle.py:1075+): reads vote only at
    divergent positions, not by whole-window distance."""
    n_reads = signatures.shape[0]
    out = []
    sides = sorted(side_sigs)
    for r in range(n_reads):
        sig = signatures[r]
        scores = {}
        for s in sides:
            ssig = side_sigs[s]
            covered = (sig >= 0) & (ssig >= 0)
            if covered.sum() < min_covered:
                scores[s] = (-1, 0)
                continue
            agree = int(((sig == ssig) & covered).sum())
            scores[s] = (agree, int(covered.sum()))
        ranked = sorted(sides, key=lambda s: -scores[s][0])
        best, second = ranked[0], (ranked[1] if len(ranked) > 1 else None)
        if scores[best][0] < 0:
            out.append(-1)
        elif second is not None and \
                scores[best][0] - scores[second][0] < 1:
            out.append(-1)
        else:
            out.append(best)
    return out


def consensus_signature(template: np.ndarray,
                        consensus: np.ndarray,
                        positions: np.ndarray,
                        band: int = 0) -> np.ndarray:
    """The side-consensus base at each divergent template position,
    from a banded alignment of the consensus to the template."""
    if len(positions) == 0:
        return np.zeros(0, np.int8)
    pile = pileup_profile(template, [(consensus, 0)], band=band)
    return pile.read_base[0, positions]
