"""Stitch a disjointig read path into one sequence.

Vectorized replacement for ConsensusGenerator
(reference: src/sequence/consensus_generator.cpp): the reference runs a
fresh ksw2 alignment per consecutive read pair just to locate a k-length
exact match run to switch reads at (consensus_generator.cpp:129-159).
Our overlaps already carry exact k-mer match anchors from the chain DP —
each anchor IS a k-length exact match — so the switch position is read
directly off the anchor list with the same rule (first anchor past
prev_switch + maximum_jump), eliminating the pairwise alignment pass
entirely.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import numpy as np

from flye_jax.assemble.extender import ContigPath
from flye_jax.io.seqstore import SequenceStore

logger = logging.getLogger("flye_jax")


def _switch_positions(overlap, prev_switch: int, k: int,
                      max_jump: int) -> Tuple[int, int]:
    """First exact-match anchor whose run starts after
    prev_switch + max_jump; switch right after the matched k-mer
    (reference: consensus_generator.cpp:129-159 getSwitchPositions)."""
    km = overlap.kmer_matches
    if km is not None:
        for c, e in km:
            if int(c) + 1 > prev_switch + max_jump:
                return int(c) + k, int(e) + k
    # no suitable anchor: degenerate fallback like the reference
    return max(prev_switch + 1, overlap.cur_begin), overlap.ext_begin


def stitch_path(path: ContigPath, store: SequenceStore, k: int,
                max_jump: int) -> np.ndarray:
    """Concatenate read segments switching at exact-match anchors
    (reference: consensus_generator.cpp:46-79 generateLinear)."""
    if len(path.reads) == 1:
        return store.get(path.reads[0]).copy()
    parts: List[np.ndarray] = []
    prev_switch = (0, 0)
    for i, rid in enumerate(path.reads):
        seq = store.get(rid)
        left_cut = prev_switch[1]
        right_cut = len(seq)
        if i != len(path.reads) - 1:
            cur_switch = _switch_positions(path.overlaps[i], prev_switch[1],
                                           k, max_jump)
            right_cut = cur_switch[0]
            prev_switch = cur_switch
        if right_cut - left_cut > 0:
            parts.append(seq[left_cut:right_cut])
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)


def generate_disjointig_sequences(paths: List[ContigPath],
                                  store: SequenceStore, k: int,
                                  max_jump: int):
    out = []
    for path in paths:
        seq = stitch_path(path, store, k, max_jump)
        if len(seq):
            out.append((path.name, seq))
    return out
