"""Greedy disjointig extension.

Behavioral port of Extender (reference: src/assemble/extender.cpp).  The
walk itself is inherently sequential (each step depends on the evolving
inner-read state), so it runs as a host loop in the same deterministic
hash order as the reference (reference: extender.cpp:377-380), while all
overlap queries go through the lazily-cached device-backed OverlapStore.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from flye_jax.assemble.chimera import ChimeraDetector, iter_no_overhang
from flye_jax.io.seqstore import SeqId, SequenceStore
from flye_jax.overlap.engine import OverlapStore
from flye_jax.overlap.structs import Overlap

logger = logging.getLogger("flye_jax")


@dataclass
class ExtensionInfo:
    reads: List[int] = field(default_factory=list)
    left_tip: bool = False
    right_tip: bool = False
    num_suspicious: int = 0
    mean_overlaps: int = 0
    steps_to_turn: int = 0
    assembled_length: int = 0
    singleton: bool = False
    avg_overlap_size: int = 0
    min_overlap_size: int = 0
    short_extensions: int = 0


@dataclass
class ContigPath:
    name: str
    reads: List[int] = field(default_factory=list)
    overlaps: List[Overlap] = field(default_factory=list)  # len(reads)-1


def _id_hash(sid: int) -> int:
    """Deterministic shuffle key (splitmix-style) mirroring the
    reference's FastaRecord::Id::hash() ordering trick."""
    x = (sid & 0xFFFFFFFFFFFFFFFF) + 0x9E3779B97F4A7C15
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


class Extender:
    def __init__(self, store: SequenceStore, ovlp_store: OverlapStore,
                 chim: ChimeraDetector, safe_overlap: int,
                 max_jump: int, max_overhang: int,
                 max_extensions_drop_rate: float,
                 min_reads_in_disjointig: int,
                 max_inner_reads: int, max_inner_fraction: float,
                 add_unassembled_reads: bool = False):
        self.store = store
        self.ovlps = ovlp_store
        self.chim = chim
        self.safe_overlap = safe_overlap
        self.max_jump = max_jump
        self.max_overhang = max_overhang
        self.max_extensions_drop_rate = max_extensions_drop_rate
        self.min_reads_in_disjointig = min_reads_in_disjointig
        self.max_inner_reads = max_inner_reads
        self.max_inner_fraction = max_inner_fraction
        self.add_unassembled_reads = add_unassembled_reads
        self._inner: Set[int] = set()
        self.read_lists: List[ExtensionInfo] = []
        self.disjointig_paths: List[ContigPath] = []

    # ---------------- extension predicates ----------------

    def _extends_right(self, ov: Overlap) -> bool:
        return ov.right_shift() > self.max_jump

    def _extends_left(self, ov: Overlap) -> bool:
        return ov.left_shift() < -self.max_jump

    def _count_right(self, ovlps: List[Overlap]) -> int:
        return sum(1 for o in iter_no_overhang(ovlps, self.max_overhang)
                   if self._extends_right(o))

    def _count_left(self, ovlps: List[Overlap]) -> int:
        return sum(1 for o in iter_no_overhang(ovlps, self.max_overhang)
                   if self._extends_left(o))

    # ---------------- single disjointig walk ----------------

    def extend_disjointig(self, start_read: int) -> ExtensionInfo:
        """Greedy bidirectional walk (reference: extender.cpp:17-210)."""
        current_reads = {start_read, SeqId(start_read).rc}
        right_extension = True
        current = start_read
        num_extensions: List[int] = []
        overlap_sizes: List[int] = []
        info = ExtensionInfo()
        info.reads.append(start_read)
        info.assembled_length = self.store.length(start_read)

        start_ovlps = self.ovlps.lazy_overlaps(start_read)
        left_extend_ids = {
            o.ext_id for o in iter_no_overhang(start_ovlps, self.max_overhang)
            if self._extends_left(o)}

        while True:
            cur_ovlps = self.ovlps.lazy_overlaps(current)
            extensions = [o for o in iter_no_overhang(cur_ovlps,
                                                      self.max_overhang)
                          if self._extends_right(o)]
            num_extensions.append(len(extensions))
            extensions.sort(key=lambda o: -o.cur_range)

            min_ext = round(float(np.median(num_extensions)) /
                            self.max_extensions_drop_rate)
            min_ext = min(10, max(1, min_ext))

            best_preferred = None
            best_suspicious = None
            best_dead_end = None
            for ov in extensions:
                if ov.ext_id in left_extend_ids:
                    continue
                if ov.ext_len < self.safe_overlap:
                    continue
                if ov.min_range < self.safe_overlap:
                    cur_rep = self.chim.is_repetitive_region(
                        ov.cur_id, ov.cur_begin, ov.cur_end)
                    ext_rep = self.chim.is_repetitive_region(
                        ov.ext_id, ov.ext_begin, ov.ext_end)
                    if cur_rep and ext_rep:
                        continue
                ext_ovlps = self.ovlps.lazy_overlaps(ov.ext_id)
                if (not self.chim.is_chimeric(ov.ext_id, ext_ovlps) and
                        self._count_right(ext_ovlps) >= min_ext and
                        ov.min_range > self.safe_overlap):
                    best_preferred = ov
                    break
                if self._count_right(ext_ovlps) > 0:
                    if best_suspicious is None:
                        best_suspicious = ov
                    if ov.min_range < self.safe_overlap:
                        break
                else:
                    if (best_dead_end is None or
                            best_dead_end.right_shift() < ov.right_shift()):
                        best_dead_end = ov

            selected = best_preferred or best_suspicious or best_dead_end
            if selected is not None and selected is not best_preferred:
                info.num_suspicious += 1

            if selected is not None:
                info.assembled_length += selected.right_shift()
                current = selected.ext_id
                if selected.min_range < self.safe_overlap:
                    info.short_extensions += 1
                info.reads.append(current)
                overlap_sizes.append(selected.cur_range)
            else:
                if right_extension:
                    info.left_tip = True
                else:
                    info.right_tip = True

            if (selected is None or current in self._inner or
                    current in current_reads):
                if right_extension and info.reads:
                    # right side done: flip the path and continue from the
                    # rc of the original start read
                    info.steps_to_turn = len(info.reads)
                    right_extension = False
                    info.reads = [SeqId(r).rc for r in reversed(info.reads)]
                    current = info.reads[-1]
                else:
                    break

            current_reads.add(current)
            current_reads.add(SeqId(current).rc)

        if num_extensions:
            info.mean_overlaps = int(np.median(num_extensions))
        if overlap_sizes:
            info.avg_overlap_size = int(np.median(overlap_sizes))
            info.min_overlap_size = int(min(overlap_sizes))
        return info

    # ---------------- whole-read-set assembly ----------------

    def assemble_disjointigs(self) -> None:
        """(reference: extender.cpp:213-429 assembleDisjointigs)."""
        logger.info("Extending reads")
        self.chim.estimate_global_coverage()
        self._inner.clear()
        covered: Set[int] = set()

        all_reads = [sid for sid in self.store.ids()
                     if self.store.length(sid) > self.safe_overlap]
        all_reads.sort(key=_id_hash)
        total = len(all_reads)

        max_start_ext = self.chim.overlap_coverage * 10
        min_start_ext = 1

        for done, start_read in enumerate(all_reads):
            if start_read in self._inner:
                continue
            covered.add(start_read)
            covered.add(SeqId(start_read).rc)

            start_ovlps = self.ovlps.quick_overlaps(start_read,
                                                    max_overlaps=100)
            no_ovh = list(iter_no_overhang(start_ovlps, self.max_overhang))
            n_inner = sum(1 for o in no_ovh if o.ext_id in self._inner)
            ext_left = self._count_left(start_ovlps)
            ext_right = self._count_right(start_ovlps)

            if (self.chim.is_chimeric(start_read, start_ovlps) or
                    self.store.length(start_read) < self.safe_overlap or
                    max(ext_left, ext_right) > max_start_ext or
                    min(ext_left, ext_right) < min_start_ext or
                    n_inner > len(no_ovh) // 2):
                continue

            info = self.extend_disjointig(start_read)
            if (len(info.reads) - info.num_suspicious <
                    self.min_reads_in_disjointig):
                continue

            inner_count = sum(1 for r in info.reads[1:-1]
                              if r in self._inner)
            inner_threshold = min(self.max_inner_reads,
                                  int(self.max_inner_fraction *
                                      len(info.reads)))
            if inner_count > inner_threshold:
                logger.debug("Discarded disjointig with %d reads and %d "
                             "inner overlaps", len(info.reads), inner_count)
                continue

            logger.debug(
                "Assembled disjointig %d\n\tWith %d reads\n\tStart read: %s"
                "\n\tAt position: %d\n\tleftTip: %d rightTip: %d"
                "\n\tSuspicious: %d\n\tMean extensions: %d\n\tAvg overlap "
                "len: %d\n\tMin overlap len: %d\n\tInner reads: %d"
                "\n\tLength: %d",
                len(self.read_lists) + 1, len(info.reads),
                self.store.name(start_read), info.steps_to_turn,
                info.left_tip, info.right_tip, info.num_suspicious,
                info.mean_overlaps, info.avg_overlap_size,
                info.min_overlap_size, inner_count, info.assembled_length)

            all_ovlps: List[Overlap] = []
            for rid in info.reads:
                covered.add(rid)
                covered.add(SeqId(rid).rc)
                self._inner.add(rid)
                self._inner.add(SeqId(rid).rc)
                for ov in iter_no_overhang(self.ovlps.lazy_overlaps(rid),
                                           self.max_overhang):
                    if ov.min_range > self.safe_overlap:
                        all_ovlps.append(ov)
                        covered.add(ov.ext_id)
                        covered.add(SeqId(ov.ext_id).rc)
            for rid in self._get_inner_reads(all_ovlps):
                self._inner.add(rid)
                self._inner.add(SeqId(rid).rc)

            self.read_lists.append(info)

        if self.add_unassembled_reads:
            self._add_singletons()

        self._convert_to_disjointigs()
        logger.info("Assembled %d disjointigs", len(self.disjointig_paths))

    def _get_inner_reads(self, ovlps: List[Overlap]) -> List[int]:
        """Reads fully covered by the new disjointig's overlaps
        (reference: extender.cpp:432-497 getInnerReads)."""
        W = self.chim.window
        overhang = self.max_overhang
        coverage: Dict[int, np.ndarray] = {}
        for ov in ovlps:
            cov = coverage.get(ov.ext_id)
            if cov is None:
                n = max(1, self.store.length(ov.ext_id) // W)
                cov = np.zeros(n, dtype=np.int32)
                coverage[ov.ext_id] = cov
            lo = ov.ext_begin // W + 1
            hi = ov.ext_end // W  # exclusive
            if hi > lo:
                cov[lo:hi] += 1
        inner = []
        for rid, cov in coverage.items():
            nz = np.flatnonzero(cov)
            if len(nz) == 0:
                continue
            left_zeros = nz[0]
            right_zeros = len(cov) - 1 - nz[-1]
            middle_zero = (cov[nz[0]:nz[-1] + 1] == 0).any()
            if (not middle_zero and left_zeros < overhang // W and
                    right_zeros < overhang // W):
                inner.append(rid)
        return inner

    def _add_singletons(self) -> None:
        """(reference: extender.cpp:385-424, subassembly mode)."""
        candidates = [sid for sid in self.store.ids()
                      if sid not in self._inner and
                      self.store.length(sid) > self.safe_overlap]
        candidates.sort(key=lambda s: -self.store.length(s))
        covered: Set[int] = set()
        added = 0
        for rid in candidates:
            if rid in covered:
                continue
            for ov in iter_no_overhang(self.ovlps.lazy_overlaps(rid),
                                       self.max_overhang):
                if ov.left_shift() >= 0 and ov.right_shift() <= 0:
                    covered.add(ov.ext_id)
                    covered.add(SeqId(ov.ext_id).rc)
            info = ExtensionInfo(singleton=True, reads=[rid])
            self.read_lists.append(info)
            added += 1
        logger.info("Added %d singleton reads", added)

    def _convert_to_disjointigs(self) -> None:
        """Attach consecutive-read overlaps to each read list
        (reference: extender.cpp:499-551)."""
        for info in self.read_lists:
            name = ("disjointig_" if not info.singleton else "read_") + \
                str(len(self.disjointig_paths) + 1)
            path = ContigPath(name=name, reads=list(info.reads))
            ok = True
            for a, b in zip(info.reads[:-1], info.reads[1:]):
                found = None
                for ov in self.ovlps.lazy_overlaps(a):
                    if ov.ext_id == b:
                        found = ov
                        break
                for ov in self.ovlps.lazy_overlaps(b):
                    if ov.ext_id == a:
                        if found is None or found.min_range < ov.min_range:
                            found = ov.reverse()
                        break
                if found is None:
                    logger.warning("Missing overlap in disjointig path")
                    ok = False
                    break
                path.overlaps.append(found)
            if ok:
                self.disjointig_paths.append(path)
