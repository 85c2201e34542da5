"""Chimeric-read detection via window coverage drops.

Behavioral port of ChimeraDetector (reference: src/assemble/chimera.cpp):
sampled median overlap coverage, per-read window coverage with a
drop-rate threshold, and the repetitive-region test comparing complete
vs incomplete (junction) alignments.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np

from flye_jax.io.seqstore import SeqId
from flye_jax.overlap.engine import OverlapStore
from flye_jax.overlap.structs import Overlap

logger = logging.getLogger("flye_jax")


def iter_no_overhang(ovlps: List[Overlap], max_overhang: int):
    """Only overlaps with small left/right overhang
    (reference: src/sequence/overlap.h:455-527 IterNoOverhang)."""
    return (o for o in ovlps if o.lr_overhang() <= max_overhang)


class ChimeraDetector:
    def __init__(self, store, ovlp_store: OverlapStore, window: int,
                 max_overhang: int, max_drop_rate: float,
                 uneven_coverage: bool = False):
        self.store = store
        self.ovlps = ovlp_store
        self.window = window
        self.max_overhang = max_overhang
        self.max_drop_rate = max_drop_rate
        self.uneven_coverage = uneven_coverage
        self.overlap_coverage = 0
        self._chimeras: Dict[int, bool] = {}
        self._local_cov: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _read_coverage(self, sid: int, ovlps: List[Overlap]) -> np.ndarray:
        """Window coverage skipping one flank window on each side
        (reference: chimera.cpp:106-134 getReadCoverage)."""
        W = self.window
        flank = 1
        n_windows = int(np.ceil(self.store.length(sid) / W)) + 1
        size = n_windows - 2 * flank
        if size <= 0:
            return np.zeros(1, dtype=np.int32)
        cov = np.zeros(size, dtype=np.int32)
        for ov in iter_no_overhang(ovlps, self.max_overhang):
            if ov.ext_id == ov.cur_id or ov.ext_id == SeqId(ov.cur_id).rc:
                continue
            lo = ov.cur_begin // W + flank
            hi = ov.cur_end // W - flank
            if hi >= lo:
                cov[max(0, lo - flank):hi - flank + 1] += 1
        return cov

    def estimate_global_coverage(self, max_samples: int = 1000,
                                 seed: int = 42) -> None:
        """Median window coverage over sampled reads
        (reference: chimera.cpp:55-104)."""
        rng = np.random.default_rng(seed)
        ids = self.store.ids()
        n = min(max_samples, len(ids))
        sample = rng.choice(len(ids), size=n, replace=False)
        all_cov = []
        for i in sample:
            sid = ids[int(i)]
            cov = self._read_coverage(sid, self.ovlps.lazy_overlaps(sid))
            if (cov != 0).any():
                all_cov.append(cov)
        if not all_cov:
            logger.warning("No overlaps found!")
            self.overlap_coverage = 0
        else:
            self.overlap_coverage = int(np.median(np.concatenate(all_cov)))
        logger.info("Overlap-based coverage: %d", self.overlap_coverage)

    def is_chimeric(self, sid: int, ovlps: List[Overlap]) -> bool:
        if sid not in self._chimeras:
            result = self._test_by_coverage(sid, ovlps)
            self._chimeras[sid] = result
            self._chimeras[SeqId(sid).rc] = result
        return self._chimeras[sid]

    def _test_by_coverage(self, sid: int, ovlps: List[Overlap]) -> bool:
        """Coverage-drop chimera test (reference: chimera.cpp:137-205)."""
        cov = self._read_coverage(sid, ovlps)
        if len(cov) == 0:
            return False
        if cov.sum() == 0:
            return True
        if not self.uneven_coverage:
            threshold = max(1, round(self.overlap_coverage /
                                     self.max_drop_rate))
        else:
            threshold = max(1, round(int(np.median(cov)) /
                                     self.max_drop_rate))
        max_flank = self.max_overhang // self.window
        good = cov[max_flank:len(cov) - max_flank]
        if len(good) == 0:
            return True
        return bool((good < threshold).any())

    def _cached_local_coverage(self, sid: int):
        """Complete vs incomplete alignment window counts from local
        (force_local) overlaps (reference: chimera.cpp:281-330)."""
        if sid in self._local_cov:
            return self._local_cov[sid]
        W = self.window
        flank = 1
        n_windows = int(np.ceil(self.store.length(sid) / W)) + 1
        size = max(1, n_windows - 2 * flank)
        cov = np.zeros(size, dtype=np.int32)
        junc = np.zeros(size, dtype=np.int32)
        ovlps = self.ovlps.quick_overlaps(sid, force_local=True)
        for ov in ovlps:
            if ov.ext_id == ov.cur_id or ov.ext_id == SeqId(ov.cur_id).rc:
                continue
            lo = ov.cur_begin // W + flank
            hi = ov.cur_end // W - flank
            if hi < lo:
                continue
            target = junc if ov.lr_overhang() > self.max_overhang else cov
            target[max(0, lo - flank):hi - flank + 1] += 1
        self._local_cov[sid] = (cov, junc)
        self._local_cov[SeqId(sid).rc] = (cov[::-1], junc[::-1])
        return self._local_cov[sid]

    def is_repetitive_region(self, sid: int, start: int, end: int) -> bool:
        """True if most windows in [start, end) look like repeat junctions
        (reference: chimera.cpp:207-278)."""
        hang_end_rate = 0.75
        repeat_window_rate = 0.75
        cov, junc = self._cached_local_coverage(sid)
        lo = max(0, start // self.window)
        hi = min(len(cov), end // self.window)
        if hi <= lo:
            return False
        window_cov = cov[lo:hi]
        window_junc = junc[lo:hi]
        suspicious = (hang_end_rate * window_cov <= window_junc)
        return bool(suspicious.mean() > repeat_window_rate)
