"""Overlap detection engine: index probe -> chain -> score -> filter.

Behavioral port of OverlapDetector/OverlapContainer
(reference: src/sequence/overlap.{h,cpp}) restructured around batched
device kernels:

- index lookups and the chaining DP run as batched device kernels
  (ops.kmers / KmerIndex.lookup / ops.chain.chain_dp);
- match gathering, per-target grouping, backtracking, and overlap tests
  are vectorized host NumPy;
- base-level divergence goes through the anchored segment batcher
  (ops.align) instead of edlib.

One engine serves every consumer like the reference's constructor flags
(reference: src/sequence/overlap.h:314-335): all-vs-all reads
(only_max_ext), ava-disjointigs with kept alignments + bad-mapping
partitioning (repeat graph), reads->edges and reads->contigs mapping.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flye_jax.index.kmer_index import KmerIndex
from flye_jax.io.seqstore import SeqId, SequenceStore
from flye_jax.ops.align import SegmentBatcher, anchored_divergence
from flye_jax.ops.chain import backtrack_chains, chain_dp
from flye_jax.overlap.structs import Overlap
from flye_jax.utils.ds import DisjointSet

logger = logging.getLogger("flye_jax")

# per-phase wall-clock accumulators for the ava hot loop (the reference
# keeps the same thread-local timer discipline,
# reference: overlap.cpp:128-158); read with phase_times(), reset with
# reset_phase_times() — bench.py prints them to attribute the wall
from collections import defaultdict as _dd
from time import perf_counter as _pc

_PHASE: Dict[str, float] = _dd(float)

# the prefetch thread pipeline may issue device calls from two threads;
# all device dispatch/fetch sections take this lock so the two batches'
# device work never interleaves (host prep/finish still overlaps: the
# lock holder releases the GIL while it waits on the device, and native
# C++ sections release it explicitly)
import threading as _threading

_DEVICE_LOCK = _threading.Lock()


def phase_times() -> Dict[str, float]:
    return dict(_PHASE)


def reset_phase_times() -> None:
    _PHASE.clear()


class _phase:
    __slots__ = ("name", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = _pc()

    def __exit__(self, *a):
        _PHASE[self.name] += _pc() - self.t0


# fraction of min_overlap that must be covered by unique k-mer matches
# for a target to be considered (reference: overlap.cpp:110-111)
_MIN_KMER_SURVIVAL_RATE = 0.01
# match-count buckets for the chaining DP batches
_CHAIN_BUCKETS = (64, 256, 1024, 4096, 16384)
_LOOKBACK = 1024


class OverlapEngine:
    """Finds overlaps of query sequences against an indexed target set."""

    # matches per posting-expansion chunk (memory bound; see
    # _collect_matches_batch)
    gather_cap = 64 << 20

    def __init__(
        self,
        target_store: SequenceStore,
        index: KmerIndex,
        max_jump: int,
        min_overlap: int,
        max_overhang: int,
        keep_alignment: bool = False,
        only_max_ext: bool = False,
        max_divergence: float = 1.0,
        nucl_alignment: bool = False,
        partition_bad_mappings: bool = False,
        use_hpc: bool = False,
        max_cur_overlaps: int = 0,
        thin_anchors: bool = True,
    ):
        self.targets = target_store
        self.index = index
        self.k = index.k
        self.max_jump = max_jump
        self.min_overlap = min_overlap
        self.max_overhang = max_overhang
        self.check_overhang = max_overhang > 0
        self.keep_alignment = keep_alignment
        self.only_max_ext = only_max_ext
        self.max_divergence = max_divergence
        self.nucl_alignment = nucl_alignment
        self.partition_bad_mappings = partition_bad_mappings
        self.use_hpc = use_hpc
        self.max_cur_overlaps = max_cur_overlaps
        # groups with at most this many matches chain on the host
        # (threaded native full-window DP, bit-identical to the device
        # kernel's bounded window because host_dp_max <= lookback);
        # wider groups run the device DP (ops/chain.py).  See
        # _batch_fast.
        self.host_dp_max = min(1024, _LOOKBACK)
        # index probe path: "host" (native), "device", or "auto"
        # (measure both on the first real batch and latch the winner).
        # FLYE_JAX_PROBE overrides the "host" default.
        self._probe_path: Optional[str] = None
        # mapping mode keeps every chain anchor (needed for window
        # partitioning); assembly thins to >k spacing like the
        # reference's kept-alignment trace
        self.thin_anchors = thin_anchors
        self._target_lengths = target_store.lengths
        # divergence stats windows (reference: overlap.cpp:210-211)
        self.div_stats: List[float] = []

    # ------------------------------------------------------------------

    def _collect_matches_batch(self, query_store: SequenceStore,
                               sids: Sequence[int],
                               symmetric: bool = True):
        """Probe the index with every k-mer of a batch of query strands
        in one flat-stream device pass, then gather postings for the
        whole batch at once. Yields per-sid match tuples."""
        sids = list(sids)
        lengths = [query_store.length(s) for s in sids]
        with _phase("probe"), _DEVICE_LOCK:
            g_hit, row_hit, fwd_hit, g_rep, starts, _ = (
                self.index.probe_stream_flat(query_store, sids))

        # posting-list gather across all hits of the batch; expanded in
        # bounded chunks so a pathological batch (ultra-frequent k-mers
        # at high coverage) can't materialize tens of GB at once
        # (round-1 review: unbounded gather was the first thing to fall
        # over at 100 Mb scale)
        cnt = self.index.counts[row_hit].astype(np.int64)
        pstart = self.index.offsets[row_hit]
        total = int(cnt.sum())
        _g = _phase("gather")
        _g.__enter__()
        if total:
            if total > self.gather_cap:
                cum = np.cumsum(cnt)
                cuts = [0]
                while cuts[-1] < len(cnt):
                    nxt = int(np.searchsorted(
                        cum, (cum[cuts[-1] - 1] if cuts[-1] else 0)
                        + self.gather_cap))
                    cuts.append(max(nxt, cuts[-1] + 1))
                pieces = [self._expand_postings(
                    row_hit[a:b], cnt[a:b], pstart[a:b], a)
                    for a, b in zip(cuts[:-1], cuts[1:])]
                reps = np.concatenate([p[0] for p in pieces])
                flat = np.concatenate([p[1] for p in pieces])
            else:
                reps, flat = self._expand_postings(row_hit, cnt, pstart,
                                                   0)
            t_seq = self.index.post_seq[flat].astype(np.int64)
            t_pos = self.index.post_pos[flat].astype(np.int64)
            t_flip = self.index.post_flip[flat]
            mg = g_hit[reps]                  # stream coord per match
            m_qfwd = fwd_hit[reps]
            qi_m = np.searchsorted(starts, mg, side="right") - 1
            m_qpos = (mg - starts[qi_m]).astype(np.int32)

            same = m_qfwd ^ t_flip            # same-strand match?
            tlen = self._target_lengths[t_seq]
            ext_id = 2 * t_seq + (~same).astype(np.int64)
            ext_pos = np.where(same, t_pos,
                               tlen - self.k - t_pos).astype(np.int32)
            # drop trivial self-matches (reference: overlap.cpp:190-192)
            # — only in symmetric (ava) mode: in mapping mode query and
            # target ids come from different stores, so equal numbers
            # are unrelated sequences (the reference's ids are globally
            # unique across containers, sequence_container.h:29-33)
            if symmetric:
                sid_m = np.asarray(sids, dtype=np.int64)[qi_m]
                keep = ~((ext_id == sid_m) & (ext_pos == m_qpos))
                m_qpos, ext_id, ext_pos, qi_m = (
                    m_qpos[keep], ext_id[keep], ext_pos[keep], qi_m[keep])
            # per-query split points (qi_m is non-decreasing: hits come
            # in stream order and postings expand in place)
            bounds = np.searchsorted(qi_m, np.arange(len(sids) + 1))
        rep_qi = np.searchsorted(starts, g_rep, side="right") - 1
        rep_bounds = np.searchsorted(rep_qi, np.arange(len(sids) + 1))
        _g.__exit__()

        out = []
        for qi, sid in enumerate(sids):
            filtered_pos = (g_rep[rep_bounds[qi]:rep_bounds[qi + 1]]
                            - starts[qi]).astype(np.int64)
            if total:
                s, e = bounds[qi], bounds[qi + 1]
                out.append((sid, m_qpos[s:e], ext_id[s:e], ext_pos[s:e],
                            filtered_pos, lengths[qi]))
            else:
                z = np.zeros(0, dtype=np.int64)
                out.append((sid, z.astype(np.int32), z,
                            z.astype(np.int32), filtered_pos, lengths[qi]))
        return out

    # ------------------------------------------------------------------

    @staticmethod
    def _expand_postings(rows, cnt, pstart, row_base):
        """(hit-index repeats, flat posting indices) for one chunk."""
        total = int(cnt.sum())
        reps = np.repeat(np.arange(row_base, row_base + len(rows)), cnt)
        base = np.repeat(pstart, cnt)
        offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        return reps, base + offs

    def get_overlaps(self, query_store: SequenceStore, sid: int,
                     force_local: bool = False,
                     max_overlaps: int = 0) -> List[Overlap]:
        """All overlaps of one query strand (reference:
        overlap.cpp:99-508 getSeqOverlaps)."""
        return self.get_overlaps_batch(query_store, [sid], force_local,
                                       max_overlaps)[sid]

    def get_overlaps_batch(self, query_store: SequenceStore,
                           sids: Sequence[int], force_local: bool = False,
                           max_overlaps: int = 0
                           ) -> Dict[int, List[Overlap]]:
        """Overlaps for a batch of query strands: one k-mer extraction +
        index lookup pass and one chaining-DP bucket set for the whole
        batch (cross-read batching keeps the device busy; the reference
        parallelizes the same loop over threads,
        reference: overlap.cpp:630-668)."""
        symmetric = query_store is self.targets
        from flye_jax import native
        mod = native.get()
        if mod is not None:
            return self._batch_fast(mod, query_store, list(sids),
                                    force_local, max_overlaps, symmetric)

        per_sid = self._collect_matches_batch(query_store, sids,
                                              symmetric)
        # ---- pure-Python fallback (native module unavailable) ----
        # collect chain groups across all queries; the per-(read, ext)
        # filters run vectorized over ALL groups of a read at once
        # (reduceat segment reductions) — the per-group Python loop
        # dominated the ava phase's host time at 50x coverage, where
        # most groups fail the survival/span filters anyway
        min_surv = _MIN_KMER_SURVIVAL_RATE * self.min_overlap
        groups = []       # (qi, eid, elen, gcur, gext, stride)
        query_meta = []   # (sid, cur_len, filtered_pos)
        for qi, (sid, qpos, ext_id, ext_pos, filtered_pos, cur_len) in                 enumerate(per_sid):
            query_meta.append((sid, cur_len, filtered_pos))
            if len(qpos) == 0:
                continue
            order = np.lexsort((qpos, ext_id))
            qpos, ext_id, ext_pos = (qpos[order], ext_id[order],
                                     ext_pos[order])
            new_grp = np.empty(len(ext_id), bool)
            new_grp[0] = True
            np.not_equal(ext_id[1:], ext_id[:-1], out=new_grp[1:])
            starts_g = np.flatnonzero(new_grp)
            ends_g = np.append(starts_g[1:], len(ext_id))
            # unique qpos per group: a position counts when it differs
            # from its predecessor (group starts always count)
            chg = new_grp.copy()
            chg[1:] |= qpos[1:] != qpos[:-1]
            uniq = np.add.reduceat(chg, starts_g)
            eids = ext_id[starts_g]
            elens = self._target_lengths[eids >> 1]
            min_cur = qpos[starts_g]
            max_cur = qpos[ends_g - 1]
            min_ext = np.minimum.reduceat(ext_pos, starts_g)
            max_ext = np.maximum.reduceat(ext_pos, starts_g)
            keep = ((uniq >= min_surv)
                    & (max_cur - min_cur >= self.min_overlap)
                    & (max_ext - min_ext >= self.min_overlap))
            if self.check_overhang and not force_local:
                keep &= ~(np.minimum(min_cur, min_ext)
                          > self.max_overhang)
                keep &= ~(np.minimum(cur_len - max_cur,
                                     elens - max_ext)
                          > self.max_overhang)
            emitted = 0
            for gi in np.flatnonzero(keep):
                # maxCurOverlaps economy: stop collecting groups once
                # enough survive (reference: overlap.cpp:218-219)
                if max_overlaps and emitted >= max_overlaps:
                    break
                emitted += 1
                s, e = starts_g[gi], ends_g[gi]
                gcur, gext = qpos[s:e], ext_pos[s:e]
                eid = int(eids[gi])
                elen = int(elens[gi])
                if elen > cur_len:
                    o = np.argsort(gext, kind="stable")
                    gcur, gext = gcur[o], gext[o]
                # groups beyond the largest DP bucket are stride-
                # subsampled (not truncated): chains must still span the
                # whole sequence; the divergence estimate compensates by
                # the stride factor
                stride = 1
                if len(gcur) > _CHAIN_BUCKETS[-1]:
                    stride = -(-len(gcur) // _CHAIN_BUCKETS[-1])
                    gcur, gext = gcur[::stride], gext[::stride]
                groups.append((qi, eid, elen, gcur, gext, stride))

        chain_results = self._run_chain_dp(
            [(eid, elen, gcur, gext)
             for _, eid, elen, gcur, gext, _ in groups]) if groups else []

        # finish per query, sharing one divergence batcher
        results: Dict[int, List[Overlap]] = {sid: [] for sid, _, _ in
                                             query_meta}
        div_windows: Dict[int, Dict[int, Overlap]] = {}
        seg_batcher = SegmentBatcher() if self.nucl_alignment else None
        pending = []  # (sid, overlap, finish_fn)
        for (qi, eid, elen, gcur, gext, stride), (score, parent) in zip(
                groups, chain_results):
            sid, cur_len, filtered_pos = query_meta[qi]
            detected = results[sid]
            if max_overlaps and len(detected) >= max_overlaps:
                continue
            ext_ovlps = self._extract_overlaps(
                sid, cur_len, eid, elen, gcur, gext, score, parent,
                filtered_pos, force_local, stride, symmetric)
            if not ext_ovlps:
                continue
            ext_ovlps.sort(key=lambda o: -o.score)
            if self.only_max_ext:
                primary = [ext_ovlps[0]]
            else:
                primary = []
                for ov in ext_ovlps:
                    if not any(ov.contained_by(p) and p.score > ov.score
                               for p in primary):
                        primary.append(ov)
            for ov in primary:
                if self.nucl_alignment:
                    cur_codes = query_store.get(sid)
                    ext_codes = self.targets.get(ov.ext_id)
                    anchors = self._anchors_for(ov)
                    finish = anchored_divergence(
                        cur_codes, ext_codes, anchors, self.k,
                        use_hpc=self.use_hpc, batcher=seg_batcher)
                    pending.append((sid, ov, finish))
                else:
                    self._keep_or_trim(ov, None, detected,
                                       div_windows.setdefault(sid, {}))

        if pending:
            dists = seg_batcher.run()
            for sid, ov, finish in pending:
                div, per_seg, spans = finish(dists)
                ov.divergence = div
                self._keep_or_trim(ov, (per_seg, spans), results[sid],
                                   div_windows.setdefault(sid, {}))

        for sid_windows in div_windows.values():
            for ov in sid_windows.values():
                self.div_stats.append(ov.divergence)
        return results

    # ------------------------------------------------------------------

    def _probe_choice(self) -> str:
        """Resolve the probe path for this batch: a latched choice, the
        FLYE_JAX_PROBE env override (host|device|auto), or the default
        'host' (the device probe is gather-bound; chip_smoke.py times
        both on the card).  'auto' measures both paths once (see
        _batch_fast)."""
        if self._probe_path is not None:
            return self._probe_path
        import os
        env = os.environ.get("FLYE_JAX_PROBE", "").lower()
        if env in ("host", "device"):
            self._probe_path = env
            return env
        if env == "auto":
            return "measure"
        self._probe_path = "host"
        return "host"

    def _batch_fast(self, mod, query_store, sids, force_local,
                    max_overlaps, symmetric):
        """Native-assisted batch path: the device probes the index
        over the flat query stream; posting expansion, group
        segmentation / survival filters, small-group chain DP, and the
        backtrack + overlap tests + anchor thinning + divergence all
        run in C++ threads (native collect_matches / chain_group_prep /
        chain_dp_host / finish_overlaps); only wide groups' DP rides
        the device.  Byte-identical to the pure-Python path
        (tests/test_overlap_native.py); replaces the numpy/Python loops
        that dominated the ava phase's host wall
        (reference analog: src/sequence/overlap.cpp:99-427, whose
        inner loops are C++ for the same reason)."""
        nq = len(sids)
        if nq == 0:
            return {}
        streams = self._match_streams(mod, query_store, sids, symmetric)
        return self._finish_from_matches(mod, query_store, sids,
                                         streams, force_local,
                                         max_overlaps, symmetric)

    def _match_streams(self, mod, query_store, sids, symmetric):
        """Probe + posting gather for a batch of query strands; returns
        the per-query match streams
        (qpos, extid, extpos, qbounds, filt, foff) — everything the
        chain/finish half needs, in exchange-friendly array form.  In
        the hash-partitioned multi-process mode each shard owner runs
        this against its LOCAL index partition and ships the streams to
        the read owner (parallel/partitioned.py): every query position
        carries exactly one k-mer, which lives in exactly one shard, so
        a stable merge by position reproduces this function's stream
        byte-for-byte."""
        nq = len(sids)
        lengths = [query_store.length(s) for s in sids]
        probe_res = None
        with _phase("probe"):
            choice = self._probe_choice()
            if choice == "measure":
                # self-tuning: time BOTH paths on this first real batch
                # and latch the winner for the run (the split depends
                # on the host's cores and the device).  Outputs are
                # byte-identical
                # (tests/test_overlap_native.py), so either result is
                # usable and determinism is unaffected.
                import time as _time
                t0 = _time.perf_counter()
                host_res = self.index.probe_stream_host(query_store,
                                                        sids)
                t_host = _time.perf_counter() - t0
                if host_res is None:
                    self._probe_path = "device"
                else:
                    with _DEVICE_LOCK:
                        # warm (compile) then measure one device pass
                        self.index.probe_stream_flat(query_store, sids)
                        t0 = _time.perf_counter()
                        self.index.probe_stream_flat(query_store, sids)
                        t_dev = _time.perf_counter() - t0
                    self._probe_path = ("host" if t_host <= t_dev
                                        else "device")
                    logger.info(
                        "probe path auto-tune: host %.2fs vs device "
                        "%.2fs per batch -> %s", t_host, t_dev,
                        self._probe_path)
                    if self._probe_path == "host":
                        probe_res = host_res
                choice = self._probe_path
            elif choice == "host":
                probe_res = self.index.probe_stream_host(query_store,
                                                         sids)
        if probe_res is None:  # device-preferred or sharded (mesh) index
            with _phase("probe"), _DEVICE_LOCK:
                probe_res = self.index.probe_stream_flat(query_store,
                                                         sids)
        g_hit, row_hit, fwd_hit, g_rep, starts, _ = probe_res
        # per-query filtered (repetitive-kmer) positions: g_rep is
        # ascending in stream order, so per-query slices stay sorted
        rep_qi = np.searchsorted(starts, g_rep, side="right") - 1
        filt = np.ascontiguousarray(
            (g_rep - starts[rep_qi]), dtype=np.int64)
        foff = np.searchsorted(rep_qi, np.arange(nq + 1)).astype(
            np.int64)
        tlens = np.ascontiguousarray(self._target_lengths,
                                     dtype=np.int64)
        with _phase("gather"):
            qpos_b, extid_b, extpos_b, qb_b = mod.collect_matches(
                np.ascontiguousarray(g_hit, dtype=np.int64),
                np.ascontiguousarray(row_hit, dtype=np.int64),
                np.ascontiguousarray(fwd_hit).view(np.uint8),
                np.ascontiguousarray(self.index.counts,
                                     dtype=np.int32),
                np.ascontiguousarray(self.index.offsets,
                                     dtype=np.int64),
                np.ascontiguousarray(self.index.post_seq,
                                     dtype=np.int32),
                np.ascontiguousarray(self.index.post_pos,
                                     dtype=np.int32),
                np.ascontiguousarray(self.index.post_flip).view(
                    np.uint8),
                tlens, np.ascontiguousarray(starts, dtype=np.int64),
                np.asarray(sids, dtype=np.int64),
                len(g_hit), nq, int(self.k), int(symmetric))
        return (np.frombuffer(qpos_b, dtype=np.int32),
                np.frombuffer(extid_b, dtype=np.int64),
                np.frombuffer(extpos_b, dtype=np.int32),
                np.frombuffer(qb_b, dtype=np.int64),
                filt, foff)

    def _finish_from_matches(self, mod, query_store, sids, streams,
                             force_local, max_overlaps, symmetric):
        """Chain + extract + divergence from match streams (the second
        half of the native batch path; see _match_streams)."""
        nq = len(sids)
        results: Dict[int, List[Overlap]] = {sid: [] for sid in sids}
        lengths = [query_store.length(s) for s in sids]
        query_meta = list(zip(sids, lengths))
        curlens = np.asarray(lengths, dtype=np.int32)
        tlens = np.ascontiguousarray(self._target_lengths,
                                     dtype=np.int64)
        qpos_m, extid_m, extpos_m, qb_m, filt, foff = streams
        qpos_b = np.ascontiguousarray(qpos_m, dtype=np.int32)
        extid_b = np.ascontiguousarray(extid_m, dtype=np.int64)
        extpos_b = np.ascontiguousarray(extpos_m, dtype=np.int32)
        qb_b = np.ascontiguousarray(qb_m, dtype=np.int64)
        filt = np.ascontiguousarray(filt, dtype=np.int64)
        foff = np.ascontiguousarray(foff, dtype=np.int64)
        min_surv = _MIN_KMER_SURVIVAL_RATE * self.min_overlap
        with _phase("prep"):
            (qi_b, eid_b, elen_b, stride_b, goff_b, gcur_b, gext_b) = \
                mod.chain_group_prep(
                    qpos_b, extid_b, extpos_b,
                    qb_b, curlens, tlens, nq, float(min_surv),
                    int(self.min_overlap), int(self.max_overhang),
                    int(self.check_overhang and not force_local),
                    int(_CHAIN_BUCKETS[-1]), int(max_overlaps))
        g_qi = np.frombuffer(qi_b, dtype=np.int32)
        g_eid = np.frombuffer(eid_b, dtype=np.int64)
        g_elen = np.frombuffer(elen_b, dtype=np.int32)
        g_stride = np.frombuffer(stride_b, dtype=np.int32)
        goff = np.frombuffer(goff_b, dtype=np.int64)
        gcur = np.frombuffer(gcur_b, dtype=np.int32)
        gext = np.frombuffer(gext_b, dtype=np.int32)
        G = len(g_qi)
        if G == 0:
            return results
        glens = np.diff(goff)

        g_cid = np.asarray(sids, dtype=np.int64)[g_qi]
        g_clen = curlens[g_qi].astype(np.int32)

        flags = (1 * (self.check_overhang and not force_local)
                 | 2 * bool(force_local)
                 | 4 * bool(symmetric)
                 | 8 * bool(self.only_max_ext)
                 | 16 * bool(self.thin_anchors))

        # overlaps per group.  Small groups (the vast majority) run
        # their full-window chain DP in threaded native code: a tiny DP
        # is dominated by the device dispatch and transfer, and cheap
        # on the host.  Groups wider than host_dp_max keep the device
        # DP, where the long walk earns the transfer.  For groups
        # <= the device lookback window the two are bit-identical
        # (full window == bounded window); host_dp_max must not exceed
        # the engine lookback for that to hold.
        per_group: List[Optional[tuple]] = [None] * G

        def finish_rows(gids_arr, score_flat, parent_flat, scoff, W):
            with _phase("finish"):
                (row_of_b, coords_b, score_b, div_b, aoff_b,
                 anchors_b) = mod.finish_overlaps(
                    score_flat, parent_flat, scoff, len(gids_arr),
                    int(W), gcur, gext,
                    np.ascontiguousarray(goff[gids_arr]),
                    np.ascontiguousarray(glens[gids_arr]),
                    np.ascontiguousarray(g_eid[gids_arr]),
                    np.ascontiguousarray(g_elen[gids_arr]),
                    np.ascontiguousarray(g_stride[gids_arr]),
                    np.ascontiguousarray(g_qi[gids_arr]),
                    np.ascontiguousarray(g_cid[gids_arr]),
                    np.ascontiguousarray(g_clen[gids_arr]),
                    filt, foff, int(self.k), int(self.min_overlap),
                    int(self.max_overhang), int(flags),
                    float(self.index.sample_rate))
            row_of = np.frombuffer(row_of_b, dtype=np.int32)
            coords = np.frombuffer(coords_b, dtype=np.int32) \
                .reshape(-1, 4)
            vscore = np.frombuffer(score_b, dtype=np.int64)
            vdiv = np.frombuffer(div_b, dtype=np.float64)
            aoff = np.frombuffer(aoff_b, dtype=np.int64)
            # int32 anchors: at 50x coverage the anchor traces are
            # the cache's dominant per-overlap memory
            anchors = np.frombuffer(anchors_b, dtype=np.int32) \
                .reshape(-1, 2)
            # split per row (row_of ascending)
            starts_r = np.searchsorted(row_of,
                                       np.arange(len(gids_arr) + 1))
            for r, gi in enumerate(gids_arr):
                s, e = starts_r[r], starts_r[r + 1]
                if s < e:
                    per_group[gi] = (coords[s:e], vscore[s:e],
                                     vdiv[s:e],
                                     [anchors[aoff[v]:aoff[v + 1]]
                                      for v in range(s, e)])

        host_gids = np.flatnonzero(glens <= self.host_dp_max)
        dev_gids = np.flatnonzero(glens > self.host_dp_max)
        if len(host_gids):
            with _phase("dp_host"):
                scoff_b, hs_b, hp_b = mod.chain_dp_host(
                    gcur, gext, np.ascontiguousarray(goff[host_gids]),
                    np.ascontiguousarray(glens[host_gids]),
                    len(host_gids), int(self.k), int(self.max_jump))
            # scoff_b has n+1 entries (prefix sums); the finisher only
            # reads the first n
            finish_rows(host_gids, hs_b, hp_b, scoff_b,
                        max(int(self.host_dp_max), 1))
        for gids, W, score_mat, parent_mat in self._run_chain_dp_buckets(
                goff, glens, gcur, gext, dev_gids):
            gids_arr = np.asarray(gids, dtype=np.int64)
            nrows = len(gids)
            scoff = (np.arange(nrows, dtype=np.int64) * W)
            finish_rows(gids_arr,
                        np.ascontiguousarray(score_mat),
                        np.ascontiguousarray(parent_mat),
                        scoff, int(W))

        # assemble Overlap objects in original group order (determinism
        # + the max_overlaps economy both depend on this order)
        div_windows: Dict[int, Dict[int, Overlap]] = {}
        seg_batcher = SegmentBatcher() if self.nucl_alignment else None
        pending = []
        for gi in range(G):
            entry = per_group[gi]
            if entry is None:
                continue
            qi = int(g_qi[gi])
            sid, cur_len = query_meta[qi]
            detected = results[sid]
            if max_overlaps and len(detected) >= max_overlaps:
                continue
            coords, vscore, vdiv, anchor_list = entry
            eid = int(g_eid[gi])
            elen = int(g_elen[gi])
            for v in range(len(vscore)):
                ov = Overlap(sid, eid, int(coords[v, 0]),
                             int(coords[v, 1]), cur_len,
                             int(coords[v, 2]), int(coords[v, 3]), elen,
                             score=int(vscore[v]),
                             divergence=float(vdiv[v]))
                ov.kmer_matches = anchor_list[v]
                if self.nucl_alignment:
                    cur_codes = query_store.get(sid)
                    ext_codes = self.targets.get(ov.ext_id)
                    finish = anchored_divergence(
                        cur_codes, ext_codes, self._anchors_for(ov),
                        self.k, use_hpc=self.use_hpc,
                        batcher=seg_batcher)
                    pending.append((sid, ov, finish))
                else:
                    self._keep_or_trim(ov, None, detected,
                                       div_windows.setdefault(sid, {}))

        if pending:
            dists = seg_batcher.run()
            for sid, ov, finish in pending:
                div, per_seg, spans = finish(dists)
                ov.divergence = div
                self._keep_or_trim(ov, (per_seg, spans), results[sid],
                                   div_windows.setdefault(sid, {}))

        for sid_windows in div_windows.values():
            for ov in sid_windows.values():
                self.div_stats.append(ov.divergence)
        return results

    def _run_chain_dp_buckets(self, goff, glens, gcur, gext,
                              gids_subset=None):
        """Bucketed device chain DP over array-form groups; yields
        (gids, W, score_mat, parent_mat) per bucket batch."""
        by_bucket: Dict[int, List[int]] = {}
        gi_iter = (enumerate(glens) if gids_subset is None
                   else ((int(gi), glens[gi]) for gi in gids_subset))
        for gi, m in gi_iter:
            bucket = next((b for b in _CHAIN_BUCKETS if m <= b),
                          _CHAIN_BUCKETS[-1])
            by_bucket.setdefault(bucket, []).append(gi)
        if not by_bucket:
            return
        t_buckets = (8, 32, 128, 512, 2048)
        # all buckets go out in ONE fused device program
        # (ops/chain.chain_dp_multi): a single dispatch and a single
        # flattened fetch per batch, instead of one per bucket shape
        from flye_jax.parallel.runtime import get_runtime
        bucket_specs = []
        with _phase("dp"), _DEVICE_LOCK:
            for bucket in sorted(by_bucket):
                gids = by_bucket[bucket]
                T = next((t for t in t_buckets if len(gids) <= t),
                         len(gids))
                cur = np.zeros((T, bucket), dtype=np.int32)
                ext = np.zeros((T, bucket), dtype=np.int32)
                nv = np.zeros(T, dtype=np.int32)
                for r, gi in enumerate(gids):
                    s = goff[gi]
                    m = min(int(glens[gi]), bucket)
                    cur[r, :m] = gcur[s:s + m]
                    ext[r, :m] = gext[s:s + m]
                    nv[r] = m
                bucket_specs.append(
                    (gids, bucket, T,
                     get_runtime().shard_rows(cur, ext, nv)))
            from flye_jax.ops.chain import chain_dp_multi
            flat = np.asarray(chain_dp_multi(
                [arrs for _, _, _, arrs in bucket_specs],
                self.k, self.max_jump, _LOOKBACK))
        off = 0
        for gids, bucket, T, _ in bucket_specs:
            n = T * bucket
            score = flat[off:off + n].reshape(T, bucket)
            off += n
            parent = flat[off:off + n].reshape(T, bucket)
            off += n
            yield (gids, bucket, score[:len(gids)], parent[:len(gids)])

    def _run_chain_dp(self, groups):
        """Pad groups into per-bucket batches and run the device DP."""
        by_bucket: Dict[int, List[int]] = {}
        for gi, (_, _, gcur, _) in enumerate(groups):
            m = len(gcur)
            bucket = next((b for b in _CHAIN_BUCKETS if m <= b),
                          _CHAIN_BUCKETS[-1])
            by_bucket.setdefault(bucket, []).append(gi)
        results: List[Optional[tuple]] = [None] * len(groups)
        t_buckets = (8, 32, 128, 512, 2048)
        for bucket, gids in by_bucket.items():
            T = next((t for t in t_buckets if len(gids) <= t), len(gids))
            cur = np.zeros((T, bucket), dtype=np.int32)
            ext = np.zeros((T, bucket), dtype=np.int32)
            nv = np.zeros(T, dtype=np.int32)
            for r, gi in enumerate(gids):
                _, _, gcur, gext = groups[gi]
                m = min(len(gcur), bucket)
                cur[r, :m] = gcur[:m]
                ext[r, :m] = gext[:m]
                nv[r] = m
            # batch axis sharded over the runtime mesh (the data-parallel
            # analog of the reference's per-thread chaining loops)
            from flye_jax.parallel.runtime import get_runtime
            cur, ext, nv = get_runtime().shard_rows(cur, ext, nv)
            score, parent = chain_dp(cur, ext, nv, self.k, self.max_jump,
                                     lookback=min(_LOOKBACK, bucket))
            # one stacked fetch, sliced to the live rows
            import jax.numpy as jnp
            both = np.asarray(jnp.stack([score[:len(gids)],
                                         parent[:len(gids)]]))
            score, parent = both[0], both[1]
            for r, gi in enumerate(gids):
                results[gi] = (score[r], parent[r])
        return results

    def _extract_overlaps(self, cur_id, cur_len, eid, elen, gcur, gext,
                          score, parent, filtered_pos, force_local,
                          stride=1, symmetric=True):
        """Backtrack chains and apply the overlap sanity tests
        (reference: overlap.cpp:330-427 + overlapTest overlap.cpp:29-69)."""
        k = self.k
        # score/parent come from the bucketed DP: never read past their
        # width (a longer raw group would otherwise walk the native
        # backtracker off the end of the buffer)
        nvalid = min(len(gcur), len(score))
        chains = backtrack_chains(score, parent, nvalid, k)
        out = []
        for first, last, cscore, path in chains:
            ov = Overlap(cur_id, eid,
                         int(gcur[first]), int(gcur[last]) + k - 1, cur_len,
                         int(gext[first]), int(gext[last]) + k - 1, elen,
                         score=cscore)
            if not self._overlap_test(ov, force_local, symmetric):
                continue
            # sparse anchor trace (kept for projection / divergence)
            cpath = gcur[path]
            epath = gext[path]
            if self.thin_anchors:
                # thin anchors to > k spacing like the reference's
                # _keepAlignment trace (overlap.cpp:370-377)
                anchors_c = [int(cpath[0])]
                anchors_e = [int(epath[0])]
                for c, e in zip(cpath[1:], epath[1:]):
                    if c - anchors_c[-1] > k and e > anchors_e[-1]:
                        anchors_c.append(int(c))
                        anchors_e.append(int(e))
                ov.kmer_matches = np.stack(
                    [np.asarray(anchors_c), np.asarray(anchors_e)], axis=1)
            else:
                # keep all strictly-increasing anchors
                keep = np.zeros(len(cpath), dtype=bool)
                last_c, last_e = -1, -1
                for t, (c, e) in enumerate(zip(cpath, epath)):
                    if c > last_c and e > last_e:
                        keep[t] = True
                        last_c, last_e = c, e
                ov.kmer_matches = np.stack(
                    [cpath[keep], epath[keep]], axis=1).astype(np.int64)
            chain_len = len(path)
            # k-mer based divergence estimate (reference: overlap.cpp:410-423)
            n_filtered = int(np.searchsorted(filtered_pos, ov.cur_end) -
                             np.searchsorted(filtered_pos, ov.cur_begin))
            norm_len = max(ov.cur_range, ov.ext_range) - n_filtered
            match_rate = min(1.0, chain_len * stride *
                             self.index.sample_rate / max(1, norm_len))
            match_rate = max(match_rate, 1e-9)
            ov.divergence = np.log(1 / match_rate) / k
            out.append(ov)
        return out

    def _overlap_test(self, ov: Overlap, force_local: bool,
                      symmetric: bool = True) -> bool:
        if ov.cur_range < self.min_overlap or ov.ext_range < self.min_overlap:
            return False
        # overly length-divergent overlaps (reference: overlap.cpp:40-46)
        if (abs(ov.cur_range - ov.ext_range) >
                0.5 * min(ov.cur_range, ov.ext_range)):
            return False
        # the self tests only apply when query and target share a store
        # (equal ids across different stores are unrelated sequences)
        # self-intersection (reference: overlap.cpp:48-54)
        if symmetric and ov.cur_id == ov.ext_id:
            intersect = (min(ov.cur_end, ov.ext_end) -
                         max(ov.cur_begin, ov.ext_begin))
            if intersect > ov.cur_range // 2:
                return False
        # PacBio strand-skip pattern (reference: overlap.cpp:56-65)
        if symmetric and ov.cur_id == SeqId(ov.ext_id).rc:
            intersect = (min(ov.cur_end, ov.ext_len - ov.ext_begin) -
                         max(ov.cur_begin, ov.ext_len - ov.ext_end))
            if intersect > ov.cur_range // 2:
                return False
        if (not force_local and self.check_overhang and
                ov.lr_overhang() > self.max_overhang):
            return False
        return True

    def _anchors_for(self, ov: Overlap) -> np.ndarray:
        km = ov.kmer_matches
        anchors = [(ov.cur_begin, ov.ext_begin)]
        for c, e in km:
            if ov.cur_begin < c < ov.cur_end and ov.ext_begin < e < ov.ext_end:
                if c > anchors[-1][0] and e > anchors[-1][1]:
                    anchors.append((int(c), int(e)))
        anchors.append((ov.cur_end, ov.ext_end))
        return np.asarray(anchors)

    def _keep_or_trim(self, ov: Overlap, seg_info, detected, div_windows):
        stat_wnd = 10000
        if ov.divergence < self.max_divergence:
            detected.append(ov)
        elif self.partition_bad_mappings and seg_info is not None:
            detected.extend(self._trim_bad_mapping(ov, *seg_info))
        w = ov.cur_begin // stat_wnd
        prev = div_windows.get(w)
        if prev is None or ov.cur_range > prev.cur_range:
            div_windows[w] = ov

    def _trim_bad_mapping(self, ov: Overlap, per_seg: np.ndarray,
                          spans: np.ndarray) -> List[Overlap]:
        """Find sub-intervals of a too-divergent overlap that individually
        pass the divergence threshold (behavioral equivalent of
        checkIdyAndTrim, reference: src/sequence/alignment.cpp:306-430,
        reformulated over anchor segments instead of CIGAR windows)."""
        km = self._anchors_for(ov)
        n_seg = len(per_seg)
        if n_seg == 0:
            return []
        out = []
        i = 0
        thr = self.max_divergence
        while i < n_seg:
            # greedy: grow [i, j) while the running divergence stays small
            edits = 0
            cspan = 0
            espan = 0
            j = i
            best_j = i
            while j < n_seg:
                e2 = edits + per_seg[j]
                c2 = cspan + spans[j][0]
                x2 = espan + spans[j][1]
                if e2 / max(1, max(c2, x2)) <= thr:
                    edits, cspan, espan = e2, c2, x2
                    j += 1
                    best_j = j
                else:
                    break
            if best_j > i and min(cspan, espan) >= self.min_overlap:
                sub = Overlap(ov.cur_id, ov.ext_id,
                              int(km[i][0]), int(km[best_j][0]), ov.cur_len,
                              int(km[i][1]), int(km[best_j][1]), ov.ext_len,
                              score=ov.score,
                              divergence=edits / max(1, max(cspan, espan)))
                sub.kmer_matches = km[i:best_j + 1]
                out.append(sub)
            i = max(best_j, i + 1)
        return out


class OverlapStore:
    """Lazy per-read overlap cache with symmetrization and dedup filtering
    (reference: OverlapContainer, src/sequence/overlap.cpp:528-741).

    packed=True stores the cache in the columnar arena
    (overlap/packed.py, ~3-4x less RSS than Overlap-object lists) and
    materializes objects on access through a small LRU; use it for
    read-only stores (the ava store: prefetch + lazy access).  Stores
    that mutate their lists in place (ensure_transitivity /
    filter_overlaps — the repeat driver's read-vs-disjointig store)
    must keep packed=False."""

    # materialized working set: the disjointig extender walks a local
    # neighborhood of reads repeatedly; ~1k reads x ~60 overlaps of
    # objects is ~25 MB — decode cost off the hot loop, RSS bounded
    _LRU_SIZE = 1024

    def __init__(self, engine: OverlapEngine, query_store: SequenceStore,
                 packed: bool = False):
        from collections import OrderedDict

        from flye_jax.overlap.packed import PackedOverlaps
        self.engine = engine
        self.queries = query_store
        self._cache: Dict[int, Tuple[List[Overlap], List[Overlap]]] = {}
        self._packed: Optional[PackedOverlaps] = (
            PackedOverlaps() if packed else None)
        self._lru: "OrderedDict[int, List[Overlap]]" = OrderedDict()
        self.mean_true_divergence: float = 0.5

    def _cached_reads(self):
        """All fwd ids present in either representation."""
        if self._packed is None:
            return list(self._cache.keys())
        seen = set(self._cache.keys())
        out = list(self._cache.keys())
        out.extend(r for r in self._packed.reads() if r not in seen)
        return out

    def _materialize(self, sid: int) -> List[Overlap]:
        """Packed-store access with an LRU of materialized lists."""
        lst = self._lru.get(sid)
        if lst is not None:
            self._lru.move_to_end(sid)
            return lst
        fwd_id = sid & ~1
        fwd = self._packed.get(fwd_id)
        lst = fwd if sid % 2 == 0 else [o.complement() for o in fwd]
        self._lru[sid] = lst
        if len(self._lru) > self._LRU_SIZE:
            self._lru.popitem(last=False)
        return lst

    def quick_overlaps(self, sid: int, max_overlaps: int = 0,
                       force_local: bool = False) -> List[Overlap]:
        return self.engine.get_overlaps(self.queries, sid,
                                        force_local=force_local,
                                        max_overlaps=max_overlaps)

    def lazy_overlaps(self, sid: int) -> List[Overlap]:
        fwd_id = sid & ~1
        entry = self._cache.get(fwd_id)
        if entry is None:
            if self._packed is not None and fwd_id in self._packed:
                return self._materialize(sid)
            ovlps = self.engine.get_overlaps(
                self.queries, fwd_id,
                max_overlaps=self.engine.max_cur_overlaps)
            if self._packed is not None:
                self._packed.add(fwd_id, ovlps)
                return self._materialize(sid)
            rev = [o.complement() for o in ovlps]
            entry = (ovlps, rev)
            self._cache[fwd_id] = entry
        return entry[0] if sid % 2 == 0 else entry[1]

    def prefetch(self, sids, batch_rows: int = 1024,
                 max_batch_bases: int = 8 << 20,
                 progress_every: int = 0) -> None:
        """Batch-fill the overlap cache (cross-read device batching).

        Batches go through a 2-deep thread pipeline: while one batch
        waits on the device (GIL released in the fetch), the
        other runs its native host prep/finish (GIL released in C++) —
        the two-core analog of the reference's thread pool over the
        same loop (reference: overlap.cpp:630-668).  Per-batch results
        are independent, so the cache contents are identical to
        sequential order."""
        todo = []
        seen = set()
        for sid in sids:
            fwd = sid & ~1
            if (fwd not in self._cache and fwd not in seen
                    and (self._packed is None
                         or fwd not in self._packed)):
                seen.add(fwd)
                todo.append(fwd)
        # group by similar length for padding efficiency
        todo.sort(key=lambda s: self.queries.length(s))
        groups = []
        i = 0
        while i < len(todo):
            group = [todo[i]]
            bases = self.queries.length(todo[i])
            i += 1
            while (i < len(todo) and len(group) < batch_rows and
                   bases + self.queries.length(todo[i]) <
                   max_batch_bases):
                group.append(todo[i])
                bases += self.queries.length(todo[i])
                i += 1
            groups.append(group)

        from concurrent.futures import ThreadPoolExecutor
        done = 0
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = []
            gi = 0
            while gi < len(groups) or futs:
                while gi < len(groups) and len(futs) < 2:
                    futs.append((groups[gi], ex.submit(
                        self.engine.get_overlaps_batch, self.queries,
                        groups[gi],
                        max_overlaps=self.engine.max_cur_overlaps)))
                    gi += 1
                group, fut = futs.pop(0)
                res = fut.result()
                for sid, ovlps in res.items():
                    if self._packed is not None:
                        self._packed.add(sid, ovlps)
                    else:
                        self._cache[sid] = (
                            ovlps, [o.complement() for o in ovlps])
                done += len(group)
                if (progress_every and done // progress_every !=
                        (done - len(group)) // progress_every):
                    logger.info("overlaps: %d/%d reads", done,
                                len(todo))

    def overlaps(self, sid: int) -> List[Overlap]:
        return self.lazy_overlaps(sid)

    def _unsafe(self, sid: int) -> List[Overlap]:
        fwd_id = sid & ~1
        if fwd_id not in self._cache:
            self._cache[fwd_id] = ([], [])
        entry = self._cache[fwd_id]
        return entry[0] if sid % 2 == 0 else entry[1]

    def find_all_overlaps(self, progress_every: int = 0) -> None:
        """All-vs-all (reference: overlap.cpp:630-668)."""
        self.prefetch(self.queries.ids(),
                      progress_every=progress_every)
        self.ensure_transitivity(only_max_ext=False)
        n = sum(len(v[0]) * 2 for v in self._cache.values())
        logger.debug("Found %d overlaps", n)
        self.filter_overlaps()
        n = sum(len(v[0]) * 2 for v in self._cache.values())
        logger.debug("Left %d overlaps after filtering", n)

    def ensure_transitivity(self, only_max_ext: bool) -> None:
        """Make the overlap relation symmetric
        (reference: overlap.cpp:576-627)."""
        assert self._packed is None, \
            "transitivity mutates lists in place; use packed=False"
        all_ids = []
        for fwd_id in list(self._cache.keys()):
            all_ids.extend([fwd_id, fwd_id + 1])
        to_add: Dict[int, List[Overlap]] = {}
        # per-sid {ext_id: index} maps make each reverse lookup O(1)
        # instead of a linear scan of the ext list (the scans dominated
        # the host side of find_all_overlaps at high coverage)
        if only_max_ext:
            ext_pos: Dict[int, Dict[int, int]] = {}
            for sid in all_ids:
                d: Dict[int, int] = {}
                for i, ov in enumerate(self._unsafe(sid)):
                    d.setdefault(ov.ext_id, i)  # first entry wins
                ext_pos[sid] = d
        for sid in all_ids:
            for ov in self._unsafe(sid):
                if only_max_ext:
                    ext_list = self._unsafe(ov.ext_id)
                    i = ext_pos.get(ov.ext_id, {}).get(ov.cur_id)
                    if i is not None:
                        if ov.score > ext_list[i].score:
                            ext_list[i] = ov.reverse()
                    else:
                        to_add.setdefault(ov.ext_id, []).append(ov.reverse())
                else:
                    to_add.setdefault(ov.ext_id, []).append(ov.reverse())
        for sid, ovlps in to_add.items():
            self._unsafe(sid).extend(ovlps)

    def filter_overlaps(self) -> None:
        """Cluster near-duplicate overlaps per read and keep the best
        (reference: overlap.cpp:681-741).

        Pairwise comparisons run as NumPy broadcasts per (read, ext)
        group instead of Python object loops — the O(n^2)-pair
        attribute-access loop dominated host time at high coverage."""
        max_ends_diff = self.engine.k
        for sid in [i for f in self._cache for i in (f, f + 1)]:
            ovlps = self._unsafe(sid)
            n = len(ovlps)
            if not n:
                continue
            ext = np.fromiter((o.ext_id for o in ovlps), np.int64, n)
            cb = np.fromiter((o.cur_begin for o in ovlps), np.int64, n)
            ce = np.fromiter((o.cur_end for o in ovlps), np.int64, n)
            eb = np.fromiter((o.ext_begin for o in ovlps), np.int64, n)
            ee = np.fromiter((o.ext_end for o in ovlps), np.int64, n)
            order = np.argsort(ext, kind="stable")
            bounds = np.flatnonzero(np.concatenate(
                [[True], ext[order][1:] != ext[order][:-1]]))
            bounds = np.append(bounds, n)
            ds = DisjointSet()
            for i in range(n):
                ds.add(i)
            for s, e in zip(bounds[:-1], bounds[1:]):
                if e - s < 2:
                    continue
                g = order[s:e]
                # o1 = the earlier-listed overlap of the pair (matches
                # the original loop's o1/o2 orientation)
                ii, jj = np.meshgrid(g, g, indexing="ij")
                up = ii < jj
                cur_int = (np.minimum(ce[ii], ce[jj])
                           - np.maximum(cb[ii], cb[jj]))
                ext_int = (np.minimum(ee[ii], ee[jj])
                           - np.maximum(eb[ii], eb[jj]))
                cur_diff = (ce[ii] - cb[ii]) - cur_int
                ext_diff = (ee[ii] - eb[ii]) - ext_int
                close = (up & (cur_diff < max_ends_diff)
                         & (ext_diff < max_ends_diff))
                for a, b in zip(ii[close], jj[close]):
                    ds.union(int(a), int(b))
            new = []
            for members in ds.groups().values():
                best = max(members, key=lambda i: ovlps[i].score)
                new.append(ovlps[best])
            new.sort(key=lambda o: o.cur_begin)
            fwd_id = sid & ~1
            entry = self._cache[fwd_id]
            if sid % 2 == 0:
                self._cache[fwd_id] = (new, entry[1])
            else:
                self._cache[fwd_id] = (entry[0], new)

    def estimate_overlaper_parameters(self, max_seqs: int = 1000,
                                      seed: int = 42) -> None:
        """Median divergence of each sampled read's largest overlap
        (reference: overlap.cpp:744-817)."""
        rng = np.random.default_rng(seed)
        ids = self.queries.ids()
        if not ids:
            self.mean_true_divergence = 0.5
            return
        # sample distinct ids so the effective sample size is exactly
        # min(max_seqs, n) (reference: overlap.cpp:752-760 samples
        # without replacement via shuffled id list)
        n_sample = min(max_seqs, len(ids))
        sample = [ids[i] for i in
                  rng.choice(len(ids), size=n_sample, replace=False)]
        sample.sort(key=lambda s: self.queries.length(s))
        divs = []
        for lo in range(0, len(sample), 256):
            res = self.engine.get_overlaps_batch(
                self.queries, sample[lo:lo + 256])
            for ovlps in res.values():
                if ovlps:
                    best = max(ovlps, key=lambda o: o.cur_range)
                    divs.append(best.divergence)
        if divs:
            self.mean_true_divergence = float(np.median(divs))
        else:
            logger.warning("No overlaps found - unable to estimate "
                           "parameters")
            self.mean_true_divergence = 0.5
        logger.debug("Initial divergence estimate: %.4f",
                     self.mean_true_divergence)

    def log_divergence_stats(self) -> None:
        """Median + ASCII histogram of observed overlap divergences
        (behavioral equivalent of overlapDivergenceStats,
        reference: src/sequence/overlap.cpp:829-896): 100 columns over
        [0, 0.5), 20 rows, current max-divergence cutoff marked '|'."""
        divs = np.asarray(self.engine.div_stats, dtype=np.float64)
        if not len(divs):
            return
        logger.info("Median overlap divergence: %.6f",
                    float(np.median(divs)))
        cols, rows, dmax = 100, 20, 0.5
        hist, _ = np.histogram(divs, bins=cols, range=(0.0, dmax))
        peak = max(1, int(hist.max()))
        cutoff = int(self.engine.max_divergence / dmax * cols)
        lines = []
        for h in range(rows - 1, -1, -1):
            row = [("*" if hist[i] / peak > h / rows else
                    "|" if i == cutoff else " ") for i in range(cols)]
            lines.append("    |" + "".join(row))
        lines.append("    " + "-" * cols)
        footer = [" "] * cols
        for i in range(10):
            for j, ch in enumerate(f"{i * 5}%"):
                footer[i * cols // 10 + j] = ch
        lines.append("    " + "".join(footer))
        q25, q50, q75 = np.percentile(divs, [25, 50, 75])
        logger.debug("Sequence divergence distribution:\n%s\n"
                     "    Q25 = %.2f, Q50 = %.2f, Q75 = %.2f",
                     "\n".join(lines), q25, q50, q75)

    def set_divergence_threshold(self, threshold: float,
                                 relative: bool) -> None:
        self.engine.max_divergence = (
            (self.mean_true_divergence if relative else 0.0) + threshold)
        logger.debug("Max divergence threshold set to %.4f",
                     self.engine.max_divergence)

    def dump_shard(self, path: str) -> None:
        """Serialize this process's overlap-cache partition to one npz
        (the multi-host ava exchange: each host computes overlaps for
        its read partition and ships the shard over the shared
        filesystem — the per-host generalization of the reference's
        inter-stage file bus, e.g. its alignment dumps,
        reference: src/repeat_graph/read_aligner.h:32-33)."""
        reads = sorted(self._cached_reads())
        counts = []
        cur_id, ext_id = [], []
        coords = []
        score, div = [], []
        aoff = [0]
        anchors = []
        for fwd in reads:
            ovlps = self._fwd_list(fwd)
            counts.append(len(ovlps))
            for o in ovlps:
                cur_id.append(o.cur_id)
                ext_id.append(o.ext_id)
                coords.append((o.cur_begin, o.cur_end, o.cur_len,
                               o.ext_begin, o.ext_end, o.ext_len))
                score.append(o.score)
                div.append(o.divergence)
                km = (o.kmer_matches if o.kmer_matches is not None
                      else np.zeros((0, 2), np.int32))
                anchors.append(np.asarray(km, dtype=np.int32))
                aoff.append(aoff[-1] + len(km))
        # publish atomically: a reader must never see a half-written
        # shard (the barrier only proves the writer REACHED the dump)
        tmp = f"{path}.tmp{os.getpid()}"
        np.savez_compressed(
            tmp, reads=np.asarray(reads, np.int64),
            counts=np.asarray(counts, np.int64),
            cur_id=np.asarray(cur_id, np.int64),
            ext_id=np.asarray(ext_id, np.int64),
            coords=np.asarray(coords, np.int64).reshape(-1, 6),
            score=np.asarray(score, np.int64),
            div=np.asarray(div, np.float64),
            aoff=np.asarray(aoff, np.int64),
            anchors=(np.concatenate(anchors) if anchors
                     else np.zeros((0, 2), np.int32)))
        os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)

    def load_shard(self, path: str) -> None:
        """Merge a dumped shard into the cache (complement lists are
        rebuilt, exactly as prefetch builds them)."""
        z = np.load(path)
        reads = z["reads"]
        counts = z["counts"]
        coords = z["coords"]
        aoff = z["aoff"]
        anchors = z["anchors"]
        # hoist npz members: NpzFile re-decompresses the WHOLE array on
        # every [] access — per-overlap indexing of z[...] made the
        # merge O(n^2) (measured: a 187 MB / ~700 k-overlap shard took
        # >18 min; hoisted it is seconds)
        cur_id = z["cur_id"]
        ext_id = z["ext_id"]
        score = z["score"]
        div = z["div"]
        v = 0
        for fwd, n in zip(reads, counts):
            ovlps = []
            for _ in range(n):
                ov = Overlap(int(cur_id[v]), int(ext_id[v]),
                             *(int(x) for x in coords[v]),
                             score=int(score[v]),
                             divergence=float(div[v]))
                km = anchors[aoff[v]:aoff[v + 1]]
                ov.kmer_matches = km if len(km) else None
                ovlps.append(ov)
                v += 1
            if self._packed is not None:
                self._packed.add(int(fwd), ovlps)
            else:
                self._cache[int(fwd)] = (ovlps,
                                         [o.complement() for o in ovlps])

    def _fwd_list(self, fwd_id: int) -> List[Overlap]:
        entry = self._cache.get(fwd_id)
        if entry is not None:
            return entry[0]
        return self._packed.get(fwd_id)

    def all_overlaps(self) -> List[Overlap]:
        out = []
        for fwd_id in self._cached_reads():
            f = self._fwd_list(fwd_id)
            out.extend(f)
            out.extend(o.complement() for o in f)
        return out
