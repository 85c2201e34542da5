"""K-mer / minimizer posting-list index on device kernels.

Replaces the reference's VertexIndex + KmerCounter
(reference: src/sequence/vertex_index.{h,cpp}) — a concurrent cuckoo map
of k-mer -> packed posting arrays — with sorted device arrays:

    uniq_kmers [U] sorted int64   (searchsorted lookup, log2 U gathers)
    offsets    [U+1] int32        (posting-list extents)
    post_seq / post_pos / post_flip [P]   (the postings)

Both reference build modes are provided:
- minimizers (reference: vertex_index.cpp:389-483 buildIndexMinimizers)
- per-read top-frequency solid k-mers for uneven coverage / raw reads
  (reference: vertex_index.cpp:25-125 buildIndexUnevenCoverage,
  yieldFrequentKmers vertex_index.cpp:440-480)

Only forward strands are indexed; a posting carries a `flip` flag when
the canonical k-mer is the reverse-complement of the forward-strand
k-mer, letting lookups synthesize reverse-strand matches exactly like
the reference's KmerPosIterator (reference: src/sequence/vertex_index.h:158-174).

Construction is a sort-based group-by on device: extract + select per
padded batch, pack payloads, one `jax.lax.sort` over (kmer, payload) —
the deterministic, collective-friendly replacement for atomic hash-table
updates. The repeat-kmer cutoff (repeat_kmer_rate x mean frequency,
reference: vertex_index.cpp:173-212 filterFrequentKmers) drops postings
of repetitive k-mers but keeps them queryable via `is_repetitive`.
"""

from __future__ import annotations

import functools
import logging
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from flye_jax.io.seqstore import SequenceStore
from flye_jax.ops.kmers import (canonical_kmers, minimizer_mask,
                                sample_mask, splitmix64)

logger = logging.getLogger("flye_jax")

# default length buckets for padded batches (powers of two keep the
# number of distinct compiled shapes small)
_BUCKETS = [2048, 4096, 8192, 16384, 32768, 65536, 131072, 262144,
            524288, 1048576, 4194304, 16777216, 67108864, 268435456]


@jax.jit
def _lookup_device(uniq, q, rmax):
    """Shared searchsorted+verify program; uniq and q are padded to
    power-of-two lengths so all indexes/batches reuse one compile."""
    row = jnp.searchsorted(uniq, q)
    row = jnp.clip(row, 0, rmax)
    return row, uniq[row] == q


@functools.partial(jax.jit, static_argnames=("k", "narrow"))
def _probe_device(batch, lens, uniq, repet, rmax, k, narrow):
    """Fused canonicalize + index probe for a padded query batch.

    Packs (row, hit, repetitive, is_fwd) into ONE integer per position
    so the whole probe costs a single device->host fetch.  With
    narrow=True (row ids < 2^28,
    i.e. any index below ~270M distinct k-mers) the pack is int32,
    halving the transferred bytes."""
    from flye_jax.ops.kmers import canonical_kmers
    canon, is_fwd, valid = canonical_kmers(batch, lens, k)
    flat = canon.reshape(-1)
    row = jnp.clip(jnp.searchsorted(uniq, flat), 0, rmax)
    found = (uniq[row] == flat).reshape(canon.shape) & valid
    rep = repet[row].reshape(canon.shape) & found
    hit = found & ~rep
    if narrow:
        return (row.astype(jnp.int32).reshape(canon.shape)
                | (hit.astype(jnp.int32) << 28)
                | (rep.astype(jnp.int32) << 29)
                | (is_fwd.astype(jnp.int32) << 30))
    return (row.astype(jnp.int64).reshape(canon.shape)
            | (hit.astype(jnp.int64) << 32)
            | (rep.astype(jnp.int64) << 33)
            | (is_fwd.astype(jnp.int64) << 34))


def _bucket_len(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return int(n)


def batched_ids(store: SequenceStore, ids: Sequence[int],
                max_batch_bases: int = 64 << 20):
    """Yield (ids, pad_len) groups bucketed by length."""
    by_bucket = {}
    for sid in ids:
        by_bucket.setdefault(_bucket_len(store.length(sid)), []).append(sid)
    for pad, sids in sorted(by_bucket.items()):
        rows = max(1, max_batch_bases // pad)
        for i in range(0, len(sids), rows):
            yield sids[i:i + rows], pad


class KmerIndex:
    """Posting-list index over a SequenceStore."""

    # single-device probing may run on the host (native probe_stream,
    # see probe_stream_host).  ShardedKmerIndex keeps the device path —
    # its table is partitioned across the mesh.
    host_probe_ok = True

    def __init__(self, store: SequenceStore, k: int):
        self.store = store
        self.k = k
        self.uniq_kmers: np.ndarray = None  # [U] int64 sorted (host)
        self.offsets: np.ndarray = None    # [U+1] int64 (host)
        self.counts: np.ndarray = None     # [U] int32 (host, post-filter)
        self.post_seq: np.ndarray = None   # [P] int32 seq index
        self.post_pos: np.ndarray = None   # [P] int32 pos on indexed strand
        self.post_flip: np.ndarray = None  # [P] bool canonical==rc of fwd
        self.repetitive: np.ndarray = None  # [U] bool
        self.repetitive_cutoff: float = float("inf")
        self.sample_rate: float = 1.0  # mean bases per indexed position

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    _STREAM_W = 16384       # chunk width of the flat-stream layout
    _STREAM_ROWS = 512      # device rows per large stream batch
    _STREAM_ROWS_SMALL = 64  # device rows per small stream batch

    @classmethod
    def _stream_row_batches(cls, n_rows: int):
        """Yield (r0, fixed_rows) batches covering n_rows with exactly
        two compiled shapes: 512-row batches for bulk, one 64-row shape
        for tails/small streams (every extra row count would compile
        its own program)."""
        R, S = cls._STREAM_ROWS, cls._STREAM_ROWS_SMALL
        r0 = 0
        while n_rows - r0 > 4 * S:
            yield r0, R
            r0 += min(R, n_rows - r0)
        while r0 < n_rows:
            yield r0, S
            r0 += min(S, n_rows - r0)

    def _extract_selected(self, ids, w: int, sample: int):
        """Run the fused device selection kernel over the flat read
        stream and compact to triple arrays (canon kmer, seq index,
        pos, flip).

        All reads concatenate into one base stream cut into fixed-width
        overlapping chunks (flat layout: transferred bytes ~= true base
        count; the per-read padded layout wasted 3-6x on padding).  The
        kernel packs (kmer, strand, selected) into one uint64 per
        position so the whole extraction costs a single transfer."""
        from flye_jax.ops.kmers import stream_select_packed

        k = self.k
        ids = list(ids)
        if not ids:
            z = np.zeros(0, dtype=np.int64)
            return z, z.astype(np.int32), z.astype(np.int32), z.astype(bool)
        lens = np.asarray([self.store.length(s) for s in ids],
                          dtype=np.int64)
        starts = np.zeros(len(ids) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        n_total = int(starts[-1])
        stream = np.concatenate([self.store.get(s) for s in ids])

        W = self._STREAM_W
        step = W - (k - 1) - 2 * (w - 1)
        n_rows = max(1, -(-max(0, n_total - k + 1) // step))
        # left pad w-1 (row margins), right pad to the row grid
        pad_stream = np.zeros((w - 1) + n_rows * step + (W - step),
                              dtype=np.uint8)
        pad_stream[w - 1:w - 1 + n_total] = stream

        # starts table padded to a power of two (stable device shape)
        Sp = 1 << max(6, (len(starts) - 1).bit_length())
        starts_p = np.full(Sp, n_total, dtype=np.int64)
        starts_p[:len(starts)] = starts
        starts_dev = jnp.asarray(starts_p)

        if w == 1:
            # single-device w=1 extraction runs on the host: the device
            # pass is latency/transfer-bound here (same trade as
            # probe_stream_host), and the native rolling extraction is
            # byte-identical (tests/test_index.py builds go through it)
            from flye_jax import native
            mod = native.get()
            if mod is not None:
                kb, rb, pb, fb = mod.extract_kmers(
                    np.ascontiguousarray(stream, dtype=np.uint8),
                    starts, len(ids), int(k), int(sample))
                rid = np.frombuffer(rb, np.int32)
                seq = np.asarray([s >> 1 for s in ids],
                                 dtype=np.int32)[rid]
                return (np.frombuffer(kb, np.int64), seq,
                        np.frombuffer(pb, np.int32),
                        np.frombuffer(fb, np.uint8).astype(bool))

        kmers_l, seq_l, pos_l, flip_l = [], [], [], []
        strided = np.lib.stride_tricks.as_strided(
            pad_stream, shape=(n_rows, W), strides=(step, 1))
        for r0, nr in self._stream_row_batches(n_rows):
            rows = strided[r0:r0 + nr]
            nb = len(rows)
            if nb < nr:
                chunk = np.zeros((nr, W), dtype=np.uint8)
                chunk[:nb] = rows
            else:
                chunk = np.ascontiguousarray(rows)
            from flye_jax.parallel.runtime import get_runtime
            packed = np.asarray(stream_select_packed(
                get_runtime().shard_rows(chunk), starts_dev,
                jnp.int64(r0),
                jnp.int64(n_total), k=k, w=w, sample=sample, step=step))
            rsel, cols = np.nonzero(packed & 1)
            p = packed[rsel, cols]
            g = (r0 + rsel.astype(np.int64)) * step + cols - (w - 1)
            rid = np.searchsorted(starts, g, side="right") - 1
            kmers_l.append((p >> 2).astype(np.int64))
            seq_l.append(np.asarray([s >> 1 for s in ids],
                                    dtype=np.int32)[rid])
            pos_l.append((g - starts[rid]).astype(np.int32))
            flip_l.append((p >> 1) & 1 == 0)
        return (np.concatenate(kmers_l), np.concatenate(seq_l),
                np.concatenate(pos_l), np.concatenate(flip_l))

    def _solid_select_device(self, ids, select_rate: float,
                             tandem_freq: int, global_min_freq: int,
                             sample: int):
        """Device-resident pass A for build_solid: extraction batches
        stay on device, counting/thresholding/tandem-filter run as one
        device program (ops.kmers.solid_select_device), and only the
        compacted selected postings cross the link (~12 bytes per
        selected posting vs 8 bytes per raw position before — the
        full-stream download made the index build the slowest stage,
        VERDICT round-1 gap N5)."""
        from flye_jax.ops.kmers import (solid_select_device,
                                        stream_select_packed)
        k = self.k
        ids = list(ids)
        lens = np.asarray([self.store.length(s) for s in ids],
                          dtype=np.int64)
        starts = np.zeros(len(ids) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        n_total = int(starts[-1])
        if n_total == 0:
            z = np.zeros(0, dtype=np.int64)
            return (z, z.astype(np.int32), z.astype(np.int32),
                    z.astype(bool))
        stream = np.concatenate([self.store.get(s) for s in ids])
        W = self._STREAM_W
        step = W - (k - 1)
        n_rows = max(1, -(-max(0, n_total - k + 1) // step))
        pad_stream = np.zeros(n_rows * step + (W - step), dtype=np.uint8)
        pad_stream[:n_total] = stream
        Sp = 1 << max(6, (len(starts) - 1).bit_length())
        starts_p = np.full(Sp, n_total, dtype=np.int64)
        starts_p[:len(starts)] = starts
        starts_dev = jnp.asarray(starts_p)

        from flye_jax.parallel.runtime import get_runtime
        rt = get_runtime()
        strided = np.lib.stride_tricks.as_strided(
            pad_stream, shape=(n_rows, W), strides=(step, 1))
        parts = []
        for r0, nr in self._stream_row_batches(n_rows):
            rows = strided[r0:r0 + nr]
            nb = len(rows)
            if nb < nr:
                chunk = np.zeros((nr, W), dtype=np.uint8)
                chunk[:nb] = rows
            else:
                chunk = np.ascontiguousarray(rows)
            parts.append(stream_select_packed(
                rt.shard_rows(chunk), starts_dev, jnp.int64(r0),
                jnp.int64(n_total), k=k, w=1, sample=sample,
                step=step).reshape(-1))
        packed_all = jnp.concatenate(parts) if len(parts) > 1 else parts[0]

        # per-read p90 gather indices over the (read, freq)-sorted
        # valid positions; the kernel samples (pos % sample == 0)
        # per read, so valid counts are host-computable
        n_valid = np.where(lens >= k,
                           -(-(lens - k + 1) // sample), 0)
        prefix = np.concatenate([[0], np.cumsum(n_valid)])
        idx90 = prefix[:-1] + np.minimum(
            np.maximum(n_valid - 1, 0),
            (0.9 * n_valid).astype(np.int64))
        idx90_p = np.zeros(Sp, dtype=np.int64)
        idx90_p[:len(idx90)] = idx90

        pk, pg, n_sel = solid_select_device(
            packed_all, starts_dev, jnp.asarray(idx90_p),
            jnp.float32(select_rate), k=k, W=W, step=step,
            sample=sample, tandem_freq=tandem_freq,
            global_min=global_min_freq)
        n = int(n_sel)
        # grid-pad the download slice so its shape doesn't recompile
        # per run
        grid = 1 << 22
        n_pad = min(len(pk), -(-max(1, n) // grid) * grid)
        pk_h = np.asarray(pk[:n_pad])[:n]
        pg_h = np.asarray(pg[:n_pad])[:n].astype(np.int64)

        rid = np.searchsorted(starts, pg_h, side="right") - 1
        kmers = (pk_h >> np.uint64(2)).astype(np.int64)
        flip = ((pk_h >> np.uint64(1)) & np.uint64(1)) == 0
        seq = np.asarray([s >> 1 for s in ids], dtype=np.int32)[rid]
        pos = (pg_h - starts[rid]).astype(np.int32)
        return kmers, seq, pos, flip

    @staticmethod
    def _sort_triples(kmers, seq, pos, flip):
        """Deterministic sort by (kmer, seq, pos).

        Runs on host: the triples originate host-side and the sorted
        postings are consumed host-side, so a device `lax.sort` would
        add a 2x16B/posting round trip (hundreds of MB per build) to
        save a numpy sort."""
        # payload layout: seq(30) | pos(32) | flip(1) in 63 bits — bit
        # 63 must stay clear because the native radix orders payloads
        # unsigned while the lexsort fallback orders signed int64 (the
        # two would diverge for seq ids >= 2^30, i.e. >1 G reads)
        if len(seq) and int(seq.max()) >= (1 << 30):
            raise ValueError("k-mer payload packing supports < 2^30 "
                             "sequence ids")
        payload = ((seq.astype(np.int64) << 33)
                   | (pos.astype(np.int64) << 1)
                   | flip.astype(np.int64))
        from flye_jax import native
        mod = native.get()
        if mod is not None and hasattr(mod, "radix_sort_pairs"):
            # threaded native radix (stable, same (kmer, payload) key
            # as the lexsort): ~10x the numpy comparison sort at the
            # 50 M-posting scale
            abits = (int(kmers.max()).bit_length()
                     if len(kmers) else 1) or 1
            sk_b, sp_b = mod.radix_sort_pairs(
                np.ascontiguousarray(kmers, np.int64),
                np.ascontiguousarray(payload, np.int64), abits)
            sk = np.frombuffer(sk_b, np.int64)
            sp = np.frombuffer(sp_b, np.int64)
        else:
            order = np.lexsort((payload, kmers))
            sk = kmers[order]
            sp = payload[order]
        return (sk, (sp >> 33).astype(np.int32),
                ((sp >> 1) & 0xFFFFFFFF).astype(np.int32),
                (sp & 1).astype(bool))

    def _finalize(self, kmers, seq, pos, flip, min_cov: int,
                  repeat_kmer_rate: float, drop_mask: Optional[np.ndarray] = None,
                  mean_freq_override: Optional[float] = None):
        """Group sorted triples, apply the repetitive-kmer filter, and
        publish the index arrays.

        mean_freq_override supplies the GLOBAL mean k-mer frequency
        when this index holds only one hash-shard partition (the
        multi-process partitioned build, parallel/partitioned.py):
        the repetitive cutoff is rate x global mean, which a partition
        cannot compute from its own counts alone."""
        if drop_mask is not None and drop_mask.any():
            keep = ~drop_mask
            kmers, seq, pos, flip = kmers[keep], seq[keep], pos[keep], flip[keep]
        n = len(kmers)
        if n == 0:
            self.uniq_kmers = np.zeros(0, dtype=np.int64)
            self._uniq_dev = None
            self.offsets = np.zeros(1, dtype=np.int64)
            self.counts = np.zeros(0, dtype=np.int32)
            self.post_seq = seq
            self.post_pos = pos
            self.post_flip = flip
            self.repetitive = np.zeros(0, dtype=bool)
            return
        starts = np.flatnonzero(np.concatenate([[True], kmers[1:] != kmers[:-1]]))
        uniq = kmers[starts]
        counts = np.diff(np.concatenate([starts, [n]])).astype(np.int64)

        # repetitive cutoff: rate x mean frequency over kmers with
        # count >= min_cov (reference: vertex_index.cpp:173-190)
        eligible = counts >= min_cov
        total = int(counts[eligible].sum())
        uniq_n = int(eligible.sum())
        mean_freq = (mean_freq_override if mean_freq_override is not None
                     else total / (uniq_n + 1))
        self.repetitive_cutoff = repeat_kmer_rate * mean_freq
        repetitive = counts > self.repetitive_cutoff
        n_rep = int(counts[repetitive].sum())
        logger.debug("Mean k-mer frequency: %.2f", mean_freq)
        logger.debug("Repetitive k-mer frequency cutoff: %.1f",
                     self.repetitive_cutoff)
        logger.debug("Filtered %d repetitive k-mer postings (%.4f)",
                     n_rep, n_rep / max(1, total))

        # drop postings of repetitive kmers, keep the uniq row (count 0)
        if repetitive.any():
            keep_post = np.ones(n, dtype=bool)
            for s, c in zip(starts[repetitive],
                            counts[repetitive]):
                keep_post[s:s + c] = False
            seq, pos, flip = seq[keep_post], pos[keep_post], flip[keep_post]
            counts = np.where(repetitive, 0, counts)

        # host array: probes upload a padded copy lazily via
        # _device_tables; an eager device copy would double the upload
        self.uniq_kmers = np.ascontiguousarray(uniq)
        self._uniq_dev = None  # lazy padded device table (see lookup)
        self.offsets = np.zeros(len(uniq) + 1, dtype=np.int64)
        np.cumsum(counts, out=self.offsets[1:])
        self.counts = counts.astype(np.int32)
        self.post_seq = seq
        self.post_pos = pos
        self.post_flip = flip
        self.repetitive = repetitive
        total_entries = int(counts.sum())
        logger.debug("Selected k-mers: %d", len(uniq))
        logger.debug("K-mer index size: %d", total_entries)
        logger.debug("Mean k-mer index frequency: %.2f",
                     total_entries / max(1, len(uniq)))

    @classmethod
    def build_minimizers(cls, store: SequenceStore, k: int, w: int,
                         min_cov: int = 1, repeat_kmer_rate: float = 100,
                         ids: Optional[Sequence[int]] = None) -> "KmerIndex":
        """Minimizer index (reference: vertex_index.cpp:389-483)."""
        idx = cls(store, k)
        idx.w = w
        ids = list(ids) if ids is not None else store.ids()
        logger.info("Building minimizer index (k=%d, w=%d) over %d seqs",
                    k, w, len(ids))
        kmers, seq, pos, flip = idx._extract_selected(ids, w=w, sample=1)
        kmers, seq, pos, flip = cls._sort_triples(kmers, seq, pos, flip)
        idx._finalize(kmers, seq, pos, flip, min_cov, repeat_kmer_rate)
        total_len = sum(store.length(i) for i in ids)
        total_entries = int(idx.counts.sum()) if len(idx.counts) else 1
        idx.sample_rate = total_len / max(1, total_entries)
        logger.debug("Minimizer rate: %.2f", idx.sample_rate)
        return idx

    @classmethod
    def build_solid(cls, store: SequenceStore, k: int,
                    select_rate: float, tandem_freq: int,
                    global_min_freq: int = 2, sample: int = 1,
                    repeat_kmer_rate: float = 100,
                    ids: Optional[Sequence[int]] = None,
                    device_select: Optional[bool] = None) -> "KmerIndex":
        """Uneven-coverage solid-kmer index: per read, keep the top
        `select_rate` fraction of positions by global canonical-kmer
        frequency (ties extend the cut), drop within-read tandems
        (reference: vertex_index.cpp:25-125, 440-480).

        device_select: run counting + thresholding fully on device
        (_solid_select_device) so only compacted selected postings cross
        the device->host link.  Default OFF (FLYE_JAX_DEVICE_COUNT=1
        turns it on); its speed on a GPU is not measured.  Both paths
        produce byte-identical indexes (tests/test_index.py); a failure
        of the device path raises."""
        import os
        idx = cls(store, k)
        idx.w = 1
        ids = list(ids) if ids is not None else store.ids()
        logger.info("Building solid-kmer index (k=%d) over %d seqs",
                    k, len(ids))
        if device_select is None:
            device_select = os.environ.get(
                "FLYE_JAX_DEVICE_COUNT", "") == "1"
        if device_select:
            kmers, seq, pos, flip = idx._solid_select_device(
                ids, select_rate, tandem_freq, global_min_freq, sample)
            kmers, seq, pos, flip = cls._sort_triples(
                kmers, seq, pos, flip)
            idx._finalize(kmers, seq, pos, flip, global_min_freq,
                          repeat_kmer_rate)
            total_len = sum(store.length(i) for i in ids)
            total_entries = (int(idx.counts.sum())
                             if len(idx.counts) else 1)
            idx.sample_rate = total_len / max(1, total_entries)
            return idx
        # pass A: global canonical-kmer counts (sampled)
        kmers, seq, pos, flip = idx._solid_select_host(
            ids, select_rate, tandem_freq, global_min_freq, sample)
        if len(kmers) == 0:
            idx._finalize(kmers, seq, pos, flip, global_min_freq,
                          repeat_kmer_rate)
            return idx
        kmers, seq, pos, flip = cls._sort_triples(kmers, seq, pos, flip)
        idx._finalize(kmers, seq, pos, flip, global_min_freq,
                      repeat_kmer_rate)
        total_len = sum(store.length(i) for i in ids)
        total_entries = int(idx.counts.sum()) if len(idx.counts) else 1
        idx.sample_rate = total_len / max(1, total_entries)
        return idx

    def _solid_select_host(self, ids, select_rate, tandem_freq,
                           global_min_freq, sample):
        """Host counting + per-read frequency selection for the solid
        index; returns the selected (kmers, seq, pos, flip) triples in
        stream order (shared by build_solid and the mesh-sharded
        build_solid_mesh)."""
        kmers, seq, pos, flip = self._extract_selected(ids, w=1,
                                                       sample=sample)
        if len(kmers) == 0:
            return kmers, seq, pos, flip
        from flye_jax import native
        mod = native.get()
        table_bytes = 1 << (2 * self.k)
        if (mod is not None and hasattr(mod, "count_kmer_freqs_radix")
                and len(kmers) < 500 * 10**6):
            # threaded radix-sort exact counting — linear time, ~28
            # bytes/key workspace; beats the numpy argsort at every
            # size (measured 10 M keys: 0.2 s vs 4.0 s) and the flat
            # 4^k table below ~500 M keys (its ~8-17 GB first touch);
            # above that the flat counter's fixed table wins on memory
            # int32 throughout: the int64 frequency copies were part
            # of the 50 Mb run's 78 Gb index-build peak
            freq = np.frombuffer(
                mod.count_kmer_freqs_radix(
                    np.ascontiguousarray(kmers, dtype=np.int64),
                    int(self.k)),
                np.int32)
        elif (mod is not None and 2 * self.k <= 34 and
                (len(kmers) >= 150 * 10**6 or table_bytes <= (1 << 28))):
            # flat saturating-counter pass (native; the reference's
            # KmerCounter design, vertex_index.cpp:504-557).  uint8
            # saturation at 255 cannot change the selection: the
            # per-read threshold below is clamped to <= 4, so any
            # count >= 4 is equivalent.  Replaces the full argsort of
            # the k-mer stream — 40 min / 87 Gb peak at 1.46 G k-mers
            # on the 50 Mb run — with two linear passes.  Only engaged
            # for large streams (or small tables): below the crossover
            # the 4^k-entry table's first-touch cost loses to the sort
            # (measured at k=17: 10 M kmers flat 105 s vs sort 2.7 s;
            # 100 M flat 89 s vs 43 s; 200 M flat 144 s vs 169 s — the
            # break-even interpolates to ~150 M), and the sort path's
            # ~6x int64 workspace still fits this host comfortably at
            # those sizes.
            freq = np.frombuffer(
                mod.count_kmer_freqs(
                    np.ascontiguousarray(kmers, dtype=np.int64),
                    int(self.k)),
                np.uint8).astype(np.int32)
        else:
            order = np.argsort(kmers, kind="stable")
            skmers = kmers[order]
            starts = np.flatnonzero(
                np.concatenate([[True], skmers[1:] != skmers[:-1]]))
            cnt_vals = np.diff(np.concatenate(
                [starts, [len(skmers)]])).astype(np.int64)

            # per-position global frequency by inverting the sort
            # permutation (repeat each group's count across its
            # members, then scatter back to stream order)
            freq = np.empty(len(kmers), dtype=np.int64)
            freq[order] = np.repeat(cnt_vals, cnt_vals)

        return self._select_with_freq(kmers, seq, pos, flip, freq,
                                      select_rate, tandem_freq,
                                      global_min_freq)

    def _select_with_freq(self, kmers, seq, pos, flip, freq,
                          select_rate, tandem_freq, global_min_freq):
        """Per-read frequency-threshold selection given each stream
        position's GLOBAL frequency.  Split out so the hash-partitioned
        multi-process build (parallel/partitioned.py) can reuse it: it
        computes global frequencies via a count exchange, then selects
        locally over its read partition — byte-identical to the
        single-process pass because selection is per-read.

        Keep positions whose global frequency marks them as genuine
        (error k-mers barely recur).  The reference keeps each read's
        top `select_rate` fraction by frequency rank
        (vertex_index.cpp:440-480); a rank cut drops
        spatially-contiguous low-coverage stretches and truncates
        chains on low-error data, so the threshold form is used
        instead: thr = max(global_min, min(4, select_rate * p90)),
        which adapts to each read's abundance (meta) while never
        gapping an isolate."""
        from flye_jax import native
        mod = native.get()
        read_starts = np.flatnonzero(
            np.concatenate([[True], seq[1:] != seq[:-1]]))
        read_ends = np.concatenate([read_starts[1:], [len(kmers)]])
        if mod is not None and hasattr(mod, "select_solid_kmers"):
            # threaded native selection (the Python per-read loop was
            # ~40% of the bench-scale build wall)
            bounds = np.concatenate(
                [read_starts, [len(kmers)]]).astype(np.int64)
            sel_mask = np.frombuffer(
                mod.select_solid_kmers(
                    np.ascontiguousarray(kmers, dtype=np.int64),
                    np.ascontiguousarray(freq, dtype=np.int32),
                    np.ascontiguousarray(bounds),
                    float(select_rate), int(tandem_freq),
                    int(global_min_freq)),
                np.uint8).astype(bool)
            return (kmers[sel_mask], seq[sel_mask], pos[sel_mask],
                    flip[sel_mask])
        sel_mask = np.zeros(len(kmers), dtype=bool)
        for s, e in zip(read_starts, read_ends):
            f = freq[s:e]
            # nearest-rank p90 (matches the device program exactly)
            p90 = (float(np.sort(f)[min(e - s - 1,
                                        int(0.9 * (e - s)))])
                   if e > s else 0.0)
            thr = max(global_min_freq, min(4, int(select_rate * p90)))
            m = f >= thr
            if tandem_freq > 0:
                km = kmers[s:e]
                u, c = np.unique(km, return_counts=True)
                tandem = c[np.searchsorted(u, km)] > tandem_freq
                m &= ~tandem
            sel_mask[s:e] = m

        return (kmers[sel_mask], seq[sel_mask], pos[sel_mask],
                flip[sel_mask])

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    @property
    def num_kmers(self) -> int:
        return len(self.counts) if self.counts is not None else 0

    @property
    def index_size(self) -> int:
        return len(self.post_seq) if self.post_seq is not None else 0

    def lookup(self, query_kmers: np.ndarray):
        """[Q] int64 canonical kmers -> (row [Q] into uniq arrays,
        found [Q] bool). Device op.

        Q is padded up to a power of two before the device call: the
        raw query count differs on every batch, and each distinct shape
        would compile its own searchsorted+gather program."""
        q = np.asarray(query_kmers)
        Q = len(q)
        if Q == 0 or self.num_kmers == 0:
            z = np.zeros(Q, dtype=np.int64)
            return z, np.zeros(Q, dtype=bool)
        Qp = 1 << max(10, (Q - 1).bit_length())
        qp = np.full(Qp, -1, dtype=np.int64)  # sentinel: below any kmer
        qp[:Q] = q
        up, _ = self._device_tables()
        row, found = _lookup_device(up, jnp.asarray(qp),
                                    jnp.int64(self.num_kmers - 1))
        return (np.asarray(row[:Q], dtype=np.int64),
                np.asarray(found[:Q]))

    def _device_tables(self):
        """Padded device copies of (uniq_kmers, repetitive): power-of-two
        length with max-sentinel / False tails, so table length does not
        key new compiles per index."""
        up = getattr(self, "_uniq_dev", None)
        if up is None:
            U = self.num_kmers
            Up = 1 << max(10, (U - 1).bit_length())
            arr = np.full(Up, np.iinfo(np.int64).max, np.int64)
            arr[:U] = np.asarray(self.uniq_kmers)
            up = self._uniq_dev = jnp.asarray(arr)
            rp = np.zeros(Up, dtype=bool)
            rp[:U] = self.repetitive
            self._rep_dev = jnp.asarray(rp)
        return up, self._rep_dev

    def probe_batch(self, batch, lens):
        """Fused canonicalize + lookup over a padded query batch.

        Returns (row [rows,pad] int, hit, rep, fwd bool arrays) from one
        packed device round trip (see _probe_device)."""
        up, rp = self._device_tables()
        narrow = self.num_kmers < (1 << 28)
        packed = np.asarray(_probe_device(
            jnp.asarray(batch), jnp.asarray(lens), up, rp,
            jnp.int64(max(0, self.num_kmers - 1)), k=self.k,
            narrow=narrow))
        shift = 28 if narrow else 32
        row = (packed & ((1 << shift) - 1)).astype(np.int64)
        hit = ((packed >> shift) & 1).astype(bool)
        rep = ((packed >> (shift + 1)) & 1).astype(bool)
        fwd = ((packed >> (shift + 2)) & 1).astype(bool)
        return row, hit, rep, fwd

    def _remap_rows(self, row: np.ndarray) -> np.ndarray:
        """Hook for subclasses whose device probe table is a re-sorted
        view of the uniq arrays (ShardedKmerIndex)."""
        return row

    def _host_probe_lut(self):
        """16-bit-prefix lookup table into the sorted uniq array
        (prefix = kmer >> shift); bounds each native probe's binary
        search to a handful of entries."""
        cached = getattr(self, "_probe_lut", None)
        if cached is not None:
            return cached
        bits = min(16, 2 * self.k)
        shift = 2 * self.k - bits
        bounds = np.arange((1 << bits) + 1, dtype=np.int64) << shift
        lut = np.searchsorted(np.asarray(self.uniq_kmers), bounds) \
            .astype(np.int64)
        self._probe_lut = (np.ascontiguousarray(lut), shift)
        return self._probe_lut

    def probe_stream_host(self, store, sids):
        """Native (C++) equivalent of probe_stream_flat for the
        single-device case, or None when unavailable.

        The device probe kernel is gather-bound (the binary search
        over the uniq table serializes ~20 gathers per position) and
        fetches 4 bytes per base back to the host.  The threaded native
        probe does the same lookup cache-resident with a 16-bit prefix
        LUT and emits only the hits.  Byte-identical
        outputs (tests/test_overlap_native.py exercises both paths).
        """
        if not self.host_probe_ok:
            return None
        from flye_jax import native
        mod = native.get()
        if mod is None:
            return None
        k = self.k
        lens = np.asarray([store.length(s) for s in sids],
                          dtype=np.int64)
        starts = np.zeros(len(sids) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        n_total = int(starts[-1])
        z = np.zeros(0, dtype=np.int64)
        if n_total == 0 or self.num_kmers == 0:
            return z, z, z.astype(bool), z, starts, n_total
        stream = np.ascontiguousarray(
            np.concatenate([store.get(s) for s in sids]),
            dtype=np.uint8)
        lut, shift = self._host_probe_lut()
        g_hit_b, row_b, fwd_b, grep_b = mod.probe_stream(
            stream, starts, len(sids),
            np.ascontiguousarray(self.uniq_kmers, dtype=np.int64),
            np.ascontiguousarray(self.repetitive).view(np.uint8),
            lut, int(k), int(shift))
        return (np.frombuffer(g_hit_b, np.int64),
                np.frombuffer(row_b, np.int64),
                np.frombuffer(fwd_b, np.uint8).astype(bool),
                np.frombuffer(grep_b, np.int64), starts, n_total)

    def probe_stream_flat(self, store, sids):
        """Probe every k-mer of the given query strands through the
        flat-stream device kernel (one packed transfer, ~1.0x bytes).

        Returns (g_hit, row_hit, fwd_hit, g_rep, starts, n_total):
          g_hit  [H] int64 ascending stream positions with index hits,
          row_hit[H] int64 uniq-row of each hit,
          fwd_hit[H] bool  query-kmer-was-forward flags,
          g_rep  [F] int64 stream positions filtered as repetitive,
          starts [len(sids)+1] int64 per-read stream offsets.
        """
        from flye_jax.ops.kmers import stream_probe_packed

        k = self.k
        lens = np.asarray([store.length(s) for s in sids], dtype=np.int64)
        starts = np.zeros(len(sids) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        n_total = int(starts[-1])
        if n_total == 0 or self.num_kmers == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z.astype(bool), z, starts, n_total
        stream = np.concatenate([store.get(s) for s in sids])

        W = self._STREAM_W
        step = W - (k - 1)
        n_rows = max(1, -(-max(1, n_total - k + 1) // step))
        pad_stream = np.zeros(n_rows * step + (k - 1), dtype=np.uint8)
        pad_stream[:n_total] = stream
        Sp = 1 << max(6, (len(starts) - 1).bit_length())
        starts_p = np.full(Sp, n_total, dtype=np.int64)
        starts_p[:len(starts)] = starts
        starts_dev = jnp.asarray(starts_p)

        up, rp = self._device_tables()
        narrow = self.num_kmers < (1 << 28)
        shift = 28 if narrow else 32

        strided = np.lib.stride_tricks.as_strided(
            pad_stream, shape=(n_rows, W), strides=(step, 1))
        g_hit_l, row_l, fwd_l, g_rep_l = [], [], [], []
        for r0, nr in self._stream_row_batches(n_rows):
            rows = strided[r0:r0 + nr]
            nb = len(rows)
            if nb < nr:
                chunk = np.zeros((nr, W), dtype=np.uint8)
                chunk[:nb] = rows
            else:
                chunk = np.ascontiguousarray(rows)
            from flye_jax.parallel.runtime import get_runtime
            packed = np.asarray(stream_probe_packed(
                get_runtime().shard_rows(chunk), starts_dev,
                jnp.int64(r0),
                jnp.int64(n_total), up, rp,
                jnp.int64(max(0, self.num_kmers - 1)),
                k=k, step=step, narrow=narrow))
            any_mask = (packed >> shift) & 3  # hit | rep
            rsel, cols = np.nonzero(any_mask)
            p = packed[rsel, cols]
            g = (r0 + rsel.astype(np.int64)) * step + cols
            is_hit = ((p >> shift) & 1).astype(bool)
            g_rep_l.append(g[~is_hit])
            g_hit_l.append(g[is_hit])
            ph = p[is_hit]
            row_l.append((ph & ((1 << shift) - 1)).astype(np.int64))
            fwd_l.append(((ph >> (shift + 2)) & 1).astype(bool))
        g_hit = np.concatenate(g_hit_l)
        row_hit = self._remap_rows(np.concatenate(row_l))
        fwd_hit = np.concatenate(fwd_l)
        g_rep = np.concatenate(g_rep_l)
        return g_hit, row_hit, fwd_hit, g_rep, starts, n_total

    def kmer_freq(self, query_kmers: np.ndarray) -> np.ndarray:
        row, found = self.lookup(query_kmers)
        return np.where(found, self.counts[row], 0)

    def is_repetitive(self, query_kmers: np.ndarray) -> np.ndarray:
        row, found = self.lookup(query_kmers)
        return found & self.repetitive[row]

    def get_postings(self, row: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        s, e = self.offsets[row], self.offsets[row + 1]
        return self.post_seq[s:e], self.post_pos[s:e], self.post_flip[s:e]
