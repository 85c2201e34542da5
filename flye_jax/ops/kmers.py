"""Device kernels for k-mer extraction, hashing, and minimizer selection.

Data-parallel equivalents of the reference's per-base rolling loops
(reference: src/sequence/kmer.h:65-98 appendRight/standardForm/splitmix64,
kmer.h:206-262 monotonic-deque minimizer sweep).  Instead of per-position
scalar updates, whole padded read batches [B, L] are processed with k
shifted adds (memory-bound) and the minimizer sweep becomes a
log-step sliding-window minimum — a data-parallel formulation of the same
selection rule: position p is a window minimum for some window iff its
hash equals the minimum over the (2w-1)-neighborhood of p.

All functions are jit-compatible with static k / w; dtypes are explicit
(int64 for packed k-mers — k <= 31 needs 62 bits, uint64 for hashes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MAX_K = 31
# sentinel hash for invalid positions: max uint64 so they never win a
# window minimum
_INVALID_HASH = np.uint64(0xFFFFFFFFFFFFFFFF)  # np scalar: no backend init at import


@functools.partial(jax.jit, static_argnames=("k",))
def extract_kmers(codes: jax.Array, lengths: jax.Array, k: int):
    """Packed forward and reverse-complement k-mers at every position.

    Args:
      codes: [B, L] uint8 base codes (0..3), zero-padded.
      lengths: [B] int32 true sequence lengths.
      k: k-mer size (static, <= 31).

    Returns:
      fwd:   [B, L] int64, fwd[p] = codes[p..p+k-1] packed 2 bits/base,
             first base in the highest bits (positions p > len-k are junk).
      rc:    [B, L] int64, reverse-complement k-mer at the same window.
      valid: [B, L] bool, True where a complete k-mer starts.
    """
    assert 1 <= k <= MAX_K
    c = codes.astype(jnp.int64)
    B, L = c.shape
    fwd = jnp.zeros((B, L), dtype=jnp.int64)
    rc = jnp.zeros((B, L), dtype=jnp.int64)
    for j in range(k):
        # base at window offset j, i.e. codes shifted left by j positions
        shifted = jnp.roll(c, -j, axis=1) if j else c
        fwd = fwd | (shifted << (2 * (k - 1 - j)))
        rc = rc | ((3 - shifted) << (2 * j))
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    valid = pos <= (lengths[:, None] - k)
    return fwd, rc, valid


@functools.partial(jax.jit, static_argnames=("k",))
def canonical_kmers(codes: jax.Array, lengths: jax.Array, k: int):
    """Canonical (strand-symmetric) k-mers: min(fwd, revcomp).

    Matches the role of the reference's standardForm
    (reference: src/sequence/kmer.h:54-63).

    Returns (canon [B,L] int64, is_fwd [B,L] bool, valid [B,L] bool).
    """
    fwd, rc, valid = extract_kmers(codes, lengths, k)
    is_fwd = fwd <= rc
    canon = jnp.where(is_fwd, fwd, rc)
    return canon, is_fwd, valid


def splitmix64(x: jax.Array) -> jax.Array:
    """SplitMix64 finalizer (the same mixer family the reference uses for
    k-mer hashing, reference: src/sequence/kmer.h:91-98). Input any int
    dtype; output uint64."""
    x = x.astype(jnp.uint64)
    x = (x ^ (x >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
    return x ^ (x >> jnp.uint64(31))


@functools.partial(jax.jit, static_argnames=("k",))
def kmer_hashes(codes: jax.Array, lengths: jax.Array, k: int):
    """Canonical k-mers + their hashes, invalid positions forced to the
    max hash. Returns (canon, hashes, valid)."""
    canon, _, valid = canonical_kmers(codes, lengths, k)
    h = splitmix64(canon)
    h = jnp.where(valid, h, _INVALID_HASH)
    return canon, h, valid


def _sliding_min(h: jax.Array, width: int) -> jax.Array:
    """out[p] = min(h[p .. p+width-1]) along the last axis, out-of-range
    treated as +inf (sparse-table doubling: O(log width) vector mins)."""
    if width <= 1:
        return h
    pad_val = _INVALID_HASH if h.dtype == jnp.uint64 else jnp.iinfo(h.dtype).max

    def shift(x, s):
        # shift left by s, fill tail with pad
        rolled = jnp.roll(x, -s, axis=-1)
        idx = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
        return jnp.where(idx < x.shape[-1] - s, rolled, pad_val)

    # g = min over window of size 2^t
    g = h
    span = 1
    while span * 2 <= width:
        g = jnp.minimum(g, shift(g, span))
        span *= 2
    if span == width:
        return g
    return jnp.minimum(g, shift(g, width - span))


@functools.partial(jax.jit, static_argnames=("w",))
def minimizer_mask(hashes: jax.Array, valid: jax.Array, w: int) -> jax.Array:
    """Select minimizer positions: p is chosen iff its hash attains the
    minimum of some fully-in-bounds length-w window of k-mer positions.

    Equivalent to the reference's deque sweep
    (reference: src/sequence/kmer.h:206-262) modulo tie handling: all
    tied minima are selected here (the deque picks one), which only
    slightly enlarges the index and keeps the rule strand-symmetric.

    Vectorized as: W[s] = min(h[s..s+w-1]) via log-step sliding min, then
    selected(p) = OR over the w windows s = p-w+1..p of
    (window s in bounds) & (W[s] == h[p]).
    """
    if w <= 1:
        return valid
    h = jnp.where(valid, hashes, _INVALID_HASH)
    W = _sliding_min(h, w)
    # window s is fully in bounds iff its last position s+w-1 holds a
    # valid k-mer
    win_ok = jnp.roll(valid, -(w - 1), axis=-1)
    idx = jax.lax.broadcasted_iota(jnp.int32, h.shape, h.ndim - 1)
    win_ok = win_ok & (idx < h.shape[-1] - (w - 1))

    selected = jnp.zeros_like(valid)
    for j in range(w):
        # window starting at s = p - j
        Wj = jnp.roll(W, j, axis=-1)
        okj = jnp.roll(win_ok, j, axis=-1) & (idx >= j)
        selected = selected | (okj & (Wj == h))
    return valid & selected


@functools.partial(jax.jit,
                   static_argnames=("k", "w", "sample", "step"))
def stream_select_packed(chunks: jax.Array, starts: jax.Array,
                         row0: jax.Array, n_total: jax.Array,
                         k: int, w: int, sample: int, step: int
                         ) -> jax.Array:
    """Fused k-mer extraction + canonicalization + minimizer/sample
    selection over a FLAT read stream, packed for a single transfer.

    The padded-per-read layout wastes 3-6x of the device->host transfer
    on padding (reads vary 1-60 kb); here all reads are concatenated
    into one stream and cut into fixed-width overlapping chunks, so the
    transferred bytes equal ~1.0x the true base count.  Read boundaries
    are reconstructed on device from the `starts` offsets — the 2-bit
    stream + offsets is the same representation the reference's
    SequenceContainer uses for its global-position index
    (reference: src/sequence/sequence_container.h:200-235).

    Args:
      chunks: [B, W] uint8; row r holds stream positions
              [(row0+r)*step - (w-1) + i for i in range(W)] of a stream
              left-padded with w-1 junk bases (so row 0 col w-1 is
              stream position 0... in stream coords g = row*step + col
              - (w-1)).
      starts: [R+1] int64 read start offsets in the stream (ascending,
              starts[R] = n_total), padded to a power of two with
              n_total sentinels.
      row0:   int64 global row index of chunks[0].
      n_total: int64 total stream length.
      k, w:   k-mer size / minimizer window (w=1 -> sampling mode).
      sample: keep every sample-th position when w == 1.
      step:   selectable positions per row; must equal
              W - (k-1) - 2*(w-1).

    Returns [B, W] uint64: (canon << 2) | (is_fwd << 1) | 1 at selected
    positions, 0 elsewhere.
    """
    assert 1 <= k <= MAX_K
    B, W = chunks.shape
    c = chunks.astype(jnp.int64)
    fwd = jnp.zeros((B, W), dtype=jnp.int64)
    rc = jnp.zeros((B, W), dtype=jnp.int64)
    for j in range(k):
        shifted = jnp.roll(c, -j, axis=1) if j else c
        fwd = fwd | (shifted << (2 * (k - 1 - j)))
        rc = rc | ((3 - shifted) << (2 * j))
    col = jax.lax.broadcasted_iota(jnp.int64, (B, W), 1)
    row = jax.lax.broadcasted_iota(jnp.int64, (B, W), 0)
    g = (row0 + row) * step + col - (w - 1)

    # a k-mer is valid iff it lies entirely within one read: both its
    # first and last base fall in the same starts[] interval
    rid_a = jnp.searchsorted(starts, g, side="right")
    rid_b = jnp.searchsorted(starts, g + (k - 1), side="right")
    valid = ((g >= 0) & (g + k <= n_total) & (rid_a == rid_b)
             & (col <= W - k))

    is_fwd = fwd <= rc
    canon = jnp.where(is_fwd, fwd, rc)

    if w > 1:
        h = jnp.where(valid, splitmix64(canon), _INVALID_HASH)
        Wmin = _sliding_min(h, w)
        # window s is usable iff its first and last k-mers are valid and
        # belong to the same read (then so do all between)
        def shiftL(x, s, fill):
            rolled = jnp.roll(x, -s, axis=-1)
            return jnp.where(col < W - s, rolled, fill)
        win_ok = (valid & shiftL(valid, w - 1, False)
                  & (rid_a == shiftL(rid_a, w - 1, jnp.int64(-1))))
        selected = jnp.zeros_like(valid)
        for j in range(w):
            Wj = jnp.roll(Wmin, j, axis=-1)
            okj = jnp.roll(win_ok, j, axis=-1) & (col >= j)
            selected = selected | (okj & (Wj == h))
        selected = valid & selected
    elif sample > 1:
        # sample phase restarts at each read start (reference samples
        # every Nth k-mer per read, not per stream)
        read_start = starts[jnp.maximum(rid_a - 1, 0)]
        selected = valid & ((g - read_start) % sample == 0)
    else:
        selected = valid
    # only the interior zone belongs to this row (margins are covered by
    # the neighboring rows)
    selected = selected & (col >= w - 1) & (col < w - 1 + step)

    packed = ((canon.astype(jnp.uint64) << jnp.uint64(2))
              | (is_fwd.astype(jnp.uint64) << jnp.uint64(1))
              | jnp.uint64(1))
    return jnp.where(selected, packed, jnp.uint64(0))


@functools.partial(jax.jit,
                   static_argnames=("k", "W", "step", "sample",
                                    "tandem_freq", "global_min"))
def solid_select_device(packed, starts, idx90, select_rate,
                        k: int, W: int, step: int, sample: int,
                        tandem_freq: int, global_min: int):
    """Device-resident solid-kmer selection: global k-mer counting,
    per-read frequency thresholding, and tandem filtering — all on
    device, returning COMPACTED selected postings.

    This is the device KmerCounter (reference:
    src/sequence/vertex_index.cpp:499-633 — a 4-bit atomic flat counter
    over 4^k cells): counting is a device sort + run-length pass
    (deterministic, no atomics), the per-read threshold is the solid-
    kmer selection of buildIndexUnevenCoverage (vertex_index.cpp:25-125)
    with p90 taken by nearest rank, and only the selected postings ever
    cross the device->host link (the full per-position download was the
    index build's bottleneck).

    Args:
      packed: [N] uint64 from stream_select_packed (w=1 layout:
        canon<<2 | is_fwd<<1 | valid), flattened row-major [rows, W].
      starts: [Rp] int64 read-start offsets (power-of-two padded with
        n_total).
      idx90:  [Rp] int64 gather indices into the (read, freq)-sorted
        valid-position array picking each read's p90 frequency
        (host-computed from read lengths; clamped for empty reads).
      select_rate: f32 scalar (meta_read_top_kmer_rate).

    Returns (pk [N] uint64 compacted packed postings, pg [N] uint32
    compacted stream positions, n_sel int32).
    """
    N = packed.shape[0]
    idx = jnp.arange(N, dtype=jnp.int64)
    col = idx % W
    g = (idx // W) * step + col
    sel0 = ((packed & jnp.uint64(1)) != 0) & (col < step)
    kmer = (packed >> jnp.uint64(2)).astype(jnp.int64)
    INV = jnp.int64(0x7FFFFFFFFFFFFFFF)

    # all grouping runs as sorts + binary-search gathers: run-length
    # and compaction are expressed scatter-free (sort back by original
    # index to "unsort"), deterministic on every backend
    def run_lengths(keys):
        """Per-element run length of equal keys, in original order;
        INV keys get 0."""
        sk, sg = jax.lax.sort((keys, idx), num_keys=1)
        left = jnp.searchsorted(sk, sk, side="left")
        right = jnp.searchsorted(sk, sk, side="right")
        rl = jnp.where(sk != INV, right - left, 0).astype(jnp.int32)
        _, out = jax.lax.sort((sg, rl), num_keys=1)
        return out

    freq = run_lengths(jnp.where(sel0, kmer, INV))

    # searchsorted returns int32; the shifts below need 64-bit room
    rid = (jnp.searchsorted(starts, g, side="right") - 1).astype(
        jnp.int64)
    # per-read p90 by nearest rank over the (read, freq)-sorted array
    key = jnp.where(sel0, (rid << 32) | freq.astype(jnp.int64), INV)
    skey = jax.lax.sort(key)
    p90 = (skey[idx90] & jnp.int64(0xFFFFFFFF)).astype(jnp.float32)
    thr = jnp.maximum(jnp.int32(global_min),
                      jnp.minimum(jnp.int32(4),
                                  (select_rate * p90).astype(jnp.int32)))
    # within-read tandem copies (reference: yieldFrequentKmers'
    # tandem filter, vertex_index.cpp:440-480)
    key2 = jnp.where(sel0, (rid << (2 * k)) | kmer, INV)
    tcount = run_lengths(key2)

    sel = sel0 & (freq >= thr[rid]) & (tcount <= tandem_freq)
    n_sel = jnp.sum(sel.astype(jnp.int64)).astype(jnp.int32)
    # compaction: sort selected entries to the front, original order
    # preserved (key = idx for selected, BIG+idx otherwise)
    ckey = jnp.where(sel, idx, idx + jnp.int64(1) + N)
    _, pk, pg = jax.lax.sort(
        (ckey, packed, g.astype(jnp.uint32)), num_keys=1)
    return pk, pg, n_sel


@functools.partial(jax.jit, static_argnames=("k", "step", "narrow"))
def stream_probe_packed(chunks: jax.Array, starts: jax.Array,
                        row0: jax.Array, n_total: jax.Array,
                        uniq: jax.Array, repet: jax.Array,
                        rmax: jax.Array, k: int, step: int,
                        narrow: bool) -> jax.Array:
    """Fused canonicalize + index probe over a FLAT query stream.

    The stream layout (reads concatenated, fixed-width rows overlapping
    by k-1) cuts the transferred bytes to ~1.0x the true base count —
    the per-read padded probe wasted 3-6x on padding through the
    device->host link.  Packing mirrors _probe_device
    (flye_jax/index/kmer_index.py): one integer per position carrying
    (index row, hit, repetitive, is_fwd).

    chunks [B, W] uint8; starts [R+1] int64 read offsets (power-of-two
    padded with n_total); step = W - (k - 1).
    """
    assert 1 <= k <= MAX_K
    B, W = chunks.shape
    c = chunks.astype(jnp.int64)
    fwd = jnp.zeros((B, W), dtype=jnp.int64)
    rc = jnp.zeros((B, W), dtype=jnp.int64)
    for j in range(k):
        shifted = jnp.roll(c, -j, axis=1) if j else c
        fwd = fwd | (shifted << (2 * (k - 1 - j)))
        rc = rc | ((3 - shifted) << (2 * j))
    col = jax.lax.broadcasted_iota(jnp.int64, (B, W), 1)
    row = jax.lax.broadcasted_iota(jnp.int64, (B, W), 0)
    g = (row0 + row) * step + col
    rid_a = jnp.searchsorted(starts, g, side="right")
    rid_b = jnp.searchsorted(starts, g + (k - 1), side="right")
    valid = ((g + k <= n_total) & (rid_a == rid_b)
             & (col < step))

    is_fwd = fwd <= rc
    canon = jnp.where(is_fwd, fwd, rc)
    flat = canon.reshape(-1)
    r = jnp.clip(jnp.searchsorted(uniq, flat), 0, rmax)
    found = (uniq[r] == flat).reshape(B, W) & valid
    rep = repet[r].reshape(B, W) & found
    hit = found & ~rep
    if narrow:
        return (r.astype(jnp.int32).reshape(B, W)
                | (hit.astype(jnp.int32) << 28)
                | (rep.astype(jnp.int32) << 29)
                | (is_fwd.astype(jnp.int32) << 30))
    return (r.astype(jnp.int64).reshape(B, W)
            | (hit.astype(jnp.int64) << 32)
            | (rep.astype(jnp.int64) << 33)
            | (is_fwd.astype(jnp.int64) << 34))


@functools.partial(jax.jit, static_argnames=("sample",))
def sample_mask(valid: jax.Array, sample: int) -> jax.Array:
    """Every `sample`-th position (the reference's k-mer sampling,
    reference: asm_*.cfg assemble_kmer_sample)."""
    if sample <= 1:
        return valid
    idx = jax.lax.broadcasted_iota(jnp.int32, valid.shape, valid.ndim - 1)
    return valid & (idx % sample == 0)
