"""Long-read simulator and truth checks for tests and benchmarks.

The reference ships real PacBio read sets for its toy E2E test
(reference: flye/tests/test_toy.py:21-32); those blobs are not available
here, so tests synthesize reads from the bundled E. coli 500kb reference
sequence with a configurable error profile (insertion-dominated, matching
PacBio CLR / ONT characteristics).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from flye_jax.io.fasta import COMPLEMENT


def simulate_reads(
    genome: np.ndarray,
    coverage: float = 30.0,
    mean_length: int = 8000,
    min_length: int = 1000,
    error_rate: float = 0.08,
    error_mix: Tuple[float, float, float] = (0.2, 0.5, 0.3),  # sub, ins, del
    circular: bool = True,
    seed: int = 0,
    chimera_rate: float = 0.0,
    adapter_rate: float = 0.0,
    dropout: Optional[Tuple[int, int]] = None,
) -> List[Tuple[str, np.ndarray]]:
    """Sample error-laden reads from a genome (uint8 codes).

    Lengths ~ gamma with the given mean; start positions uniform; strand
    uniform. For circular genomes reads may wrap the origin.

    Adversarial artifacts (off by default; the failure modes the
    chimera detector and bad-mapping trimming exist for — reference:
    src/assemble/chimera.cpp:106-180):
      chimera_rate: fraction of reads fused from two DISTAL genome
        fragments (random strand each) — one artifactual junction per
        chimeric read.
      adapter_rate: fraction of reads with a ~45 bp random adapter
        sequence spliced at a random interior position.
      dropout: (start, end) genome interval that reads never start in
        and never cross beyond min_length into — a coverage hole.
    """
    rng = np.random.default_rng(seed)
    glen = len(genome)
    target = int(coverage * glen)
    reads = []
    total = 0
    i = 0
    sub_p, ins_p, del_p = error_mix
    genome2 = np.concatenate([genome] * 3) if circular else genome
    adapter = rng.integers(0, 4, size=45).astype(np.uint8)

    def sample_fragment(length):
        for _ in range(64):
            start = int(rng.integers(
                0, glen if circular else max(1, glen - length)))
            if dropout is not None:
                d0, d1 = dropout
                end = start + length
                ivals = [(start, min(end, glen))]
                if circular and end > glen:
                    ivals.append((0, end - glen))
                if any(s < d1 and e > d0 for s, e in ivals):
                    continue  # read would touch the coverage hole
            return start, genome2[start:start + length].copy()
        return 0, genome2[0:length].copy()

    while total < target:
        length = int(rng.gamma(4.0, mean_length / 4.0))
        # circular genomes may be read around the origin (up to ~2 circles)
        cap = 2 * glen if circular else glen
        length = max(min_length, min(length, cap))
        start, frag = sample_fragment(length)
        strand = "+"
        if rng.random() < 0.5:
            frag = COMPLEMENT[frag[::-1]]
            strand = "-"
        tag = ""
        if chimera_rate > 0 and rng.random() < chimera_rate:
            # fuse a second, distal fragment: an artifactual junction
            length2 = max(min_length,
                          min(int(rng.gamma(4.0, mean_length / 4.0)),
                              cap))
            _, frag2 = sample_fragment(length2)
            if rng.random() < 0.5:
                frag2 = COMPLEMENT[frag2[::-1]]
            frag = np.concatenate([frag, frag2])
            tag = "_chimera"
        if adapter_rate > 0 and rng.random() < adapter_rate:
            at = int(rng.integers(0, len(frag) + 1))
            frag = np.concatenate([frag[:at], adapter, frag[at:]])
            tag += "_adapter"
        read = _apply_errors(frag, error_rate, sub_p, ins_p, del_p, rng)
        # the name encodes the true placement for tests:
        # sim_<i>_pos<genome start>_len<fragment len><strand>
        reads.append((f"sim_{i}_pos{start}_len{length}{strand}{tag}",
                      read))
        total += len(read)
        i += 1
    return reads


def _apply_errors(seq, error_rate, sub_p, ins_p, del_p, rng):
    n = len(seq)
    if error_rate <= 0 or n == 0:
        return seq
    n_err = rng.poisson(error_rate * n)
    if n_err == 0:
        return seq
    pos = np.sort(rng.integers(0, n, size=n_err))
    kinds = rng.choice(3, size=n_err, p=[sub_p, ins_p, del_p])
    out = []
    prev = 0
    for p, kind in zip(pos, kinds):
        out.append(seq[prev:p])
        if kind == 0:  # substitution
            out.append(np.array([(seq[p] + rng.integers(1, 4)) % 4],
                                dtype=np.uint8))
            prev = p + 1
        elif kind == 1:  # insertion (homopolymer-biased: dup current base)
            base = seq[p] if rng.random() < 0.5 else rng.integers(0, 4)
            out.append(np.array([base], dtype=np.uint8))
            prev = p
        else:  # deletion
            prev = p + 1
    out.append(seq[prev:])
    return np.concatenate(out)


def random_genome(length: int, seed: int = 1,
                  repeat_spec: Optional[List[Tuple[int, int]]] = None
                  ) -> np.ndarray:
    """Uniform random genome; optionally paste (repeat_len, n_copies)
    repeats at random positions to exercise the repeat graph."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=length, dtype=np.int64).astype(np.uint8)
    if repeat_spec:
        for rep_len, copies in repeat_spec:
            unit = rng.integers(0, 4, size=rep_len).astype(np.uint8)
            for _ in range(copies):
                at = int(rng.integers(0, length - rep_len))
                g[at:at + rep_len] = unit
    return g


# read technology -> (error_rate, (sub, ins, del) mix)
READ_PROFILES = {
    "pacbio-raw": (0.08, (0.2, 0.5, 0.3)),
    "nano-raw": (0.10, (0.35, 0.25, 0.40)),
    "pacbio-hifi": (0.005, (0.4, 0.3, 0.3)),
}


def isolate_deployment(genome_len: int, coverage: float,
                       mode: str = "pacbio-raw"):
    """The seeded bacterial-isolate deployment: a random genome with
    planted 5 kb x3 and 2 kb x4 repeats (seed 11) and reads of mean
    length 8 kb in the given technology's error profile (seed 7).
    Returns (genome codes, reads)."""
    err, mix = READ_PROFILES[mode]
    genome = random_genome(genome_len, seed=11,
                           repeat_spec=[(5000, 3), (2000, 4)])
    reads = simulate_reads(genome, coverage=coverage, mean_length=8000,
                           error_rate=err, error_mix=mix, seed=7)
    return genome, reads


def write_reads(reads, path: str) -> None:
    """Write a read set as FASTA, atomically (a killed run never leaves
    a truncated file under the final name)."""
    import os

    from flye_jax.io.fasta import write_fasta
    tmp = f"{path}.tmp{os.getpid()}"
    write_fasta(reads, tmp)
    os.replace(tmp, path)


def window_identity(contigs, genome, n_windows=400, win=2000, seed=0,
                    k=32):
    """Sample windows from the contigs, anchor each to the truth genome
    by an exact k-mer, and edit-distance the window against the anchored
    truth slice.

    Anchoring tries several k-mer offsets within the window (an assembly
    error in the first k-mer must not silently skip a window), considers
    every genome occurrence of a repeated anchor k-mer (taking the best
    identity), and skips occurrences whose truth slice would clip at the
    genome ends.  Returns (mean_identity, n_anchored, n_sampled)."""
    from flye_jax.ops.align import edit_distance_batch

    # truth k-mer -> all occurrence positions (forward strand)
    occ = {}
    for pos, km in enumerate(_pack_kmers(genome, k)):
        occ.setdefault(int(km), []).append(pos)

    rng = np.random.default_rng(seed)
    rows_a, rows_b, lens_a, lens_b, groups = [], [], [], [], []
    n_sampled = 0
    pad = win // 5
    S = 1
    while S < win + 2 * pad + 1:
        S <<= 1
    total = sum(len(s) for _, s in contigs)
    if total == 0:
        return 0.0, 0, 0
    for name, seq in contigs:
        if len(seq) < win + k:
            continue
        per = max(1, int(n_windows * len(seq) / total))
        for _ in range(per):
            st = int(rng.integers(0, len(seq) - win))
            w = seq[st:st + win]
            wr = COMPLEMENT[w[::-1]]
            n_sampled += 1
            gid = n_sampled - 1
            anchored = False
            for off in (0, win // 4, win // 2):
                for cand in (w, wr):
                    km = 0
                    for i in range(k):
                        km = (km << 2) | int(cand[off + i])
                    for tpos in occ.get(km, ())[:4]:
                        w0 = tpos - off  # window start on the genome
                        if w0 - pad < 0 or w0 + win + pad > len(genome):
                            continue
                        tslice = genome[w0 - pad:w0 + win + pad]
                        ra = np.zeros(S, np.uint8)
                        rb = np.zeros(S, np.uint8)
                        ra[:win] = cand
                        rb[:len(tslice)] = tslice
                        rows_a.append(ra)
                        rows_b.append(rb)
                        lens_a.append(win)
                        lens_b.append(len(tslice))
                        groups.append(gid)
                        anchored = True
                    if anchored:
                        break
                if anchored:
                    break
    if not rows_a:
        return 0.0, 0, n_sampled
    d = np.asarray(edit_distance_batch(
        np.stack(rows_a), np.array(lens_a, np.int32),
        np.stack(rows_b), np.array(lens_b, np.int32)))
    # the truth slice is longer by up to 2*pad; subtract the slack so a
    # perfect window scores ~1.0
    slack = np.array(lens_b) - np.array(lens_a)
    ident = 1.0 - np.maximum(d - slack, 0) / np.array(lens_a)
    # repeated anchors: best identity among a window's occurrences
    groups = np.asarray(groups)
    best = {}
    for g, v in zip(groups, ident):
        if v > best.get(g, -1.0):
            best[g] = v
    vals = np.asarray(list(best.values()))
    return float(vals.mean()), len(best), n_sampled


def _pack_kmers(seq: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros(max(0, len(seq) - k + 1), np.uint64)
    for i in range(k):
        out = (out << np.uint64(2)) | seq[i:i + len(out)].astype(np.uint64)
    return out


def genome_coverage(contigs, genome, k: int = 21,
                    max_gap: int = 200) -> float:
    """Fraction of the truth genome the contigs cover: genome k-mers
    found in the contigs (either strand) mark covered positions, and
    runs of unfound positions no longer than max_gap (what a scattered
    base error removes) count as covered too."""
    from flye_jax.io.fasta import COMPLEMENT
    asm = [_pack_kmers(s, k) for _, s in contigs if len(s) >= k]
    asm += [_pack_kmers(COMPLEMENT[s[::-1]], k)
            for _, s in contigs if len(s) >= k]
    if not asm:
        return 0.0
    found = np.isin(_pack_kmers(genome, k), np.concatenate(asm))
    pos = np.flatnonzero(found)
    if not len(pos):
        return 0.0
    covered = np.zeros(len(genome) + 1, np.int32)
    # each found k-mer covers [p, p + k); short gaps between found
    # k-mers are bridged
    gaps = np.diff(pos)
    starts = np.concatenate([[pos[0]], pos[1:][gaps > max_gap]])
    ends = np.concatenate([pos[:-1][gaps > max_gap], [pos[-1]]]) + k
    np.add.at(covered, starts, 1)
    np.add.at(covered, np.minimum(ends, len(genome)), -1)
    return float((np.cumsum(covered)[:len(genome)] > 0).mean())
