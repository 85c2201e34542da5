"""Exact whole-assembly error count vs a truth genome.

Chains exact unique 32-mer anchors between each assembly contig and the
truth sequence, then banded-edit-distances every inter-anchor segment —
so the reported number is the TOTAL edit distance over the anchored
span, not a window sample.  Used for the 420 kb parity set where the
reference's residual is ~12 errors (window identity can't resolve that
last digit).

Usage: python scripts/exact_errors.py TRUTH.fasta ASSEMBLY.fasta
Prints per-contig: anchored span, body errors, and the unanchored
head/tail lengths (reported separately — coverage-taper territory).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

K = 32


def _kmer_pack(codes, k=K):
    if len(codes) < k:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    base = np.uint64(4)
    vals = np.zeros(len(codes) - k + 1, np.uint64)
    acc = np.uint64(0)
    mult = base ** np.uint64(k - 1)
    # vectorized rolling pack
    c = codes.astype(np.uint64)
    acc_arr = np.zeros(len(codes) - k + 1, np.uint64)
    v = np.uint64(0)
    for i in range(k):
        v = v * base + c[i]
    acc_arr[0] = v
    if len(acc_arr) > 1:
        # rolling: v' = (v - c[i]*mult)*4 + c[i+k]
        vs = np.empty(len(acc_arr), np.uint64)
        vs[0] = v
        drop = c[: len(acc_arr) - 1] * mult
        add = c[k:]
        cur = v
        for i in range(1, len(acc_arr)):
            cur = (cur - drop[i - 1]) * base + add[i - 1]
            vs[i] = cur
        acc_arr = vs
    return acc_arr, np.arange(len(acc_arr), dtype=np.int64)


def _unique_map(vals, pos):
    order = np.argsort(vals, kind="stable")
    sv, sp = vals[order], pos[order]
    keep = np.ones(len(sv), bool)
    dup = sv[1:] == sv[:-1]
    keep[1:][dup] = False
    keep[:-1][dup] = False
    return sv[keep], sp[keep]


def edit_dist(a, b):
    """Plain DP edit distance (numpy rows)."""
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    prev = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = np.empty(len(b) + 1, np.int64)
        cur[0] = i
        sub = prev[:-1] + (b != a[i - 1])
        # cur[j] = min(prev[j]+1, cur[j-1]+1, sub[j-1]) — need scan for
        # the left-dependency; do two-pass: first min(prev+1, sub), then
        # prefix-min with +1 slope via np.minimum.accumulate trick
        cand = np.minimum(prev[1:] + 1, sub)
        cur[1:] = cand
        cur = np.minimum.accumulate(
            cur - np.arange(len(b) + 1)) + np.arange(len(b) + 1)
        prev = cur
    return int(prev[-1])


def contig_errors(ctg, truth):
    from flye_jax.io.fasta import reverse_complement

    tv, tp = _unique_map(*_kmer_pack(truth))
    best = None
    for strand, seq in (("+", ctg), ("-", reverse_complement(ctg))):
        cv, cp = _unique_map(*_kmer_pack(seq))
        idx = np.searchsorted(tv, cv)
        idx = np.clip(idx, 0, len(tv) - 1)
        hit = tv[idx] == cv
        if best is None or hit.sum() > best[0]:
            best = (int(hit.sum()), strand, seq, cp[hit], tp[idx[hit]])
    n_hit, strand, seq, apos, tpos = best
    if n_hit == 0:
        return dict(strand=strand, anchors=0)
    order = np.argsort(apos)
    apos, tpos = apos[order], tpos[order]
    # longest increasing (colinear) chain on tpos, greedy with diagonal
    # consistency — anchors are unique-in-both so a simple monotone
    # filter suffices
    keep_a, keep_t = [apos[0]], [tpos[0]]
    for a, t in zip(apos[1:], tpos[1:]):
        if t > keep_t[-1] and a > keep_a[-1] and \
                abs((a - keep_a[-1]) - (t - keep_t[-1])) < 5000:
            keep_a.append(a)
            keep_t.append(t)
    apos = np.asarray(keep_a)
    tpos = np.asarray(keep_t)
    errs = 0
    for i in range(len(apos) - 1):
        a0, a1 = apos[i] + K, apos[i + 1]
        t0, t1 = tpos[i] + K, tpos[i + 1]
        if a1 < a0 or t1 < t0:
            continue
        if a1 - a0 == t1 - t0 and np.array_equal(seq[a0:a1],
                                                 truth[t0:t1]):
            continue
        errs += edit_dist(seq[a0:a1], truth[t0:t1])
    head_a, head_t = int(apos[0]), int(tpos[0])
    tail_a = len(seq) - int(apos[-1]) - K
    tail_t = len(truth) - int(tpos[-1]) - K
    head_err = edit_dist(seq[:head_a], truth[max(0, head_t - head_a - 50):head_t]) \
        if head_a else 0
    tail_err = edit_dist(seq[len(seq) - tail_a:],
                         truth[len(truth) - tail_t:
                               min(len(truth), len(truth) - tail_t + tail_a + 50)]) \
        if tail_a else 0
    return dict(strand=strand, anchors=len(apos), body_errors=int(errs),
                span=(int(apos[0]), int(apos[-1]) + K),
                truth_span=(int(tpos[0]), int(tpos[-1]) + K),
                head=(head_a, head_err), tail=(tail_a, tail_err))


def main():
    from flye_jax.io.fasta import read_seq_file

    truth = read_seq_file(sys.argv[1])[0][1]
    total_body = 0
    for name, ctg in read_seq_file(sys.argv[2]):
        r = contig_errors(ctg, truth)
        if r.get("anchors", 0) == 0:
            print(f"{name}: NO ANCHORS ({len(ctg)} bp)")
            continue
        total_body += r["body_errors"]
        print(f"{name}: {len(ctg)} bp strand {r['strand']} "
              f"anchors {r['anchors']} span {r['span']} "
              f"body_errors {r['body_errors']} "
              f"head {r['head'][0]} bp ({r['head'][1]} err) "
              f"tail {r['tail'][0]} bp ({r['tail'][1]} err)")
    print(f"TOTAL body errors: {total_body}")


if __name__ == "__main__":
    main()
