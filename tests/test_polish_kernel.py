import numpy as np
import pytest

from flye_jax.ops.polish import polish_bubbles
from flye_jax.polishing.matrices import get_subs_matrix

SUBS = get_subs_matrix("pacbio").astype(np.float64)


def nw_score(a, b):
    """Max-score NW with the subs matrix (reference:
    src/polishing/alignment.cpp:151-190 getScoringMatrix)."""
    n, m = len(a), len(b)
    D = np.zeros((n + 1, m + 1))
    for i in range(1, n + 1):
        D[i, 0] = D[i - 1, 0] + SUBS[a[i - 1], 4]
    for j in range(1, m + 1):
        D[0, j] = D[0, j - 1] + SUBS[4, b[j - 1]]
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            D[i, j] = max(D[i - 1, j - 1] + SUBS[a[i - 1], b[j - 1]],
                          D[i - 1, j] + SUBS[a[i - 1], 4],
                          D[i, j - 1] + SUBS[4, b[j - 1]])
    return D[n, m]


def total_score(cand, branches):
    return sum(nw_score(cand, b) for b in branches)


def oracle_polish(cand, branches, max_iters=200):
    """Reference makeStep semantics by brute force re-scoring
    (reference: general_polisher.cpp:59-125)."""
    cand = list(cand)
    for _ in range(max_iters):
        cur = total_score(cand, branches)
        best, best_seq = cur, None
        # deletions
        for p in range(len(cand)):
            s = total_score(cand[:p] + cand[p + 1:], branches)
            if s > best:
                best, best_seq = s, cand[:p] + cand[p + 1:]
        if best_seq is None:
            # insertions
            for p in range(len(cand) + 1):
                for x in range(4):
                    s = total_score(cand[:p] + [x] + cand[p:], branches)
                    if s > best:
                        best, best_seq = s, cand[:p] + [x] + cand[p:]
        if best_seq is None:
            # substitutions
            for p in range(len(cand)):
                for x in range(4):
                    if x == cand[p]:
                        continue
                    s = total_score(cand[:p] + [x] + cand[p + 1:], branches)
                    if s > best:
                        best, best_seq = s, cand[:p] + [x] + cand[p + 1:]
        if best_seq is None:
            return cand
        cand = best_seq
    return cand


def run_kernel(cands, branch_lists, Cb=32, S=32, R=8, steepest=True):
    B = len(cands)
    cand = np.zeros((B, Cb), np.uint8)
    clen = np.zeros(B, np.int32)
    branches = np.zeros((B, R, S), np.uint8)
    blen = np.zeros((B, R), np.int32)
    bmask = np.zeros((B, R), bool)
    for i, (c, bl) in enumerate(zip(cands, branch_lists)):
        cand[i, :len(c)] = c
        clen[i] = len(c)
        for r, b in enumerate(bl):
            branches[i, r, :len(b)] = b
            blen[i, r] = len(b)
            bmask[i, r] = True
    out_c, out_l, score, iters = (np.asarray(x) for x in polish_bubbles(
        cand, clen, branches, blen, bmask,
        get_subs_matrix("pacbio"), max_iters=64, steepest=steepest))
    return [list(out_c[i][:out_l[i]]) for i in range(B)], iters


def mutate(rng, seq, n_ops):
    s = list(seq)
    for _ in range(n_ops):
        kind = rng.integers(0, 3)
        p = int(rng.integers(0, len(s)))
        if kind == 0:
            s[p] = (s[p] + int(rng.integers(1, 4))) % 4
        elif kind == 1 and len(s) > 2:
            del s[p]
        else:
            s.insert(p, int(rng.integers(0, 4)))
    return s


def test_polish_identical_branches_noop(rng):
    # candidate == all branches: no edits
    true = list(rng.integers(0, 4, size=16))
    out, iters = run_kernel([true], [[true] * 4])
    assert out[0] == true
    assert iters[0] <= 1


def test_polish_fixes_substitution(rng):
    true = list(rng.integers(0, 4, size=16))
    cand = list(true)
    cand[7] = (cand[7] + 1) % 4
    out, _ = run_kernel([cand], [[true] * 5])
    assert out[0] == true


def test_polish_fixes_indels(rng):
    true = list(rng.integers(0, 4, size=18))
    cand_del = true[:6] + true[7:]          # missing base -> insertion fix
    cand_ins = true[:6] + [2] + true[6:]    # extra base -> deletion fix
    out, _ = run_kernel([cand_del, cand_ins], [[true] * 5, [true] * 5])
    assert out[0] == true
    assert out[1] == true


def test_polish_vs_oracle(rng):
    # random small bubbles: kernel must reach the same final sequence as
    # the reference-semantics oracle
    cases = []
    for i in range(6):
        true = list(rng.integers(0, 4, size=int(rng.integers(10, 16))))
        cand = mutate(rng, true, 2)
        branches = [mutate(rng, true, 1) for _ in range(4)]
        cases.append((cand, branches, true))
    outs, _ = run_kernel([c for c, _, _ in cases],
                         [b for _, b, _ in cases], steepest=False)
    for (cand, branches, true), out in zip(cases, outs):
        expect = oracle_polish(cand, branches)
        assert out == expect, (cand, branches)


def test_polish_noisy_consensus(rng):
    # 10 noisy branches at ~8% error: polished candidate should recover
    # the true sequence
    true = list(rng.integers(0, 4, size=24))
    branches = [mutate(rng, true, 2) for _ in range(10)]
    cand = mutate(rng, true, 3)
    out, _ = run_kernel([cand], [branches], Cb=40, S=40, R=12)
    errs = sum(1 for a, b in zip(out[0], true) if a != b) + \
        abs(len(out[0]) - len(true))
    assert errs <= 1, (out[0], true)


def test_branch_group_scoring_equivalence():
    """Scores from branches split into groups of 8 (separate lanes)
    reduce to exactly the ungrouped scores: sums of per-branch maxima
    decompose over groups; the 4-char argmax happens after the
    reduction (ops/polish._finish_scores)."""
    import jax.numpy as jnp
    from flye_jax.ops.polish import (_finish_scores, _score_edits_jnp,
                                     _score_edits_raw_jnp)
    rng = np.random.default_rng(11)
    B, Cb, R, S = 3, 20, 20, 30
    cand = rng.integers(0, 4, (B, Cb)).astype(np.uint8)
    clen = rng.integers(10, Cb + 1, B).astype(np.int32)
    branches = rng.integers(0, 4, (B, R, S)).astype(np.uint8)
    blen = rng.integers(8, S + 1, (B, R)).astype(np.int32)
    bmask = rng.random((B, R)) < 0.8
    bmask[:, 0] = True
    subs = np.log(rng.random((5, 5)) * 0.5 + 0.01).astype(np.float32)

    ref = _score_edits_jnp(jnp.asarray(cand), jnp.asarray(clen),
                           jnp.asarray(branches), jnp.asarray(blen),
                           jnp.asarray(bmask), jnp.asarray(subs))

    g = -(-R // 8)
    pad_r = g * 8 - R
    br_g = np.pad(branches, ((0, 0), (0, pad_r), (0, 0)))
    bl_g = np.pad(blen, ((0, 0), (0, pad_r)))
    bm_g = np.pad(bmask, ((0, 0), (0, pad_r)))
    raw = _score_edits_raw_jnp(
        jnp.repeat(jnp.asarray(cand), g, axis=0),
        jnp.repeat(jnp.asarray(clen), g, axis=0),
        jnp.asarray(br_g.reshape(B * g, 8, S)),
        jnp.asarray(bl_g.reshape(B * g, 8)),
        jnp.asarray(bm_g.reshape(B * g, 8)),
        jnp.asarray(subs))
    out = _finish_scores(jnp.asarray(cand), jnp.asarray(clen), *raw,
                         groups=g)
    names = ["total", "del", "ins", "ins_chr", "sub", "sub_chr"]
    for name, r, o in zip(names, ref, out):
        r, o = np.asarray(r), np.asarray(o)
        if name.endswith("chr"):
            np.testing.assert_array_equal(r, o, err_msg=name)
        else:
            finite = r > -1e29
            assert np.array_equal(finite, o > -1e29), name
            diff = np.abs(np.where(finite, r - o, 0)).max()
            assert diff < 1e-3, (name, diff)


def test_polish_bubbles_many_branches():
    """polish_bubbles with >8 branches (grouped lanes) still converges
    to the true sequence."""
    rng = np.random.default_rng(13)
    B, C, Cb, R, S = 3, 30, 40, 20, 60
    true = rng.integers(0, 4, (B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    for i in range(B):
        idx = rng.integers(0, C, 3)
        cand[i, idx] = (cand[i, idx] + 1) % 4
    clen = np.full(B, C, np.int32)
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :C] = true[:, None, :]
    blen = np.full((B, R), C, np.int32)
    bmask = np.ones((B, R), bool)
    subs = np.log(np.full((5, 5), 0.05, np.float32))
    np.fill_diagonal(subs[:4, :4], np.log(0.8))
    from flye_jax.ops.polish import polish_bubbles
    out_c, out_l, _, _ = polish_bubbles(cand, clen, branches, blen,
                                        bmask, subs, max_iters=24,
                                        route="stepped")
    for i in range(B):
        n = int(out_l[i])
        assert n == C
        np.testing.assert_array_equal(np.asarray(out_c[i][:n]), true[i])
