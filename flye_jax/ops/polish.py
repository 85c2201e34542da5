"""Batched bubble-polishing kernel — the flagship device kernel.

Behavioral port of GeneralPolisher's single-edit hill climbing
(reference: src/polishing/general_polisher.cpp:8-125,
src/polishing/alignment.cpp:17-190) redesigned as batched device work:

The reference scores one candidate edit at a time with an O(row) loop
over cached forward/reverse DP matrices, per thread, per bubble.  Here
thousands of bubbles run in lockstep: two lax.scans compute the full
prefix (F) and suffix (B) score tensors [C+1, batch, R, S+1] — the
suffix matrix directly via a reverse-order scan, so no per-lane tensor
flips — and then EVERY deletion / insertion / substitution at every
position scores simultaneously as dense tensor algebra:

    del(p)    = max_j F[p]    + B[p+1]
    ins(p, x) = max_j SUBx[p] + B[p]
    sub(p, x) = max_j SUBx[p] + B[p+1]
    SUBx[p][j] = max(F[p][j-1] + M[x, w_j], F[p][j] + M[x, '-'])

Substitution-matrix lookups are exact gathers from the 5x5 table; the
in-row DP dependency resolves via associative prefix/suffix-max scans.
This jnp formulation is the reference scorer: on a GPU the convergence
loop runs the Triton kernel of ops/polish_triton.py, on the CPU the
native climber (ops/routes.py).

Edits in different parity-active blocks (>= block_size apart, NW deltas
effectively independent) apply simultaneously, converging in
~2x(max edits per block) iterations; block precedence follows the
reference (del > ins > sub, earliest position on ties). block_size=0
restores the strictly serial reference semantics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from flye_jax.ops import routes

NEG = np.float32(-1e30)  # np scalar: no backend init at import


def _branch_tables(branches, blen, subs):
    """Per-branch tables, constant across hill-climb iterations:
    sw [4,B,R,S] = subs[x, branch[j]] match costs, gp [B,R,S+1] = cost
    of inserting branch[0:j], sg [B,R,S+1] = cost of inserting
    branch[j:blen].  Exact gathers from the 5x5 table (a one-hot
    contraction could run in reduced precision on a GPU)."""
    subs = subs.astype(jnp.float32)
    br = branches.astype(jnp.int32)
    Bb, R, S = br.shape
    sw = subs[:4, :4][:, br]                                 # [4,B,R,S]
    gap_b = subs[4, :4][br]                                  # [B,R,S]
    jpos_s = jax.lax.broadcasted_iota(jnp.int32, (Bb, R, S), 2)
    gap_bm = jnp.where(jpos_s < blen[:, :, None], gap_b, 0.0)
    gp = jnp.concatenate(
        [jnp.zeros((Bb, R, 1), jnp.float32),
         jnp.cumsum(gap_bm, axis=2)], axis=2)
    sg = gp[:, :, -1:] - gp
    return sw, gp, sg


def _score_edits_raw_jnp(cand, cand_len, branches, blen, bmask, subs):
    """Raw per-character edit scores against all branches — the
    pure-jnp formulation (two lax.scans materializing full F/B
    tensors), and the reference every other scorer is checked against.

    Returns (total [B], del_raw [Cb,B], ins4 [4,Cb+1,B],
    sub4 [4,Cb,B]) WITHOUT the position-validity or cand!=x masks —
    those are per-lane and applied by _finish_scores, after the
    branch-group reduction (see polish_bubbles): scores are sums of
    per-branch maxima, so groups of branches scored in separate lanes
    sum exactly, but only BEFORE the 4-character argmax."""
    sw, gp, sg = _branch_tables(branches, blen, subs)
    Bb, Cb = cand.shape
    _, _, R, S = sw.shape
    subs = subs.astype(jnp.float32)
    bmaskf = bmask.astype(jnp.float32)
    jpos_s = jax.lax.broadcasted_iota(jnp.int32, (Bb, R, S), 2)
    jpos1 = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, S + 1), 3)
    jmask = jnp.where(jpos1 <= blen[None, :, :, None], 0.0, NEG)
    ivec_bc = jax.lax.broadcasted_iota(jnp.int32, (Bb, Cb), 1)

    def masked_reduce(x, b_shifted):
        """max over j then masked sum over branches: x [C*, B, R, S+1]."""
        s = jnp.max(x + b_shifted + jmask, axis=3)          # [C*, B, R]
        return jnp.sum(s * bmaskf[None], axis=2)            # [C*, B]

    cand_i = cand.astype(jnp.int32)

    def row_match(x):
        """Match plane of one DP row: sw[x[b], b] for candidate codes
        x [B], gathered per row (a [Cb,B,R,S] tensor of all rows would
        be the scorer's largest temporary)."""
        return jnp.take_along_axis(sw, x[None, :, None, None], axis=0)[0]

    def forward_rows(cand_cols, vgap_cols):
        """F[i] rows via forward scan. cand_cols [Cb,B] candidate codes,
        vgap_cols [Cb,B]. Returns [Cb+1,B,R,S+1]."""
        row0 = gp

        def step(prev, xs):
            cx, vg = xs
            match = row_match(cx)                            # [B,R,S]
            vgap = vg[:, None, None]
            tmp = jnp.concatenate(
                [prev[:, :, :1] + vgap,
                 jnp.maximum(prev[:, :, :-1] + match,
                             prev[:, :, 1:] + vgap)], axis=2)
            # row[j] = max(tmp[j], row[j-1] + gap_b[j]):
            # prefix-max of (tmp - gp) plus gp
            row = jax.lax.associative_scan(
                jnp.maximum, tmp - gp, axis=2) + gp
            return row, row

        _, rows = jax.lax.scan(step, row0, (cand_cols, vgap_cols))
        return jnp.concatenate([row0[None], rows], axis=0)

    def backward_rows(cand_cols, vgap_cols, ds_cols, row_idx):
        """B[i][j] = best score of cand[i:clen] vs branch[j:blen], via a
        reverse scan — no per-lane flips. ds_cols [Cb,B] = candidate
        suffix deletion cost per row; row_idx [Cb] row numbers.
        Returns [Cb+1,B,R,S+1]."""
        # base row at i >= clen: insert the whole branch suffix
        # (sg[j>=blen] is already 0 because padded gap costs are masked)
        base_row = sg

        def step(nxt, xs):
            cx, vg, dsi, i = xs
            match = row_match(cx)
            vgap = vg[:, None, None]
            # tmp[j] = max(B[i+1][j+1] + M(v,w_j), B[i+1][j] + M(v,'-'))
            diag = jnp.where(jpos_s < blen[:, :, None],
                             nxt[:, :, 1:] + match, NEG)
            tmp = jnp.concatenate(
                [jnp.maximum(diag, nxt[:, :, :-1] + vgap),
                 nxt[:, :, -1:] + vgap], axis=2)
            tmp = jnp.where(jpos1[0] <= blen[:, :, None], tmp, NEG)
            # row[j] = max(tmp[j], row[j+1] + gap_b[j]):
            # row = sg + suffix-max(tmp - sg)
            row = jax.lax.associative_scan(
                jnp.maximum, tmp - sg, axis=2, reverse=True) + sg
            # lanes where this row is out of range keep the base row;
            # columns beyond blen carry the cand-suffix deletion cost
            in_range = (i < cand_len)[:, None, None]
            row = jnp.where(in_range, row, base_row)
            row = jnp.where(jpos1[0] <= blen[:, :, None], row,
                            dsi[:, None, None])
            return row, row

        _, rows = jax.lax.scan(
            step, base_row,
            (cand_cols, vgap_cols, ds_cols, row_idx), reverse=True)
        # rows[i] = B[i] for i in 0..Cb-1; append B[Cb] = base
        return jnp.concatenate([rows, base_row[None]], axis=0)

    vgap_all = subs[:4, 4][cand_i]                           # [B,Cb]
    live_c = ivec_bc < cand_len[:, None]
    vgap_m = jnp.where(live_c, vgap_all, 0.0)
    # ds[i] = cost of deleting cand[i:clen], [B, Cb+1]
    csum = jnp.cumsum(vgap_m, axis=1)
    ds = jnp.concatenate(
        [jnp.zeros((Bb, 1), jnp.float32), csum], axis=1)
    ds = csum[:, -1:] - ds

    cand_cols = cand_i.T                                     # [Cb,B]
    vgap_cols = vgap_m.T                                     # [Cb,B]
    F = forward_rows(cand_cols, vgap_cols)
    Bm = backward_rows(cand_cols, vgap_cols, ds[:, :Cb].T,
                       jnp.arange(Cb, dtype=jnp.int32))

    # current total score = B[0][0]
    total = jnp.sum(Bm[0, :, :, 0] * bmaskf, axis=1)         # [B]

    del_raw = masked_reduce(F[:-1], Bm[1:])                  # [Cb, B]

    ins4, sub4 = [], []
    for x in range(4):
        mx = sw[x]                                           # [B,R,S]
        xgap = subs[x, 4]
        subx = jnp.concatenate(
            [F[:, :, :, :1] + xgap,
             jnp.maximum(F[:, :, :, :-1] + mx[None],
                         F[:, :, :, 1:] + xgap)], axis=3)
        ins4.append(masked_reduce(subx, Bm))                 # [Cb+1, B]
        sub4.append(masked_reduce(subx[:-1], Bm[1:]))        # [Cb, B]
    return total, del_raw, jnp.stack(ins4), jnp.stack(sub4)


def _finish_scores(cand, cand_len, total, del_raw, ins4, sub4,
                   groups: int):
    """Reduce raw per-char planes over branch groups, then apply the
    per-lane masks and the 4-char argmax (earliest char wins ties,
    matching the reference's scan order).

    Raw inputs have Bg = B*groups lanes (lane b*groups+j holds group j
    of bubble b); outputs have B lanes."""
    if groups > 1:
        Bg = total.shape[0]
        B = Bg // groups

        def red(a):  # [..., Bg] -> [..., B]
            return a.reshape(*a.shape[:-1], B, groups).sum(axis=-1)

        total, del_raw = red(total), red(del_raw)
        ins4, sub4 = red(ins4), red(sub4)
    Cb = del_raw.shape[0]
    Bb = total.shape[0]
    ppos_c = jnp.arange(Cb, dtype=jnp.int32)
    ppos_c1 = jnp.arange(Cb + 1, dtype=jnp.int32)
    pvalid_del = jnp.where(ppos_c[:, None] < cand_len[None, :],
                           0.0, NEG)
    pvalid_ins = jnp.where(ppos_c1[:, None] <= cand_len[None, :],
                           0.0, NEG)
    del_sc = del_raw + pvalid_del
    ins_all = ins4 + pvalid_ins[None]                        # [4,Cb+1,B]
    cand_t = cand.astype(jnp.int32).T                        # [Cb, B]
    xs = jnp.arange(4, dtype=jnp.int32)[:, None, None]
    sub_all = (sub4 + pvalid_del[None]
               + jnp.where(cand_t[None] == xs, NEG, 0.0))
    ins_chr = jnp.argmax(ins_all, axis=0).astype(jnp.int32)
    ins_sc = jnp.max(ins_all, axis=0)
    sub_chr = jnp.argmax(sub_all, axis=0).astype(jnp.int32)
    sub_sc = jnp.max(sub_all, axis=0)
    return total, del_sc, ins_sc, ins_chr, sub_sc, sub_chr


def _score_edits_jnp(cand, cand_len, branches, blen, bmask, subs):
    """Score every single-base edit against all branches.

    Returns (total [B], del_sc [Cb,B], ins_sc [Cb+1,B], ins_chr,
    sub_sc [Cb,B], sub_chr)."""
    raw = _score_edits_raw_jnp(cand, cand_len, branches, blen, bmask,
                               subs)
    return _finish_scores(cand, cand_len, *raw, groups=1)


def _polish_step(cand, cand_len, done, streak, it_count,
                 branches, blen, bmask, subs, block_size: int = 64,
                 steepest: bool = True, groups: int = 1):
    """One hill-climbing step over the whole batch: jnp scoring, then
    edit selection and the candidate rebuild as a separate jitted
    stage.  The host-stepped driver (route 'stepped') calls it once per
    iteration; it is the reference the on-device loop is checked
    against.

    groups > 1: branches/blen/bmask carry B*groups lanes of <=8
    branches each (see polish_bubbles); raw scores reduce over groups
    inside _select_apply before the char argmax."""
    if groups > 1:
        cand_s, clen_s = _expand_lanes(cand, cand_len, groups=groups)
    else:
        cand_s, clen_s = cand, cand_len
    raw = _score_raw_jit(cand_s, clen_s, branches, blen, bmask, subs)
    return _select_apply(cand, cand_len, done, streak, it_count,
                         *raw, groups=groups, block_size=block_size,
                         steepest=steepest)


_score_raw_jit = jax.jit(_score_edits_raw_jnp)


def _converge_loop(cand, cand_len, score_fn, groups: int,
                   block_size: int, steepest: bool, max_iters: int):
    """The whole hill climb as ONE device program: a lax.while_loop
    over (scoring -> edit selection) with an all-lanes-done exit.  One
    dispatch and one fetch per batch, no host poll between iterations.

    score_fn(cand_s, clen_s) -> raw scores, on the B*groups scoring
    lanes.  Returns (cand, cand_len, score, iters)."""
    B = cand.shape[0]

    def cond(state):
        it = state[0]
        return (it < max_iters) & ~jnp.all(state[3])

    def body(state):
        it, cand, cand_len, done, streak, score, iters = state
        if groups > 1:
            cand_s = jnp.repeat(cand, groups, axis=0)
            clen_s = jnp.repeat(cand_len, groups, axis=0)
        else:
            cand_s, clen_s = cand, cand_len
        raw = score_fn(cand_s, clen_s)
        ncand, nlen, ndone, nstreak, total = _select_apply(
            cand, cand_len, done, streak, it, *raw, groups=groups,
            block_size=block_size, steepest=steepest)
        iters = jnp.where(done, iters, it + 1)
        return (it + 1, ncand, nlen, ndone, nstreak, total, iters)

    state = (jnp.int32(0), cand, cand_len,
             jnp.zeros((B,), bool), jnp.zeros((B,), jnp.int32),
             jnp.zeros((B,), jnp.float32), jnp.zeros((B,), jnp.int32))
    state = jax.lax.while_loop(cond, body, state)
    return state[1], state[2], state[5], state[6]


def _converge_triton(cand, cand_len, branches, blen, bmask, subs,
                     groups: int, block_size: int, steepest: bool,
                     max_iters: int, interpret: bool = False):
    """On-device hill climb with the Triton scoring kernel
    (ops/polish_triton.py); its branch tables are built once per batch."""
    from flye_jax.ops import polish_triton
    subs = subs.astype(jnp.float32)
    Bg, _, S = branches.shape
    tables = polish_triton.prepare(branches, blen, bmask, subs,
                                   polish_triton.padded_lanes(Bg, S))

    def score_fn(cand_s, clen_s):
        return polish_triton.score(cand_s, clen_s, subs, tables,
                                   interpret=interpret)

    return _converge_loop(cand, cand_len, score_fn, groups, block_size,
                          steepest, max_iters)


# hill-climb implementations polish_bubbles can run (ops/routes.py
# picks one per platform)
ROUTES = ("native", "triton", "stepped")


@functools.lru_cache(maxsize=None)
def _converge_program(mesh, groups: int, block_size: int,
                      steepest: bool, max_iters: int,
                      interpret: bool = False):
    """The jitted on-device convergence loop with the Triton scorer.
    Over a >1-device mesh each device climbs its own slice of the batch
    (lanes are independent, so results match one device's)."""
    fn = functools.partial(_converge_triton, groups=groups,
                           block_size=block_size, steepest=steepest,
                           max_iters=max_iters, interpret=interpret)
    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        fn = jax.shard_map(fn, mesh=mesh,
                           in_specs=(P("data"),) * 5 + (P(),),
                           out_specs=P("data"), check_vma=False)
    return jax.jit(fn)


@functools.partial(jax.jit, static_argnames=("groups",))
def _expand_lanes(cand, cand_len, groups: int):
    return (jnp.repeat(cand, groups, axis=0),
            jnp.repeat(cand_len, groups, axis=0))


@functools.partial(jax.jit,
                   static_argnames=("groups", "block_size", "steepest"))
def _select_apply(cand, cand_len, done, streak, it_count,
                  total, del_raw, ins4, sub4, groups: int = 1,
                  block_size: int = 64, steepest: bool = True):
    (total, del_sc, ins_sc, ins_chr, sub_sc,
     sub_chr) = _finish_scores(cand, cand_len, total, del_raw, ins4,
                               sub4, groups)
    Bb, Cb = cand.shape
    G = block_size if block_size > 0 else Cb + 1
    nb = -(-(Cb + 1) // G)
    blk_ids = jnp.arange(nb, dtype=jnp.int32)
    streak_needed = 1 if nb == 1 else 2
    ivec_bc = jax.lax.broadcasted_iota(jnp.int32, (Bb, Cb), 1)
    live_c = ivec_bc < cand_len[:, None]

    def body(cand, cand_len, done, streak, it_count):
        # ---- block-parallel edit selection ----
        def to_blocks(arr, rows):
            pad = nb * G - rows
            a = jnp.concatenate([arr, jnp.full((pad, Bb), NEG)], axis=0)
            return a.reshape(nb, G, Bb)

        def blk_pick(b):
            best = jnp.max(b, axis=1)                        # [nb, B]
            pos = (jnp.argmax(b, axis=1).astype(jnp.int32) +
                   blk_ids[:, None] * G)
            return best, pos

        delb_best, delb_pos = blk_pick(to_blocks(del_sc, Cb))
        insb_best, insb_pos = blk_pick(to_blocks(ins_sc, Cb + 1))
        subb_best, subb_pos = blk_pick(to_blocks(sub_sc, Cb))

        eps = jnp.float32(1e-3)
        thr = total[None, :] + eps
        active = ((blk_ids % 2) == (it_count % 2)) | (nb == 1)
        live = active[:, None] & ~done[None, :]
        if steepest:
            # steepest ascent: best-scoring edit type per block (fixes a
            # substitution in one step instead of the reference's
            # del-then-ins dance; same or better local optima)
            best3 = jnp.maximum(jnp.maximum(delb_best, insb_best),
                                subb_best)
            improving = live & (best3 > thr)
            choose_del = improving & (delb_best >= best3)
            choose_ins = improving & ~choose_del & (insb_best >= best3)
            choose_sub = improving & ~choose_del & ~choose_ins
        else:
            # reference precedence: all deletions, then insertions,
            # then substitutions (general_polisher.cpp:70-125)
            choose_del = live & (delb_best > thr)
            choose_ins = live & ~choose_del & (insb_best > thr)
            choose_sub = live & ~choose_del & ~choose_ins & \
                (subb_best > thr)

        n_del = jnp.sum(choose_del, axis=0).astype(jnp.int32)
        n_ins = jnp.sum(choose_ins, axis=0).astype(jnp.int32)
        overflow = cand_len + n_ins - n_del > Cb
        choose_ins &= ~overflow[None, :]
        n_ins = jnp.sum(choose_ins, axis=0).astype(jnp.int32)

        any_edit = (choose_del | choose_ins | choose_sub).any(axis=0)
        new_streak = jnp.where(any_edit, 0, streak + 1)
        new_done = done | (new_streak >= streak_needed)

        # ---- scatter chosen edits to per-position masks ----
        lane = jnp.arange(Bb)[None, :].repeat(nb, 0)         # [nb, B]
        is_del = jnp.zeros((Bb, Cb), bool).at[
            lane, jnp.where(choose_del, delb_pos, Cb)].max(
            choose_del, mode="drop")
        is_ins = jnp.zeros((Bb, Cb + 1), bool).at[
            lane, jnp.where(choose_ins, insb_pos, Cb + 1)].max(
            choose_ins, mode="drop")
        is_sub = jnp.zeros((Bb, Cb), bool).at[
            lane, jnp.where(choose_sub, subb_pos, Cb)].max(
            choose_sub, mode="drop")
        ins_char_at = jnp.zeros((Bb, Cb + 1), jnp.int32).at[
            lane, jnp.where(choose_ins, insb_pos, Cb + 1)].max(
            jnp.take_along_axis(ins_chr, jnp.clip(insb_pos, 0, Cb),
                                axis=0),
            mode="drop")
        sub_char_at = jnp.zeros((Bb, Cb), jnp.int32).at[
            lane, jnp.where(choose_sub, subb_pos, Cb)].max(
            jnp.take_along_axis(sub_chr, jnp.clip(subb_pos, 0, Cb - 1),
                                axis=0),
            mode="drop")

        # ---- apply all edits at once, scatter-free ----
        # the rebuild uses bounded shifted-copy selects instead of
        # scatters (deterministic on every backend): each position moves by
        # at most nb slots (one ins/del per active block), so the new
        # candidate is a select over 2*nb+1 rolled copies.
        cand_subbed = jnp.where(is_sub, sub_char_at.astype(jnp.uint8),
                                cand)
        dels_cum = jnp.cumsum(is_del.astype(jnp.int32), axis=1)
        dels_excl = dels_cum - is_del.astype(jnp.int32)
        ins_cum = jnp.cumsum(is_ins.astype(jnp.int32), axis=1)
        W = Cb + 1
        ivec1 = jax.lax.broadcasted_iota(jnp.int32, (Bb, W), 1)
        # old chars: position i moves to i + shift_old[i]
        shift_old = ins_cum[:, :Cb] - dels_excl
        keep = (~is_del) & live_c
        # inserted chars: char at insert-slot p lands at p + shift_ins[p]
        dels_before = jnp.concatenate(
            [jnp.zeros((Bb, 1), jnp.int32), dels_cum], axis=1)[:, :W]
        shift_ins = ins_cum - dels_before - 1

        def pad_w(a, fill):
            return jnp.concatenate(
                [a, jnp.full((Bb, W - a.shape[1]), fill, a.dtype)], axis=1)

        cs_pad = pad_w(cand_subbed, jnp.uint8(0))
        keep_pad = pad_w(keep, False)
        shift_old_pad = pad_w(shift_old, jnp.int32(0))
        out = jnp.zeros((Bb, W), jnp.uint8)
        smax = min(nb, W - 1)
        for s in range(-smax, smax + 1):
            m_old = keep_pad & (shift_old_pad == s)
            m_ins = is_ins & (shift_ins == s)
            if s == 0:
                out = jnp.where(m_old, cs_pad, out)
                out = jnp.where(m_ins, ins_char_at.astype(jnp.uint8), out)
                continue
            dst_ok = (ivec1 >= s) if s > 0 else (ivec1 < W + s)
            out = jnp.where(
                jnp.roll(m_old, s, axis=1) & dst_ok,
                jnp.roll(cs_pad, s, axis=1), out)
            out = jnp.where(
                jnp.roll(m_ins, s, axis=1) & dst_ok,
                jnp.roll(ins_char_at, s, axis=1).astype(jnp.uint8), out)
        out = out[:, :Cb]
        new_len = cand_len + n_ins - n_del

        return out, new_len, new_done, new_streak, total

    return body(cand, cand_len, done, streak, it_count)


def _polish_bubbles_native(cand, cand_len, branches, blen, bmask, subs,
                           max_iters: int, eps: float = 1e-3):
    """CPU fallback through flye_native.polish_bubbles_host; None when
    the native module is unavailable."""
    import numpy as np

    from flye_jax import native
    mod = native.get()
    if mod is None or not hasattr(mod, "polish_bubbles_host"):
        return None
    cand = np.ascontiguousarray(cand, dtype=np.uint8)
    Bn, Cb = cand.shape
    _, R, S = branches.shape
    out = mod.polish_bubbles_host(
        cand.tobytes(),
        np.ascontiguousarray(cand_len, np.int32).tobytes(),
        np.ascontiguousarray(branches, np.uint8).tobytes(),
        np.ascontiguousarray(blen, np.int32).tobytes(),
        np.ascontiguousarray(bmask, np.uint8).tobytes(),
        np.ascontiguousarray(subs, np.float32).tobytes(),
        Bn, Cb, R, S, int(max_iters), float(eps))
    cand_b, len_b, score_b, iters_b = out
    return (np.frombuffer(cand_b, np.uint8).reshape(Bn, Cb),
            np.frombuffer(len_b, np.int32),
            np.frombuffer(score_b, np.float32),
            np.frombuffer(iters_b, np.int32))


def polish_bubbles(cand, cand_len, branches, blen, bmask, subs,
                   max_iters: int, block_size: int = 64,
                   steepest: bool = True, route=None):
    """Hill-climb every bubble to convergence.

    Args:
      cand: [B, Cb] uint8 candidate codes (Cb leaves growth headroom).
      cand_len: [B] int32.
      branches: [B, R, S] uint8; blen [B, R] int32; bmask [B, R] bool.
      subs: [5, 5] float32 log-prob matrix.
      max_iters: outer-iteration cap.
      block_size: parallel-edit block width (0 = serial reference mode).
      route: None (the platform's choice, ops/routes.polish_route),
        'native' (threaded C++ climber), 'triton' (on-device convergence
        loop, Triton scoring kernel) or 'stepped' (host-stepped loop
        with the jnp scorer, the reference for the on-device loop).

    Returns (cand [B, Cb], cand_len [B], score [B], iters [B]).
    """
    route = route or routes.polish_route()
    if route == "native":
        # the jnp scan formulation rescans the full F/B tensors every
        # iteration and runs ~100x slower than threaded C++ on the CPU;
        # without the native module the CPU runs the reference loop
        native_out = _polish_bubbles_native(cand, cand_len, branches,
                                            blen, bmask, subs, max_iters)
        if native_out is not None:
            return native_out
        route = "stepped"

    # Branch-group tiling: buckets with many branches split into lanes
    # of <=8 branch ROWS (score sums over branches decompose exactly;
    # the char argmax happens after the group reduction in
    # _select_apply), so a 56-branch bucket costs 7 lanes of the 8-row
    # shape instead of its own, much larger working set.
    R, S = branches.shape[1], branches.shape[2]
    gsz = 8
    groups = max(1, -(-R // gsz)) if R > gsz else 1
    if groups > 1:
        B0 = branches.shape[0]
        pad_r = groups * gsz - R
        branches = np.pad(np.asarray(branches),
                          ((0, 0), (0, pad_r), (0, 0)))
        blen = np.pad(np.asarray(blen), ((0, 0), (0, pad_r)))
        bmask = np.pad(np.asarray(bmask), ((0, 0), (0, pad_r)))
        branches = branches.reshape(B0 * groups, gsz, S)
        blen = blen.reshape(B0 * groups, gsz)
        bmask = bmask.reshape(B0 * groups, gsz)

    from flye_jax.parallel.runtime import get_runtime
    rt = get_runtime()
    Bb = cand.shape[0]
    # bubble batch axis sharded over the runtime mesh — the polish phase
    # is embarrassingly parallel over windows (the reference runs it as
    # N worker threads, bubble_processor.h:29); XLA partitions the
    # jitted program across devices, no collectives needed
    cand = rt.shard_rows(np.asarray(cand))
    cand_len = rt.shard_rows(np.asarray(cand_len, np.int32))
    branches = rt.shard_rows(np.asarray(branches))
    blen = rt.shard_rows(np.asarray(blen, np.int32))
    bmask = rt.shard_rows(np.asarray(bmask))
    subs = jnp.asarray(subs, jnp.float32)

    if route == "triton":
        sharded = rt.active and Bb % rt.n_devices == 0
        program = _converge_program(
            rt.mesh if sharded else None, groups, block_size, steepest,
            max_iters)
        return program(cand, cand_len, branches, blen, bmask, subs)

    assert route == "stepped", route
    done = rt.shard_rows(np.zeros((Bb,), bool))
    streak = rt.shard_rows(np.zeros((Bb,), np.int32))
    score = rt.shard_rows(np.zeros((Bb,), np.float32))
    iters = np.zeros(Bb, np.int64)
    done_h = np.zeros(Bb, bool)
    for it in range(max_iters):
        cand, cand_len, done, streak, score = _polish_step(
            cand, cand_len, done, streak, jnp.int32(it),
            branches, blen, bmask, subs, block_size=block_size,
            steepest=steepest, groups=groups)
        # an iteration counts for every lane not done when it began,
        # as in the on-device loop
        iters = np.where(done_h, iters, it + 1)
        done_h = np.asarray(done)
        if done_h.all():
            break
    return cand, cand_len, score, jnp.asarray(iters.astype(np.int32))
