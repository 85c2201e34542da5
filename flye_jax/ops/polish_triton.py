"""Bubble-polish edit scoring as one Pallas kernel on the Triton route.

The jnp scorer (ops/polish._score_edits_raw_jnp) materializes the forward
(F) and backward (B) DP tensors [Cb+1, lanes, 8, S+1] in device memory
and re-reads them for every scored character class.  Here one program
owns a tile of TB lanes (bubble branch groups) and walks the DP rows in
a loop of its own, keeping the current row in registers:

  backward sweep: rows B[Cb-1] .. B[0], each from the row below it; the
    rows stream out to a per-tile buffer (the forward sweep reads each
    back once, while it is still in L2);
  forward sweep: F[0] .. F[Cb] with every deletion / insertion /
    substitution score of position i taken from F[i], B[i] and B[i+1]
    in the same pass, so F never leaves the program.

The in-row gap dependency is a running max along the row (a Triton
scan; see _register_cummax).  The one-column shifts of the recurrence
go through a small per-tile scratch in device memory: the row is
stored, the block synchronizes, and the row is read back one column
over.

Semantics are _score_edits_raw_jnp's exactly (same masks, same NEG
padding); float sums over the 8 branches run in another order, so
scores agree to float32 rounding (checked by tests/test_polish_triton.py
in interpret mode and by chip_smoke.py on the card).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG = np.float32(-1e30)
# f32 elements of one [TB, 8, W] row tile: bounds the registers each
# live row plane takes (TILE_ELEMS / (32 * num_warps) per thread)
TILE_ELEMS = 2048
NUM_WARPS = 4


def row_width(S: int) -> int:
    """Columns of a kernel row: S+1 rounded up to a power of two."""
    return max(16, pl.next_power_of_2(S + 1))


def tile_lanes(W: int) -> int:
    """Lanes (8-branch groups) per program for rows of W columns."""
    return max(1, TILE_ELEMS // (8 * W))


# the JAX release whose private Pallas-Triton lowering _register_cummax
# extends (pinned in pyproject.toml)
TESTED_JAX = "0.9.0"


def _register_cummax():
    """Lower lax.cummax (both directions) to a Triton scan.

    The Pallas Triton lowering of TESTED_JAX scans only for forward
    cumsum; the polish recurrences need a running max forward (F) and
    backward (B).  This mirrors its cumsum rule with max as the
    combiner and the scan's reverse flag.  Called before the first
    compiled (not interpreted) kernel; raises with the version when the
    private lowering API it builds on has changed."""
    try:
        from jax._src import api_util
        from jax._src import linear_util as lu
        from jax._src.interpreters import partial_eval as pe
        from jax._src.lib.triton import dialect as tt_dialect
        from jax._src.pallas.triton import lowering as tl
        for mod, name in ((tl, "triton_lowering_rules"),
                          (tl, "lower_jaxpr_to_triton_ir"),
                          (tl, "_element_type"), (tt_dialect, "ScanOp"),
                          (tt_dialect, "scan_return")):
            getattr(mod, name)
    except (ImportError, AttributeError) as e:
        raise RuntimeError(
            f"the Triton polish kernel extends the Pallas-Triton lowering "
            f"of jax {TESTED_JAX}; jax {jax.__version__} lacks part of "
            f"it ({e})") from e

    if jax.lax.cummax_p in tl.triton_lowering_rules:
        return

    def rule(ctx, x, *, axis, reverse):
        dtype = ctx.avals_in[0].dtype
        aval = jax.core.ShapedArray((), dtype)
        fun = lu.wrap_init(
            lambda a, b: [jnp.maximum(a, b)],
            debug_info=api_util.debug_info("cummax combine", jnp.maximum,
                                           (0, 0), {}))
        jaxpr, _, consts = pe.trace_to_jaxpr_dynamic(fun, [aval, aval])
        assert not consts
        elt = tl._element_type(x.type)
        op = tt_dialect.ScanOp([x], axis, reverse)
        entry = op.regions[0].blocks.append(elt, elt)
        with tl.ir.InsertionPoint.at_block_begin(entry):
            res = tl.lower_jaxpr_to_triton_ir(ctx.context, jaxpr, None,
                                              *entry.arguments)
            tt_dialect.scan_return(res)
        op.verify()
        return list(op.result)[0]

    tl.triton_lowering_rules[jax.lax.cummax_p] = rule


def _kernel(candT, vgapT, dsT, clen_ref, blen_ref, bmask_ref, sw_ref,
            swr_ref, gp_ref, sg_ref, xgap_ref,
            total_ref, del_ref, ins_ref, sub_ref, bt_ref, shift_ref,
            *, Cb: int, TB: int, W: int, interpret: bool):
    t = pl.program_id(0)
    lanes = pl.ds(t * TB, TB)
    lane_ids = t * TB + jax.lax.broadcasted_iota(jnp.int32, (TB,), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (TB, 8, W), 2)
    blen3 = blen_ref[lanes, :][:, :, None]
    clen = clen_ref[lanes]
    bmask = bmask_ref[lanes, :]
    gp = gp_ref[lanes]
    sg = sg_ref[lanes]
    inb = jj <= blen3
    jmask = jnp.where(inb, 0.0, NEG)

    def sync():
        if not interpret:
            plgpu.debug_barrier()

    def col(v):
        return v[:, None, None]

    def match_plane(ref, cx):
        """ref[lane, cx[lane]] for every lane of the tile: [TB, 8, W]."""
        return ref[lane_ids, cx]

    def shifted(row, slot, direction):
        """row[j+1] (direction +1, NEG past the end) or row[j-1]
        (direction -1, NEG at 0), through this tile's scratch slot."""
        if direction > 0:
            shift_ref[slot, lanes, :, pl.ds(0, W)] = row
            sync()
            out = plgpu.load(shift_ref.at[slot, lanes, :, pl.ds(1, W)],
                             mask=jj < W - 1, other=NEG)
        else:
            shift_ref[slot, lanes, :, pl.ds(1, W)] = row
            sync()
            out = plgpu.load(shift_ref.at[slot, lanes, :, pl.ds(0, W)],
                             mask=jj >= 1, other=NEG)
        return out

    def reduce_wmax(x):
        """max over columns, then the branch-mask-weighted sum."""
        return jnp.sum(jnp.max(x, axis=2) * bmask, axis=1)

    # ---- backward sweep: B[Cb] = sg, then B[Cb-1] .. B[0] ----
    bt_ref[Cb, lanes] = sg

    def bwd(k, nxt):
        j = Cb - 1 - k
        nxt_l = shifted(nxt, k % 2, +1)                      # B[j+1][c+1]
        cx = candT[j, lanes]
        diag = jnp.where(jj < blen3, nxt_l + match_plane(sw_ref, cx), NEG)
        tmp = jnp.maximum(diag, nxt + col(vgapT[j, lanes]))
        tmp = jnp.where(inb, tmp, NEG)
        row = jax.lax.cummax(tmp - sg, axis=2, reverse=True) + sg
        row = jnp.where(col(j < clen), row, sg)
        row = jnp.where(inb, row, col(dsT[j, lanes]))
        bt_ref[j, lanes] = row
        return row

    jax.lax.fori_loop(jnp.int32(0), jnp.int32(Cb), bwd, sg)
    sync()

    # ---- forward sweep + scoring, positions 0 .. Cb ----
    b0 = bt_ref[0, lanes]
    total_ref[lanes] = reduce_wmax(jnp.where(jj == 0, b0, NEG))

    def fwd(i, carry):
        F, Bi = carry
        B1 = bt_ref[jnp.minimum(i + 1, Cb), lanes]
        Fs = shifted(F, i % 2, -1)                           # F[i][c-1]
        B0m = Bi + jmask
        B1m = B1 + jmask
        del_ref[i, lanes] = reduce_wmax(F + B1m)
        for x in range(4):
            subx = jnp.maximum(Fs + swr_ref[lanes, x], F + xgap_ref[x])
            ins_ref[x, i, lanes] = reduce_wmax(subx + B0m)
            sub_ref[x, i, lanes] = reduce_wmax(subx + B1m)
        cx = candT[i, lanes]
        tmp = jnp.maximum(Fs + match_plane(swr_ref, cx),
                          F + col(vgapT[i, lanes]))
        Fn = jax.lax.cummax(tmp - gp, axis=2) + gp
        return Fn, B1

    jax.lax.fori_loop(jnp.int32(0), jnp.int32(Cb + 1), fwd, (gp, b0))


def prepare(branches, blen, bmask, subs, Bp: int):
    """Branch-side kernel tables, built once per batch (constant over
    hill-climb iterations): match planes sw [Bp,4,8,W] and their
    one-column right shift swr, gap prefix/suffix gp/sg [Bp,8,W],
    blen [Bp,8] (-1 on pad lanes) and f32 branch weights [Bp,8]."""
    from flye_jax.ops.polish import _branch_tables
    Bg, R, S = branches.shape
    assert R == 8, R
    W = row_width(S)
    sw, gp, sg = _branch_tables(branches, blen, subs)
    pb = Bp - Bg

    def pad(x, fill, lane_axis):
        widths = [(0, 0)] * x.ndim
        widths[lane_axis] = (0, pb)
        widths[-1] = (0, W - x.shape[-1])
        return jnp.pad(x, widths, constant_values=fill)

    swp = pad(sw, 0.0, 1)                                    # [4,Bp,8,W]
    swr = jnp.concatenate([jnp.zeros_like(swp[..., :1]),
                           swp[..., :-1]], axis=-1)
    # gp's last column repeats into the pad (prefix maxima stay exact);
    # sg is 0 past the branch end
    gp_t = jnp.concatenate(
        [gp, jnp.broadcast_to(gp[..., -1:], (Bg, 8, W - S - 1))], axis=-1)
    gp_p = jnp.pad(gp_t, ((0, pb), (0, 0), (0, 0)))
    sg_p = pad(sg, 0.0, 0)
    blen_p = jnp.pad(blen.astype(jnp.int32), ((0, pb), (0, 0)),
                     constant_values=-1)
    bmask_p = jnp.pad(bmask.astype(jnp.float32), ((0, pb), (0, 0)))
    return (jnp.moveaxis(swp, 0, 1), jnp.moveaxis(swr, 0, 1), gp_p, sg_p,
            blen_p, bmask_p)


def padded_lanes(Bg: int, S: int) -> int:
    TB = tile_lanes(row_width(S))
    return -(-Bg // TB) * TB


def score(cand, cand_len, subs, tables, interpret: bool = False):
    """Raw edit scores of every lane: (total [B], del_raw [Cb,B],
    ins4 [4,Cb+1,B], sub4 [4,Cb,B]), the contract of
    ops/polish._score_edits_raw_jnp.  `tables` = prepare(...)."""
    sw, swr, gp, sg, blen, bmask = tables
    Bb, Cb = cand.shape
    Bp, _, _, W = sw.shape
    TB = tile_lanes(W)
    subs = subs.astype(jnp.float32)
    cand_i = cand.astype(jnp.int32)
    live = jax.lax.broadcasted_iota(jnp.int32, (Bb, Cb), 1) < \
        cand_len[:, None]
    vgap = jnp.where(live, subs[:4, 4][cand_i], 0.0)
    csum = jnp.cumsum(vgap, axis=1)
    ds = csum[:, -1:] - jnp.concatenate(
        [jnp.zeros((Bb, 1), jnp.float32), csum], axis=1)    # [B, Cb+1]

    def lanes_last(x, fill=0):
        """[B, C] per-lane columns -> [C+pad, Bp] (a row load is one
        contiguous run of lanes)."""
        x = jnp.pad(x, ((0, Bp - Bb), (0, Cb + 1 - x.shape[1])),
                    constant_values=fill)
        return x.T

    candT = lanes_last(cand_i)
    vgapT = lanes_last(vgap)
    dsT = lanes_last(ds)
    clen = jnp.pad(cand_len.astype(jnp.int32), (0, Bp - Bb))
    f32 = jnp.float32
    out_shape = [
        jax.ShapeDtypeStruct((Bp,), f32),                    # total
        jax.ShapeDtypeStruct((Cb + 1, Bp), f32),             # del
        jax.ShapeDtypeStruct((4, Cb + 1, Bp), f32),          # ins4
        jax.ShapeDtypeStruct((4, Cb + 1, Bp), f32),          # sub4
        jax.ShapeDtypeStruct((Cb + 1, Bp, 8, W), f32),       # B rows
        jax.ShapeDtypeStruct((2, Bp, 8, W + 1), f32),        # shift
    ]
    if not interpret:
        _register_cummax()
    kernel = functools.partial(_kernel, Cb=Cb, TB=TB, W=W,
                               interpret=interpret)
    total, dele, ins4, sub4, _, _ = pl.pallas_call(
        kernel, out_shape=out_shape, grid=(Bp // TB,),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret, name="polish_score",
        backend=None if interpret else "triton",
    )(candT, vgapT, dsT, clen, blen, bmask, sw, swr, gp, sg,
      subs[:4, 4])
    return (total[:Bb], dele[:Cb, :Bb], ins4[:, :, :Bb],
            sub4[:, :Cb, :Bb])
