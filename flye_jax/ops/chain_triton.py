"""Seed-chain DP as one Pallas kernel on the Triton route.

Same recurrence and tie rule as ops/chain._chain_dp_scan (reference:
src/sequence/overlap.cpp:277-323).  XLA runs the scan as a while loop
of M-1 small steps, each several kernel launches; here one program
owns one match list and walks its M matches in a loop of its own, each
step a vector over the L-predecessor window.  Scores stream through a
per-row buffer that the next steps' windows read back.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_NEG = np.int32(-(2 ** 30))


def window(lookback: int, M: int) -> int:
    """Predecessor-window block: min(lookback, M) rounded up to a power
    of two (the extra leading slots are masked out)."""
    return pl.next_power_of_2(max(1, min(lookback, M)))


def num_warps(Lp: int) -> int:
    return min(8, max(1, Lp // 256))


def _kernel(curp, extp, score_ref, parent_ref, *, k: int, max_jump: int,
            L: int, Lp: int, M: int, interpret: bool):
    row = pl.program_id(0)
    off = jax.lax.broadcasted_iota(jnp.int32, (Lp,), 0)
    in_window = off >= Lp - L
    score_ref[row, pl.ds(0, Lp)] = jnp.full((Lp,), _NEG, jnp.int32)
    score_ref[row, Lp] = jnp.int32(k)
    parent_ref[row, 0] = jnp.int32(-1)

    def step(i, carry):
        if not interpret:
            plgpu.debug_barrier()
        # window covers matches i-Lp .. i-1 -> padded columns i .. i+Lp-1
        curw = curp[row, pl.ds(i, Lp)]
        extw = extp[row, pl.ds(i, Lp)]
        scw = score_ref[row, pl.ds(i, Lp)]
        dcur = curp[row, i + Lp] - curw
        dext = extp[row, i + Lp] - extw
        ok = ((0 < dcur) & (dcur < max_jump) & (0 < dext)
              & (dext < max_jump) & in_window)
        match = jnp.minimum(jnp.minimum(dcur, dext), k)
        jump_div = jnp.abs(dcur - dext)
        gap = jnp.where(jump_div > 100, 2 * jump_div, jump_div // 2)
        cand = jnp.where(ok, scw + match - gap, _NEG)
        best = jnp.max(cand)
        # latest predecessor wins ties
        best_off = jnp.max(jnp.where(cand == best, off, -1))
        score_ref[row, i + Lp] = jnp.maximum(best, k)
        parent_ref[row, i] = jnp.where(best > k, i - Lp + best_off, -1)
        return carry

    jax.lax.fori_loop(jnp.int32(1), jnp.int32(M), step, jnp.int32(0))


@functools.partial(jax.jit, static_argnames=(
    "k", "max_jump", "lookback", "interpret"))
def chain_dp_triton(cur, ext, nvalid, k: int, max_jump: int,
                    lookback: int, interpret: bool = False):
    """(score [T, M], parent [T, M]) — ops/chain._chain_dp_scan's
    contract, bit for bit."""
    T, M = cur.shape
    L = min(lookback, M)
    Lp = window(lookback, M)
    idx = jax.lax.broadcasted_iota(jnp.int32, (T, M), 1)
    live = idx < nvalid[:, None]
    pad = jnp.full((T, Lp), _NEG, jnp.int32)
    curp = jnp.concatenate(
        [pad, jnp.where(live, cur.astype(jnp.int32), _NEG)], axis=1)
    extp = jnp.concatenate(
        [pad, jnp.where(live, ext.astype(jnp.int32), _NEG)], axis=1)
    kernel = functools.partial(_kernel, k=k, max_jump=max_jump, L=L,
                               Lp=Lp, M=M, interpret=interpret)
    scorep, parent = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((T, Lp + M), jnp.int32),
                   jax.ShapeDtypeStruct((T, M), jnp.int32)],
        grid=(T,),
        compiler_params=plgpu.CompilerParams(num_warps=num_warps(Lp),
                                             num_stages=1),
        interpret=interpret, name="chain_dp",
        backend=None if interpret else "triton",
    )(curp, extp)
    score = jnp.where(live, scorep[:, Lp:], 0)
    parent = jnp.where(live, parent, -1)
    return score, parent
