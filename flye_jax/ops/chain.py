"""Seed-match chaining DP, batched device kernel.

Device replacement for the per-target O(n^2) chaining loop in the
reference's overlap detector (reference: src/sequence/overlap.cpp:277-323,
itself minimap2-inspired).  Many (query, target) match lists are padded
into one [T, M] batch; the DP runs as a single lax.scan over the match
axis with a vectorized bounded-lookback window, so all T lanes progress
in lockstep.

Scoring matches the reference exactly:
    transition j -> i allowed iff 0 < dcur < max_jump and 0 < dext < max_jump
    match score   = min(dcur, dext, k)
    gap cost      = 2*jumpDiv if jumpDiv > 100 else jumpDiv // 2
    score[i]      = max(k, max_j(score[j] + match - gap))
    parent[i]     = argmax j (latest j wins ties), only if score > k

Known deviation: the reference breaks its backward scan at the first
perfect-diagonal predecessor (overlap.cpp:305), occasionally preferring a
nearer tie over a farther, higher-scoring one; the vectorized argmax
always takes the best (latest-on-tie) predecessor within the lookback
window.  Chains can only get better under this rule.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from flye_jax.ops import routes
from flye_jax.ops.chain_triton import chain_dp_triton

_NEG = np.int32(-(2 ** 30))  # np scalar: no backend init at import
_I0 = np.int32(0)


def chain_dp(cur: jax.Array, ext: jax.Array, nvalid: jax.Array,
             k: int, max_jump: int, lookback: int):
    """Chain scores and parent pointers for a batch of match lists.

    Runs the route ops/routes.chain_route picks for the platform: the
    Triton kernel (ops/chain_triton.py) or the lax.scan formulation
    below, which is also the oracle the kernel is tested against.

    Args:
      cur, ext: [T, M] int32 match coordinates, each row sorted along the
        chaining axis (by ext if the target is longer, else by cur — the
        caller decides, reference: overlap.cpp:272-276).
      nvalid: [T] int32 true match counts per row.
      k: k-mer size (static).
      max_jump: maximum allowed coordinate jump (static).
      lookback: how many predecessors each match may link to (static).
        Set >= M for exact full-window DP; smaller values trade a tiny
        amount of chain quality for linear-time DP like minimap2's
        bounded lookback.

    Returns:
      score:  [T, M] int32 best chain score ending at each match.
      parent: [T, M] int32 predecessor index or -1.
    """
    return _CHAIN[routes.chain_route()](cur, ext, nvalid, k=k,
                                        max_jump=max_jump,
                                        lookback=lookback)


def chain_dp_multi(buckets, k: int, max_jump: int, lookback: int):
    """Chain DP over SEVERAL padded bucket batches in ONE device
    program: a single dispatch + a single flattened fetch, instead of
    one round trip per bucket shape (a typical overlap batch carries
    ~5 bucket shapes).

    buckets: sequence of (cur [T,M] int32, ext, nvalid [T]) with static
    shapes.  Returns one flat int32 array laid out as, per bucket,
    [score rows..., parent rows...]; callers slice by the known shapes.
    Over a >1-device mesh each device chains its own rows of every
    bucket whose row count divides the mesh.
    """
    from flye_jax.parallel.runtime import get_runtime
    rt = get_runtime()
    return _chain_dp_multi(tuple(tuple(b) for b in buckets),
                           k=int(k), max_jump=int(max_jump),
                           lookback=int(lookback),
                           route=routes.chain_route(),
                           mesh=rt.mesh if rt.active else None)


@functools.partial(jax.jit, static_argnames=("k", "max_jump", "lookback",
                                             "route", "mesh"))
def _chain_dp_multi(buckets, k: int, max_jump: int, lookback: int,
                    route: str, mesh=None):
    outs = []
    for cur, ext, nv in buckets:
        fn = functools.partial(_CHAIN[route], k=k, max_jump=max_jump,
                               lookback=min(lookback, cur.shape[1]))
        if mesh is not None and cur.shape[0] % mesh.size == 0:
            from jax.sharding import PartitionSpec as P
            fn = jax.shard_map(fn, mesh=mesh, in_specs=P("data"),
                               out_specs=P("data"), check_vma=False)
        s, p = fn(cur, ext, nv)
        outs.append(s.astype(jnp.int32).reshape(-1))
        outs.append(p.astype(jnp.int32).reshape(-1))
    return jnp.concatenate(outs)


@functools.partial(jax.jit, static_argnames=("k", "max_jump", "lookback"))
def _chain_dp_scan(cur: jax.Array, ext: jax.Array, nvalid: jax.Array,
                   k: int, max_jump: int, lookback: int):
    T, M = cur.shape
    L = min(lookback, M)
    idx = jax.lax.broadcasted_iota(jnp.int32, (T, M), 1)
    live = idx < nvalid[:, None]
    curm = jnp.where(live, cur.astype(jnp.int32), _NEG)
    extm = jnp.where(live, ext.astype(jnp.int32), _NEG)

    # left-pad by L so the lookback window is always a static-size slice
    pad = jnp.full((T, L), _NEG, dtype=jnp.int32)
    curp = jnp.concatenate([pad, curm], axis=1)          # [T, L+M]
    extp = jnp.concatenate([pad, extm], axis=1)
    score0 = jnp.concatenate(
        [pad, jnp.full((T, M), k, dtype=jnp.int32)], axis=1)

    def step(scorep, i):
        # window covers j = i-L .. i-1  -> padded columns i .. i+L-1
        curw = jax.lax.dynamic_slice(curp, (_I0, i), (T, L))
        extw = jax.lax.dynamic_slice(extp, (_I0, i), (T, L))
        scw = jax.lax.dynamic_slice(scorep, (_I0, i), (T, L))
        curn = jax.lax.dynamic_slice(curp, (_I0, i + L), (T, 1))
        extn = jax.lax.dynamic_slice(extp, (_I0, i + L), (T, 1))

        dcur = curn - curw
        dext = extn - extw
        ok = (0 < dcur) & (dcur < max_jump) & (0 < dext) & (dext < max_jump)
        match = jnp.minimum(jnp.minimum(dcur, dext), k)
        jump_div = jnp.abs(dcur - dext)
        gap = jnp.where(jump_div > 100, 2 * jump_div, jump_div // 2)
        cand = jnp.where(ok, scw + match - gap, _NEG)

        # best predecessor, latest j wins ties -> argmax over reversed
        rev = cand[:, ::-1]
        best_rev = jnp.argmax(rev, axis=1)
        best_off = (L - 1) - best_rev                    # window offset
        best = jnp.take_along_axis(cand, best_off[:, None], axis=1)[:, 0]

        new_score = jnp.maximum(best, k)
        parent = jnp.where(best > k, i - L + best_off, -1)
        scorep = jax.lax.dynamic_update_slice(
            scorep, new_score[:, None], (_I0, i + L))
        return scorep, (new_score, parent)

    scorep, (scores, parents) = jax.lax.scan(
        step, score0, jnp.arange(1, M, dtype=jnp.int32))
    # prepend i=0 row: score k, no parent
    score = jnp.concatenate(
        [jnp.full((T, 1), k, jnp.int32), scores.T], axis=1)
    parent = jnp.concatenate(
        [jnp.full((T, 1), -1, jnp.int32), parents.T], axis=1)
    score = jnp.where(live, score, 0)
    parent = jnp.where(live, parent, -1)
    return score, parent


_CHAIN = {"scan": _chain_dp_scan, "triton": chain_dp_triton}


def backtrack_chains(score, parent, nvalid, k, max_chains=0):
    """Host-side chain extraction mirroring the reference's score-ordered
    backtracking with visited marking (reference: overlap.cpp:330-385).

    Args:
      score, parent: [M] numpy arrays for ONE match list.
      nvalid: number of valid matches.
      k: k-mer size.
      max_chains: stop after this many chains (0 = no limit).

    Returns list of (first, last, chain_score, chain_indices) with
    chain_indices ascending.
    """
    import numpy as np

    nvalid = min(int(nvalid), len(score), len(parent))
    score = np.ascontiguousarray(score[:nvalid], dtype=np.int32)
    from flye_jax import native
    mod = native.get()
    if mod is not None:
        parent_c = np.ascontiguousarray(parent[:nvalid], dtype=np.int32)
        out = mod.backtrack_chains(score.tobytes(), parent_c.tobytes(),
                                   int(nvalid), int(k), int(max_chains))
        return [(first, last, cscore,
                 list(np.frombuffer(path, dtype=np.int32)))
                for first, last, cscore, path in out]

    parent = np.asarray(parent[:nvalid]).copy()
    order = np.argsort(-score, kind="stable")
    chains = []
    for start in order:
        if parent[start] == -1:
            continue
        path = []
        pos = int(start)
        while pos != -1:
            path.append(pos)
            nxt = int(parent[pos])
            parent[pos] = -1
            pos = nxt
        first, last = path[-1], path[0]
        chain_score = int(score[last]) - int(score[first]) + k - 1
        chains.append((first, last, chain_score, path[::-1]))
        if max_chains and len(chains) >= max_chains:
            break
    return chains
