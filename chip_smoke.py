"""GPU smoke test: the assembler's device ops and main path on one card.

    python chip_smoke.py                 # one card: phases 1-3
    python chip_smoke.py --four-cards    # four cards: sharded vs one-shard

Phases:
  1. device — the card's name and power limit (nvidia-smi), JAX's view
     of it, and the native host module; fails unless JAX's platform is
     'gpu' and the native module loads.
  2. kernels — each device op at production shapes against its plain
     reference on the CPU device (integer ops bit-exact; polish scores
     within 1e-4 absolute or 1e-5 relative), with its time on the card.
  3. end to end — the seeded bacterial-isolate deployment (4.6 Mb
     genome, PacBio-raw 30x) through the CLI entry point in this
     process; fails unless the assembly covers >= 98% of the genome in
     <= 3 contigs at window identity >= 0.999.

--four-cards runs only the four-card path: a psum and an all-to-all
across the cards and the sharded polish and chain-DP programs, each
against its one-card result, then the deployment through the CLI with
--shards 4 and --shards 1 in one process, the two assemblies compared
byte for byte.

--deadline N dumps every thread's stack and exits non-zero after N
seconds, so a stalled phase shows where it stalled.

Any failure exits non-zero; the last line of standard output is a JSON
object only when every phase passed.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

_ROOT = os.path.dirname(os.path.abspath(__file__))
_WORK = os.path.join(_ROOT, ".smoke_work")
_OUT = os.path.join(_ROOT, "chiprun_out", "smoke")

# §2 shapes: polish buckets (C, Cb, R, S, bubbles), chain DP (T, M, L)
POLISH_SHAPES = {
    "fine": (16, 24, 32, 40, 8192),
    "dominant": (44, 64, 56, 96, None),
    "big_window": (120, 160, 56, 240, None),
}
CHAIN_SHAPES = {
    "M4096": (128, 4096, 1024),
    "M16384": (32, 16384, 1024),
    "bench": (256, 2048, 512),
}
CHECK_LANES = 1024


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def timed(fn, reps: int = 3):
    """(result, best seconds) over reps runs, each ended by
    block_until_ready; the first call compiles and is not timed."""
    import jax
    out = jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return out, best


# ---------------------------------------------------------------- phase 1

def phase_device(expect_count: int):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] nvidia-smi: {card}")
    import jax
    devs = jax.devices()
    d0 = devs[0]
    log(f"[device] jax {jax.__version__}: platform={d0.platform} "
        f"kind={d0.device_kind} count={len(devs)}")
    check(d0.platform == "gpu", f"JAX platform is {d0.platform}, not gpu")
    check(len(devs) == expect_count,
          f"{len(devs)} visible devices, expected {expect_count}")
    from flye_jax import native
    check(native.get() is not None, "native host module did not load")
    log("[device] native host module loaded")
    return card, d0


# ---------------------------------------------------------------- phase 2

def _cpu():
    import jax
    return jax.devices("cpu")[0]


def _on_cpu(fn, *args):
    import jax
    cpu = _cpu()
    args = [jax.device_put(a, cpu) for a in args]
    with jax.default_device(cpu):
        return jax.block_until_ready(fn(*args))


def _polish_workload(C, Cb, R, S, B, seed):
    """Bubbles whose branches are the truth with scattered errors and
    whose candidate carries a few edits: the shape of real windows."""
    import numpy as np
    rng = np.random.default_rng(seed)
    true = rng.integers(0, 4, (B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    for i in range(B):
        idx = rng.integers(0, C, 2)
        cand[i, idx] = (cand[i, idx] + 1) % 4
    clen = np.full(B, C, np.int32)
    branches = np.zeros((B, R, S), np.uint8)
    blen = np.zeros((B, R), np.int32)
    err = rng.random((B, R, C)) < 0.08
    noisy = np.where(err, rng.integers(0, 4, (B, R, C)), true[:, None])
    branches[:, :, :C] = noisy
    cut = rng.integers(0, 3, (B, R))
    blen[:] = C - cut
    bmask = rng.random((B, R)) < 0.9
    bmask[:, 0] = True
    return cand, clen, branches, blen, bmask


def _group_lanes(branches, blen, bmask, cand, clen):
    """The scorer's lane layout: 8-branch groups, candidates repeated."""
    import numpy as np
    B, R, S = branches.shape
    g = max(1, -(-R // 8))
    pad = g * 8 - R
    br = np.pad(branches, ((0, 0), (0, pad), (0, 0))).reshape(B * g, 8, S)
    bl = np.pad(blen, ((0, 0), (0, pad))).reshape(B * g, 8)
    bm = np.pad(bmask, ((0, 0), (0, pad))).reshape(B * g, 8)
    return (np.repeat(cand, g, 0), np.repeat(clen, g, 0), br, bl, bm)


def _close(ref, got, what):
    import numpy as np
    ref, got = np.asarray(ref), np.asarray(got)
    check(ref.shape == got.shape, f"{what}: shape {got.shape} != "
          f"{ref.shape}")
    fin = ref > -1e29
    check(np.array_equal(fin, got > -1e29), f"{what}: NEG pattern")
    err = np.abs(np.where(fin, ref - got, 0))
    tol = np.maximum(1e-4, 1e-5 * np.abs(np.where(fin, ref, 0)))
    check(bool((err <= tol).all()),
          f"{what}: max abs err {float(err.max()):.3g}")
    return float(err.max())


def _climb_agreement(ref, got, what):
    """Hill-climb results (cand, len, score) against a reference: the
    final sequences must be identical on >= 99.9% of lanes, and every
    differing lane must end within 1e-3 of the reference score (the
    polisher's acceptance threshold, so such a lane is a tie)."""
    import numpy as np
    cr, lr, sr = (np.asarray(x) for x in ref[:3])
    cg, lg, sg = (np.asarray(x)[:len(lr)] for x in got[:3])
    valid = np.arange(cr.shape[1])[None] < lr[:, None]
    same = (lg == lr) & np.all(np.where(valid, cg == cr, True), 1)
    ties = np.abs(sg - sr) <= 1e-3
    check(same.mean() >= 0.999, f"{what}: identical lanes "
          f"{same.mean():.5f} < 0.999")
    check(bool(ties[~same].all()), f"{what}: a differing lane ends "
          f"beyond 1e-3 of the reference score")
    return float(same.mean()), int((~same).sum()), \
        float(np.abs(sg - sr).max())


def _triton_scorer(lanes, subs_j):
    """The Triton scorer on scoring lanes: tables built once, then one
    jitted scoring pass (what each convergence iteration runs)."""
    import jax
    import jax.numpy as jnp

    from flye_jax.ops import polish_triton as T
    cand, clen, br, bl, bm = (jnp.asarray(a) for a in lanes)
    tables = T.prepare(br, bl, bm, subs_j,
                       T.padded_lanes(br.shape[0], br.shape[2]))
    fn = jax.jit(lambda c, l, t: T.score(c, l, subs_j, t))
    return lambda: fn(cand, clen, tables)


def phase_kernels(card):
    import jax.numpy as jnp
    import numpy as np

    from flye_jax.ops import polish as P
    from flye_jax.polishing.matrices import get_subs_matrix
    from flye_jax.polishing.polisher import _max_batch

    subs = get_subs_matrix("pacbio")
    subs_j = jnp.asarray(subs, jnp.float32)
    rows = []

    # ---- polish: one scoring pass of the kernel vs the CPU jnp ----
    for name, (C, Cb, R, S, B) in POLISH_SHAPES.items():
        B = B or _max_batch(Cb, S, R)
        cand, clen, br, bl, bm = _polish_workload(C, Cb, R, S, B, seed=1)
        lanes = _group_lanes(br, bl, bm, cand, clen)
        n = min(CHECK_LANES, len(lanes[0]))
        ref = _on_cpu(P._score_edits_raw_jnp,
                      *[a[:n] for a in lanes], subs)
        raw, t = timed(_triton_scorer(lanes, subs_j))
        err = max(_close(r, np.asarray(g)[..., :n], f"polish {name} {nm}")
                  for nm, r, g in zip(("total", "del", "ins4", "sub4"),
                                      ref, raw))
        rows.append((f"polish score triton {name} Cb={Cb} R={R} S={S} "
                     f"B={B}", t, err))
        log(f"[kernels] polish score triton {name} (Cb={Cb} R={R} S={S} "
            f"B={B}, {len(lanes[0])} lanes): {t * 1e3:.2f} ms/pass, max "
            f"err vs CPU {err:.2e} ({card})")
        del raw

    # full climb at the fine-bubble shape (the on-device while_loop
    # around the kernel) vs the host-stepped jnp loop on the CPU for a
    # lane slice: final sequences must match, or tie within 1e-3
    C, Cb, R, S, B = POLISH_SHAPES["fine"]
    wl = _polish_workload(C, Cb, R, S, B, seed=2)
    iters = 2 * Cb
    out, t = timed(lambda: P.polish_bubbles(
        *wl, subs, max_iters=iters, route="triton"), reps=1)
    rows.append((f"polish climb triton fine B={B}", t, 0.0))
    n = CHECK_LANES
    ref = _on_cpu(lambda *a: P.polish_bubbles(*a, subs, max_iters=iters,
                                              route="stepped"),
                  *[a[:n] for a in wl])
    same, ndiff, dmax = _climb_agreement(ref, out, "climb vs CPU reference")
    log(f"[kernels] polish climb triton fine B={B}: {t:.3f} s; identical "
        f"lanes vs the CPU reference {same:.5f} ({ndiff} differ, all "
        f"within 1e-3 of the reference score; max score diff "
        f"{dmax:.2e}) ({card})")

    # ---- chain DP: the kernel, bit-exact vs the CPU scan ----
    from flye_jax.ops.chain import _chain_dp_scan
    from flye_jax.ops.chain_triton import chain_dp_triton
    k, max_jump = 15, 1500
    for name, (T, M, L) in CHAIN_SHAPES.items():
        rng = np.random.default_rng(3)
        cur = np.sort(rng.integers(0, 40 * M, (T, M)), 1).astype(np.int32)
        ext = (cur + 500 + rng.integers(-40, 40, (T, M))).astype(np.int32)
        nv = rng.integers(M // 2, M + 1, T).astype(np.int32)
        s_ref, p_ref = _on_cpu(
            lambda a, b, c: _chain_dp_scan(a, b, c, k, max_jump, L),
            cur, ext, nv)
        dev = [jnp.asarray(a) for a in (cur, ext, nv)]
        (sc, pa), t = timed(lambda: chain_dp_triton(
            *dev, k=k, max_jump=max_jump, lookback=L))
        check(np.array_equal(np.asarray(sc), np.asarray(s_ref)) and
              np.array_equal(np.asarray(pa), np.asarray(p_ref)),
              f"chain DP {name} not bit-exact")
        rows.append((f"chain dp triton T={T} M={M} L={L}", t, 0.0))
        log(f"[kernels] chain dp triton {name} (T={T} M={M} L={L}): "
            f"{t * 1e3:.2f} ms, bit-exact vs CPU scan ({card})")
    # native full-window DP where M <= lookback
    from flye_jax import native
    from flye_jax.ops.chain import chain_dp
    mod = native.get()
    T, M = 64, 1024
    rng = np.random.default_rng(4)
    cur = np.sort(rng.integers(0, 40 * M, (T, M)), 1).astype(np.int32)
    ext = (cur + 500 + rng.integers(-40, 40, (T, M))).astype(np.int32)
    nv = np.full(T, M, np.int32)
    s, p = chain_dp(cur, ext, nv, k, max_jump, M)
    _, hs, hp = mod.chain_dp_host(
        np.ascontiguousarray(cur.ravel()), np.ascontiguousarray(ext.ravel()),
        np.arange(T, dtype=np.int64) * M, np.full(T, M, np.int64), T, k,
        max_jump)
    check(np.array_equal(np.asarray(s),
                         np.frombuffer(hs, np.int32).reshape(T, M)) and
          np.array_equal(np.asarray(p),
                         np.frombuffer(hp, np.int32).reshape(T, M)),
          "chain DP not bit-exact vs native chain_dp_host")
    log("[kernels] chain dp M=1024: bit-exact vs native chain_dp_host")

    # ---- edit distance at segment-batcher shapes ----
    from flye_jax.ops.align import SEGMENT_BUCKETS, edit_distance_batch
    for Sb in SEGMENT_BUCKETS:
        Bn = 4096 if Sb <= 256 else 1024
        rng = np.random.default_rng(Sb)
        a = rng.integers(0, 4, (Bn, Sb)).astype(np.uint8)
        b = np.where(rng.random((Bn, Sb)) < 0.1,
                     rng.integers(0, 4, (Bn, Sb)), a).astype(np.uint8)
        al = rng.integers(Sb // 2, Sb + 1, Bn).astype(np.int32)
        bl = rng.integers(Sb // 2, Sb + 1, Bn).astype(np.int32)
        d, t = timed(lambda: edit_distance_batch(a, al, b, bl))
        d_ref = _on_cpu(edit_distance_batch, a, al, b, bl)
        check(np.array_equal(np.asarray(d), np.asarray(d_ref)),
              f"edit distance S={Sb} not bit-exact")
        rows.append((f"edit distance S={Sb} B={Bn}", t, 0.0))
        log(f"[kernels] edit distance S={Sb} B={Bn}: {t * 1e3:.2f} ms, "
            f"bit-exact ({card})")
    return rows


def phase_probe(reads, card):
    """Device index probe vs the native host probe on 1,024 reads."""
    import numpy as np

    from flye_jax.assemble.driver import build_read_index
    from flye_jax.config import Config
    from flye_jax.io import SequenceStore
    store = SequenceStore()
    for name, codes in reads[:4096]:
        store.add(name, codes)
    t0 = time.perf_counter()
    index = build_read_index(store, Config("raw"))
    log(f"[kernels] probe index over 4096 reads built in "
        f"{time.perf_counter() - t0:.1f} s")
    sids = store.ids()[:1024]
    host = index.probe_stream_host(store, sids)
    check(host is not None, "native host probe unavailable")
    index.probe_stream_flat(store, sids)
    t0 = time.perf_counter()
    dev = index.probe_stream_flat(store, sids)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = index.probe_stream_host(store, sids)
    t_host = time.perf_counter() - t0
    for nm, h, d in zip(("g_hit", "row", "fwd", "g_rep", "starts"),
                        host, dev):
        check(np.array_equal(np.asarray(h), np.asarray(d)),
              f"device probe {nm} differs from host probe")
    check(host[5] == dev[5], "probe n_total differs")
    log(f"[kernels] index probe 1024 reads ({host[5]} bp): device "
        f"{t_dev:.3f} s, host {t_host:.3f} s, identical ({card})")
    return [("index probe device 1024 reads", t_dev, 0.0),
            ("index probe host 1024 reads", t_host, 0.0)]


# ---------------------------------------------------------------- phase 3

def _run_cli(reads_path, out_dir, glen, extra=()):
    from flye_jax.main import main as flye_main
    from flye_jax.overlap.engine import phase_times, reset_phase_times
    from flye_jax.utils.logs import reset_stage_walls, stage_walls
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    reset_stage_walls()
    reset_phase_times()
    t0 = time.perf_counter()
    rc = flye_main(["--pacbio-raw", reads_path, "-o", out_dir,
                    "-g", str(glen), *extra])
    wall = time.perf_counter() - t0
    check(rc == 0, f"flye_jax.main returned {rc}")
    return wall, stage_walls(), phase_times()


def _assembly_report(out_dir, genome, card):
    from flye_jax.io.fasta import read_seq_file
    from flye_jax.utils.simulate import genome_coverage, window_identity
    contigs = read_seq_file(os.path.join(out_dir, "assembly.fasta"))
    total = sum(len(s) for _, s in contigs)
    cov = genome_coverage(contigs, genome)
    ident, n_anch, n_win = window_identity(contigs, genome)
    log(f"[e2e] {len(contigs)} contigs, {total} bp (truth "
        f"{len(genome)}), genome coverage {cov:.5f}, window identity "
        f"{ident:.6f} ({n_anch}/{n_win} windows anchored)")
    return contigs, cov, ident


def _memory_line(card):
    import jax

    from flye_jax.utils.logs import host_memory
    stats = jax.local_devices()[0].memory_stats() or {}
    _, peak_rss = host_memory()
    log(f"[e2e] peak HBM {stats.get('peak_bytes_in_use', 0) / 2**30:.2f}"
        f" GiB of {stats.get('bytes_limit', 0) / 2**30:.2f} GiB, peak RSS "
        f"{peak_rss / 2**30:.2f} GiB ({card})")


def phase_e2e(genome, reads_path, card):
    wall, stages, phases = _run_cli(reads_path, os.path.join(_WORK, "asm"),
                                    len(genome))
    log(f"[e2e] CLI wall {wall:.1f} s ({card})")
    for name, sec in stages:
        log(f"[e2e]   {name}: {sec:.1f} s")
    for name, sec in sorted(phases.items()):
        log(f"[e2e]   overlap phase {name}: {sec:.1f} s")
    _memory_line(card)
    contigs, cov, ident = _assembly_report(os.path.join(_WORK, "asm"),
                                           genome, card)
    check(len(contigs) <= 3, f"{len(contigs)} contigs > 3")
    check(cov >= 0.98, f"genome coverage {cov:.4f} < 0.98")
    check(ident >= 0.999, f"window identity {ident:.5f} < 0.999")


def phase_four_preflight(card):
    """The collectives and the sharded device programs of the four-card
    path, each checked against its one-device result before the CLI
    runs them."""
    import jax
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from flye_jax.ops.chain import _chain_dp_multi
    from flye_jax.ops.polish import polish_bubbles
    from flye_jax.parallel.mesh import make_mesh
    from flye_jax.parallel.runtime import ParallelContext, set_runtime
    from flye_jax.polishing.matrices import get_subs_matrix
    mesh = make_mesh(4, axes=("data",))
    x = np.arange(16 * 256, dtype=np.int32).reshape(16, 256)
    t0 = time.perf_counter()
    psum = jax.jit(jax.shard_map(lambda a: jax.lax.psum(a, "data"),
                                 mesh=mesh, in_specs=P("data"),
                                 out_specs=P("data"), check_vma=False))
    check(np.array_equal(np.asarray(psum(x)),
                         np.tile(x.reshape(4, 4, 256).sum(0), (4, 1))),
          "psum across four cards")
    a2a = jax.jit(jax.shard_map(
        lambda a: jax.lax.all_to_all(a, "data", 0, 0, tiled=True),
        mesh=mesh, in_specs=P("data"), out_specs=P("data")))
    check(np.array_equal(np.asarray(a2a(x)), x.reshape(4, 4, 256)
                         .transpose(1, 0, 2).reshape(16, 256)),
          "all_to_all across four cards")
    log(f"[four] psum + all_to_all across 4 cards: correct, "
        f"{time.perf_counter() - t0:.1f} s with compiles ({card})")

    subs = get_subs_matrix("pacbio")
    wl = _polish_workload(16, 24, 32, 40, 4096, seed=5)
    outs = []
    try:
        for ctx in (ParallelContext(), ParallelContext(mesh)):
            set_runtime(ctx)
            t0 = time.perf_counter()
            outs.append(jax.block_until_ready(polish_bubbles(
                *wl, subs, max_iters=48, route="triton")))
            log(f"[four] polish climb B=4096 over {ctx.n_devices} card(s):"
                f" {time.perf_counter() - t0:.1f} s with compile ({card})")
    finally:
        set_runtime(None)
    same, ndiff, dmax = _climb_agreement(outs[0], outs[1],
                                         "sharded polish climb")
    log(f"[four] polish climb over 4 cards vs 1: identical lanes "
        f"{same:.5f} ({ndiff} differ, all within 1e-3 of the one-card "
        f"score; max score diff {dmax:.2e})")

    rng = np.random.default_rng(6)
    T, M = 128, 4096
    cur = np.sort(rng.integers(0, 40 * M, (T, M)), 1).astype(np.int32)
    ext = (cur + 500 + rng.integers(-40, 40, (T, M))).astype(np.int32)
    nv = rng.integers(M // 2, M + 1, T).astype(np.int32)
    res = []
    for m in (None, mesh):
        t0 = time.perf_counter()
        res.append(np.asarray(_chain_dp_multi(
            ((cur, ext, nv),), k=15, max_jump=1500, lookback=1024,
            route="triton", mesh=m)))
        log(f"[four] chain dp T={T} M={M} over "
            f"{1 if m is None else 4} card(s): "
            f"{time.perf_counter() - t0:.1f} s with compile ({card})")
    check(np.array_equal(*res), "sharded chain DP differs")
    log("[four] chain DP over 4 cards bit-identical to one card")


def phase_four_cards(genome, reads_path, card):
    """The deployment through the CLI with --shards 4, then --shards 1;
    each assembly is scored against the truth as soon as it exists."""
    from flye_jax.io.fasta import read_seq_file
    idents, asm = {}, {}
    for shards in (4, 1):
        out = os.path.join(_WORK, f"asm_shards{shards}")
        log(f"[four] --shards {shards}: CLI run started")
        wall, stages, _ = _run_cli(reads_path, out, len(genome),
                                   ("--shards", str(shards)))
        log(f"[four] --shards {shards}: CLI wall {wall:.1f} s ({card})")
        for name, sec in stages:
            log(f"[four]   {name}: {sec:.1f} s")
        _, _, idents[shards] = _assembly_report(out, genome, card)
        asm[shards] = os.path.join(out, "assembly.fasta")
    _memory_line(card)
    if open(asm[4], "rb").read() == open(asm[1], "rb").read():
        log("[four] assembly.fasta byte-identical across --shards 4/1")
    else:
        c4, c1 = read_seq_file(asm[4]), read_seq_file(asm[1])
        ndiff = sum(int((a[:min(len(a), len(b))] !=
                         b[:min(len(a), len(b))]).sum())
                    + abs(len(a) - len(b))
                    for (_, a), (_, b) in zip(c4, c1))
        log(f"[four] assemblies differ: {len(c4)} vs {len(c1)} contigs, "
            f"{ndiff} differing positions")
    check(idents[4] >= idents[1], "four-card identity below one-card")


# ------------------------------------------------------------------ main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded comparison")
    ap.add_argument("--genome-mb", type=float, default=4.6,
                    help="deployment genome size in Mb (default 4.6)")
    ap.add_argument("--deadline", type=float, default=1150.0,
                    help="seconds before the stacks are dumped and the "
                    "run fails (default 1150)")
    args = ap.parse_args()
    faulthandler.dump_traceback_later(args.deadline, exit=True)
    if not args.four_cards:
        # one process, one card: hide the others before JAX starts
        os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    count = 4 if args.four_cards else 1
    try:
        card, d0 = phase_device(count)
        from flye_jax.utils.simulate import isolate_deployment, write_reads
        glen = int(args.genome_mb * 1_000_000)
        t0 = time.perf_counter()
        genome, reads = isolate_deployment(glen, 30.0)
        if os.path.isdir(_WORK):
            shutil.rmtree(_WORK)
        os.makedirs(_WORK)
        reads_path = os.path.join(_WORK, "reads.fasta")
        write_reads(reads, reads_path)
        log(f"[setup] {len(reads)} reads, {sum(len(r) for _, r in reads)}"
            f" bp simulated in {time.perf_counter() - t0:.1f} s")
        if args.four_cards:
            phase_four_preflight(card)
            phase_four_cards(genome, reads_path, card)
        else:
            rows = phase_kernels(card)
            rows += phase_probe(reads, card)
            del reads
            phase_e2e(genome, reads_path, card)
            os.makedirs(_OUT, exist_ok=True)
            with open(os.path.join(_OUT, "kernels.json"), "w") as f:
                json.dump({"card": card, "rows": rows}, f, indent=1)
    except Exception as e:  # every phase failure ends the run non-zero
        traceback.print_exc()
        print(f"SMOKE FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        for run in ("asm", "asm_shards4", "asm_shards1"):
            log_src = os.path.join(_WORK, run, "flye.log")
            if os.path.exists(log_src):
                os.makedirs(_OUT, exist_ok=True)
                shutil.copy(log_src, os.path.join(_OUT, f"{run}.log"))
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
