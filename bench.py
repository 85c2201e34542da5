"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline: polishing throughput (bubbles/s) on the device JAX runs on —
the dominant cost of reference Flye's consensus+polish phases
(BASELINE.json: "overlap+polish phases").  The line names the device
(platform, device_kind, count) and the card's nvidia-smi name and
power limit where there is one.

vs_baseline: reference Flye 2.8.1 (CPU, measured by an earlier round on
a 2-thread host, PARITY.md) run on the 420 kb toy genome at 30x spends
31 s x 2 cores across its consensus+polishing stages (minimap2 + bubble
extraction + C++ polisher), i.e. 2 x 419,768 bases / 62 core-s =
13,540 polished bases per core-second at stage level.  vs_baseline =
bubbles/s x bubble_bases / 13,540 — device kernel-only on our side,
full stage on theirs.

Secondary measurements follow on stderr: chain-DP cell rate, the
overlap phase end-to-end (solid-kmer index build + all-vs-all overlap
detection on freshly simulated reads), and the host vs device index
probe.  A failing phase fails the run.
"""

import json
import sys
import time

import numpy as np

_REFERENCE_BASES_PER_CORE_S = 13540.0  # measured, see module docstring
_BENCH_BUBBLE_BASES = 16.0  # production fine-bubble candidate length


def make_polish_workload(B, C=120, Cb=160, R=16, S=240, errs=6, seed=0):
    rng = np.random.default_rng(seed)
    true = rng.integers(0, 4, size=(B, C)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :C] = true
    for i in range(B):
        idx = rng.integers(0, C, errs)
        cand[i, idx] = (cand[i, idx] + 1) % 4
    clen = np.full(B, C, np.int32)
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :C] = true[:, None, :]
    # mild per-lane perturbation defeats any transport-level caching
    for i in range(B):
        p = int(rng.integers(0, C))
        branches[i, :, p] = (branches[i, :, p] + rng.integers(0, 2)) % 4
    blen = np.full((B, R), C, np.int32)
    bmask = np.ones((B, R), bool)
    return cand, clen, branches, blen, bmask


def device_info():
    """JAX's device description plus nvidia-smi's name and power limit
    (None off a GPU host)."""
    import subprocess

    import jax
    d = jax.devices()
    card = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if out.returncode == 0:
            card = out.stdout.strip().splitlines()[0]
    except OSError:
        pass
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "card": card}


def bench_polish(B=8192, reps=2, max_iters=24):
    """Headline workload = the PRODUCTION bubble shape: the round-3
    fine partition polishes ~15 bp bubbles with ~30 branches (matching
    the reference's own granularity — its parity run makes 28,392
    ~15 bp bubbles on the 420 kb set).  C=16/Cb=24/R=32/S=40."""
    import jax

    from flye_jax.ops.polish import polish_bubbles
    from flye_jax.polishing.matrices import get_subs_matrix

    C, Cb, R, S, errs = 16, 24, 32, 40, 1
    subs = get_subs_matrix("pacbio")
    args = make_polish_workload(B, C=C, Cb=Cb, R=R, S=S, errs=errs,
                                seed=99)
    out = polish_bubbles(*args, subs, max_iters=max_iters)  # compile
    jax.block_until_ready(out)
    times = []
    for rep in range(reps):
        args = make_polish_workload(B, C=C, Cb=Cb, R=R, S=S,
                                    errs=errs, seed=rep)
        t0 = time.perf_counter()
        out = polish_bubbles(*args, subs, max_iters=max_iters)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return B / min(times)


def bench_chain():
    import jax

    from flye_jax.ops.chain import chain_dp

    k, max_jump, lookback = 17, 1500, 512
    T, M = 256, 2048
    rng = np.random.default_rng(0)
    cur = np.sort(rng.integers(0, 40000, size=(T, M)), axis=1).astype(
        np.int32)
    ext = (cur + 500 + rng.integers(-40, 40, size=(T, M))).astype(np.int32)
    nvalid = np.full(T, M, dtype=np.int32)
    out = chain_dp(cur, ext, nvalid, k, max_jump, lookback)
    jax.block_until_ready(out)
    times = []
    for rep in range(8):  # min over reps
        t0 = time.perf_counter()
        out = chain_dp(cur, ext + rep, nvalid, k, max_jump, lookback)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return T * M * lookback / min(times) / 1e9  # Gcells/s


def bench_overlap_phase(genome_kb=500, coverage=20):
    """Overlap phase end-to-end on real simulated reads: solid-kmer
    index build + all-vs-all overlap prefetch (the reference's
    `flye-modules assemble` hot path).  Returns (reads/s, Mbases/s)."""
    from flye_jax.config import Config
    from flye_jax.io.seqstore import SequenceStore
    from flye_jax.overlap import OverlapEngine, OverlapStore
    from flye_jax.utils.simulate import random_genome, simulate_reads

    genome = random_genome(genome_kb * 1000, seed=4)
    reads = simulate_reads(genome, coverage=coverage, mean_length=8000,
                           error_rate=0.08, error_mix=(0.2, 0.5, 0.3),
                           seed=5)
    store = SequenceStore()
    for n, c in reads:
        store.add(n, c)
    cfg = Config("raw", min_overlap=5000)
    from flye_jax.assemble.driver import build_read_index
    t0 = time.perf_counter()
    index = build_read_index(store, cfg)
    t_index = time.perf_counter() - t0
    engine = OverlapEngine(store, index, max_jump=cfg.maximum_jump,
                           min_overlap=5000,
                           max_overhang=cfg.maximum_overhang,
                           only_max_ext=True)
    ovlp = OverlapStore(engine, store)
    from flye_jax.overlap.engine import phase_times, reset_phase_times
    reset_phase_times()
    t0 = time.perf_counter()
    ovlp.prefetch(store.ids())
    t_prefetch = time.perf_counter() - t0
    n_ovl = sum(len(v[0]) for v in ovlp._cache.values())
    total = t_index + t_prefetch
    print(f"overlap_phase: {len(store)} reads "
          f"({store.total_length/1e6:.1f} Mb), index {t_index:.1f}s + "
          f"ava {t_prefetch:.1f}s = {total:.1f}s, {n_ovl} overlaps, "
          f"{len(store)/total:.1f} reads/s, "
          f"{store.total_length/1e6/total:.2f} Mbases/s",
          file=sys.stderr)
    # per-phase attribution (wall, overlapped across the 2-deep thread
    # pipeline, so phases can sum to more than the ava wall)
    ph = phase_times()
    print("overlap phases: " + ", ".join(
        f"{k} {v:.1f}s" for k, v in sorted(ph.items())), file=sys.stderr)
    return len(store) / total, store.total_length / 1e6 / total


def bench_probe_paths(genome_kb=2000, coverage=20, batch_reads=1024):
    """Host vs device index probe at a production batch size: one
    ava-sized batch (~8 MB of query stream) against a solid-kmer index
    on both paths, outputs checked identical."""
    import time as _t

    from flye_jax.config import Config
    from flye_jax.assemble.driver import build_read_index
    from flye_jax.io.seqstore import SequenceStore
    from flye_jax.utils.simulate import random_genome, simulate_reads

    genome = random_genome(genome_kb * 1000, seed=4)
    reads = simulate_reads(genome, coverage=coverage, mean_length=8000,
                           error_rate=0.08, error_mix=(0.2, 0.5, 0.3),
                           seed=5)
    store = SequenceStore()
    for n, c in reads:
        store.add(n, c)
    cfg = Config("raw", min_overlap=5000)
    index = build_read_index(store, cfg)
    sids = store.ids()[:batch_reads]
    n_bases = sum(store.length(s) for s in sids)

    # host path (native threaded, 16-bit prefix LUT)
    t0 = _t.perf_counter()
    host_res = index.probe_stream_host(store, sids)
    t_host = _t.perf_counter() - t0
    if host_res is None:
        raise RuntimeError("native module unavailable")

    # device path (flat-stream packed kernel): warm then measure
    index.probe_stream_flat(store, sids)
    t0 = _t.perf_counter()
    dev_res = index.probe_stream_flat(store, sids)
    t_dev = _t.perf_counter() - t0
    same = (len(host_res[0]) == len(dev_res[0])
            and np.array_equal(host_res[0], dev_res[0])
            and np.array_equal(host_res[1], dev_res[1]))
    if not same:
        raise RuntimeError("device probe differs from host probe")
    print(f"probe_paths: batch {len(sids)} reads / {n_bases/1e6:.1f} "
          f"Mb, host {t_host:.2f}s ({n_bases/1e6/t_host:.1f} Mb/s) vs "
          f"device {t_dev:.2f}s ({n_bases/1e6/t_dev:.1f} Mb/s), "
          f"outputs identical", file=sys.stderr)


def main():
    rate = bench_polish()
    print(json.dumps({
        "metric": "polish_throughput",
        "value": round(rate, 1),
        "unit": "bubbles/s",
        "vs_baseline": round(rate * _BENCH_BUBBLE_BASES
                             / _REFERENCE_BASES_PER_CORE_S, 1),
        "device": device_info(),
    }), flush=True)
    print(f"chain_dp: {bench_chain():.2f} Gcells/s", file=sys.stderr)
    bench_overlap_phase()
    bench_probe_paths()


if __name__ == "__main__":
    main()
