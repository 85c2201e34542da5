"""Scale validation: multi-Mb simulated genome through the CLI.

Generates an N-Mb genome (with planted repeats), simulates reads, runs
the full pipeline, and reports per-stage wall times plus a
window-sampled identity estimate vs the truth genome.

Usage: python scripts/run_scale.py [genome_mb] [coverage] [outdir] [mode]

mode: pacbio-raw (default) | nano-raw | pacbio-hifi — picks the CLI
read-type flag and a matching simulated error profile
(flye_jax.utils.simulate.READ_PROFILES).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    mb = float(sys.argv[1]) if len(sys.argv) > 1 else 2.5
    cov = float(sys.argv[2]) if len(sys.argv) > 2 else 30.0
    outdir = sys.argv[3] if len(sys.argv) > 3 else "scale_out"
    mode = sys.argv[4] if len(sys.argv) > 4 else "pacbio-raw"

    from flye_jax.io.fasta import read_seq_file
    from flye_jax.utils.simulate import (isolate_deployment,
                                         window_identity, write_reads)

    glen = int(mb * 1_000_000)
    print(f"[scale] genome {glen} bp, coverage {cov}x, mode {mode}",
          flush=True)
    t0 = time.perf_counter()
    genome, reads = isolate_deployment(glen, cov, mode)
    print(f"[scale] simulated {len(reads)} reads in "
          f"{time.perf_counter() - t0:.0f}s", flush=True)
    os.makedirs(outdir, exist_ok=True)
    reads_path = os.path.join(outdir, "reads.fasta")
    write_reads(reads, reads_path)

    from flye_jax.main import main as flye_main
    t0 = time.perf_counter()
    rc = flye_main([f"--{mode}", reads_path, "-o", outdir,
                    "-g", f"{glen}"])
    wall = time.perf_counter() - t0
    print(f"[scale] pipeline rc={rc} wall={wall:.0f}s", flush=True)
    if rc != 0:
        sys.exit(rc)

    contigs = read_seq_file(os.path.join(outdir, "assembly.fasta"))
    total = sum(len(s) for _, s in contigs)
    print(f"[scale] {len(contigs)} contigs, {total} bp "
          f"(truth {glen})", flush=True)
    for name, seq in contigs:
        print(f"[scale]   {name}: {len(seq)} bp", flush=True)
    ident, n_anch, n_win = window_identity(contigs, genome)
    print(f"[scale] window identity {ident:.5f} "
          f"({n_anch}/{n_win} windows anchored)", flush=True)


if __name__ == "__main__":
    main()
