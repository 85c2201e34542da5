"""Reference-parity harness (BASELINE target 1 / VERDICT round-2 item 3).

Simulates PacBio-raw reads from the reference's bundled 420 kb E. coli
fragment (reference: flye/tests/data/ecoli_500kb.fasta — the real toy
genome; its read FASTQs are missing blobs), runs BOTH pipelines on the
identical read set, and prints a comparison table:
contig count / total length / NG50 / window identity vs truth.

Usage:
  python scripts/run_parity.py simulate OUT_READS.fasta
  python scripts/run_parity.py compare TRUTH.fasta OUT_A/assembly.fasta \
      OUT_B/assembly.fasta ...
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

TRUTH = "/root/reference/flye/tests/data/ecoli_500kb.fasta"


def ng50(lengths, genome_size):
    acc = 0
    for ln in sorted(lengths, reverse=True):
        acc += ln
        if acc >= genome_size / 2:
            return ln
    return 0


def simulate(out_path):
    from flye_jax.io.fasta import read_seq_file, write_fasta
    from flye_jax.utils.simulate import simulate_reads

    genome = read_seq_file(TRUTH)[0][1]
    reads = simulate_reads(genome, coverage=30, mean_length=8000,
                           min_length=3000, error_rate=0.08,
                           error_mix=(0.2, 0.5, 0.3), circular=False,
                           seed=42)
    write_fasta(reads, out_path)
    print(f"[parity] {len(reads)} reads, "
          f"{sum(len(s) for _, s in reads)} bases from {len(genome)} bp "
          f"truth", flush=True)


def compare(truth_path, *assemblies):
    from flye_jax.io.fasta import read_seq_file
    from flye_jax.utils.simulate import window_identity

    genome = read_seq_file(truth_path)[0][1]
    print(f"{'assembly':40} {'#ctg':>5} {'total':>9} {'NG50':>9} "
          f"{'identity':>9}")
    for path in assemblies:
        contigs = read_seq_file(path)
        lens = [len(s) for _, s in contigs]
        ident, n_anch, n_samp = window_identity(contigs, genome,
                                                n_windows=300, win=2000)
        print(f"{path:40} {len(contigs):>5} {sum(lens):>9} "
              f"{ng50(lens, len(genome)):>9} {ident:>9.5f} "
              f"({n_anch}/{n_samp} anchored)", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "simulate":
        simulate(sys.argv[2])
    else:
        compare(*sys.argv[2:])
