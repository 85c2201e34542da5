"""Metagenome-mode scale validation: uneven-coverage community
(VERDICT round-4 item 8; reference rows: docs/USAGE.md:334-336).

Simulates a community of several species at strongly uneven abundances
and runs `--meta`.  Every species above the coverage floor should
assemble into its own contig(s); the uneven-coverage solid-kmer
selection (reference: vertex_index.cpp uneven-coverage mode) and the
meta chimera thresholds are what is under test at pipeline scale.

Usage: python scripts/run_meta.py [outdir]
       (community spec is fixed: ~12 Mb total, coverages 50/25/10/5)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SPECIES = [  # (length, coverage, seed)
    (4_000_000, 50.0, 21),
    (3_000_000, 25.0, 22),
    (3_000_000, 10.0, 23),
    (2_000_000, 5.0, 24),
]


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "meta_out"

    from flye_jax.io.fasta import read_seq_file, write_fasta
    from flye_jax.utils.simulate import random_genome, simulate_reads

    genomes = []
    reads = []
    for i, (glen, cov, seed) in enumerate(SPECIES):
        g = random_genome(glen, seed=seed)
        genomes.append(g)
        rs = simulate_reads(g, coverage=cov, mean_length=8000,
                            error_rate=0.08, seed=seed + 100)
        reads.extend((f"s{i}_{n}", s) for n, s in rs)
        print(f"[meta] species {i}: {glen} bp at {cov}x -> "
              f"{len(rs)} reads", flush=True)
    rng = np.random.default_rng(0)
    order = rng.permutation(len(reads))
    reads = [reads[j] for j in order]
    reads_path = outdir + ".reads.fasta"
    write_fasta(reads, reads_path)
    total_g = sum(len(g) for g in genomes)
    print(f"[meta] community {total_g} bp, "
          f"{sum(len(s) for _, s in reads)} read bases", flush=True)

    from flye_jax.main import main as flye_main
    t0 = time.perf_counter()
    rc = flye_main(["--pacbio-raw", reads_path, "-o", outdir,
                    "-g", f"{total_g}", "--meta"])
    wall = time.perf_counter() - t0
    print(f"[meta] rc={rc} wall={wall:.0f}s", flush=True)
    if rc != 0:
        sys.exit(rc)

        from flye_jax.utils.simulate import window_identity
    contigs = read_seq_file(outdir + "/assembly.fasta")
    print(f"[meta] {len(contigs)} contigs, "
          f"{sum(len(s) for _, s in contigs)} bp total", flush=True)
    # per-species recovery: identity of each species genome vs the
    # contig set (window sampling anchors into whichever contig holds
    # the species)
    for i, g in enumerate(genomes):
        ident, n_anch, n_samp = window_identity(contigs, g,
                                                n_windows=200)
        print(f"[meta] species {i} ({len(g)} bp @ {SPECIES[i][1]}x): "
              f"identity {ident:.5f} ({n_anch}/{n_samp} windows "
              f"anchored)", flush=True)


if __name__ == "__main__":
    main()
