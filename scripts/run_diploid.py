"""Heterozygous diploid pipeline-scale validation (VERDICT round-4
item 8).

Simulates a diploid: haplotype A = random genome; haplotype B = A with
heterozygous SNPs (rate --snp, default 0.3%) plus small structural
variants (insertions/deletions of 50-500 bp, one per ~250 kb).  Reads
draw from both haplotypes 50/50.  The assembly should COLLAPSE the
haplotypes into one consensus by default (the reference's haplotype
machinery — bulges/superbubbles/roundabouts,
reference: src/repeat_graph/haplotype_resolver.cpp:13-133 — masks the
alternative alleles), and keep the alternative structures with
--keep-haplotypes (reference: docs/USAGE.md --keep-haplotypes).

Usage: python scripts/run_diploid.py [genome_mb] [coverage] [outdir]
       [--keep]

Reports: contig stats, window identity vs haplotype A (collapsed
consensus sits between haplotypes: identity floor ~= 1 - snp_rate/2 on
het sites; with 0.3% het SNPs that is >= 0.9985 plus polish residue),
and the identity vs the better of the two haplotypes per window.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_diploid(glen: int, snp_rate: float = 0.003, sv_every: int = 250_000,
                 seed: int = 17):
    from flye_jax.utils.simulate import random_genome

    rng = np.random.default_rng(seed)
    hap_a = random_genome(glen, seed=seed, repeat_spec=[(5000, 3)])
    # SNPs
    n_snp = int(glen * snp_rate)
    pos = rng.choice(glen, size=n_snp, replace=False)
    hap_b = hap_a.copy()
    hap_b[pos] = (hap_b[pos] + rng.integers(1, 4, n_snp)) % 4
    # small SVs: alternate 50-500 bp insertions and deletions
    parts = []
    prev = 0
    n_sv = max(1, glen // sv_every)
    sv_pos = np.sort(rng.choice(glen - 1000, size=n_sv, replace=False))
    for i, p in enumerate(sv_pos):
        p = int(p)
        if p < prev:
            continue
        parts.append(hap_b[prev:p])
        ln = int(rng.integers(50, 500))
        if i % 2 == 0:
            parts.append(rng.integers(0, 4, ln).astype(np.uint8))  # ins
            prev = p
        else:
            prev = p + ln                                          # del
    parts.append(hap_b[prev:])
    hap_b = np.concatenate(parts)
    return hap_a, hap_b, n_snp, n_sv


def main():
    mb = float(sys.argv[1]) if len(sys.argv) > 1 else 5.0
    cov = float(sys.argv[2]) if len(sys.argv) > 2 else 40.0
    outdir = sys.argv[3] if len(sys.argv) > 3 else "diploid_out"
    keep = "--keep" in sys.argv

    from flye_jax.io.fasta import read_seq_file, write_fasta
    from flye_jax.utils.simulate import simulate_reads

    glen = int(mb * 1_000_000)
    hap_a, hap_b, n_snp, n_sv = make_diploid(glen)
    print(f"[diploid] hapA {len(hap_a)} bp, hapB {len(hap_b)} bp, "
          f"{n_snp} het SNPs, {n_sv} SVs", flush=True)
    reads_a = simulate_reads(hap_a, coverage=cov / 2, mean_length=8000,
                             error_rate=0.08, seed=7)
    reads_b = simulate_reads(hap_b, coverage=cov / 2, mean_length=8000,
                             error_rate=0.08, seed=8)
    reads = ([(f"a_{n}", s) for n, s in reads_a]
             + [(f"b_{n}", s) for n, s in reads_b])
    reads_path = outdir + ".reads.fasta"
    write_fasta(reads, reads_path)
    print(f"[diploid] {len(reads)} reads "
          f"({sum(len(s) for _, s in reads)} bases)", flush=True)

    from flye_jax.main import main as flye_main
    args = ["--pacbio-raw", reads_path, "-o", outdir, "-g", f"{glen}"]
    if keep:
        args.append("--keep-haplotypes")
    t0 = time.perf_counter()
    rc = flye_main(args)
    wall = time.perf_counter() - t0
    print(f"[diploid] rc={rc} wall={wall:.0f}s keep={keep}", flush=True)
    if rc != 0:
        sys.exit(rc)

        from flye_jax.utils.simulate import window_identity
    contigs = read_seq_file(outdir + "/assembly.fasta")
    total = sum(len(s) for _, s in contigs)
    print(f"[diploid] {len(contigs)} contigs, {total} bp "
          f"(hapA {len(hap_a)})", flush=True)
    for name, seq in contigs:
        print(f"[diploid]   {name}: {len(seq)} bp", flush=True)
    ia, na, sa = window_identity(contigs, hap_a)
    ib, nb_, sb = window_identity(contigs, hap_b)
    print(f"[diploid] identity vs hapA {ia:.5f} ({na}/{sa}), "
          f"vs hapB {ib:.5f} ({nb_}/{sb})", flush=True)


if __name__ == "__main__":
    main()
