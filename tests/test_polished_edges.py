"""Polished graph-edge splicing (reference: flye/polishing/polish.py:142-207)."""

import numpy as np

from flye_jax.io.fasta import codes_to_str, write_fasta
from flye_jax.polishing.polished_edges import (generate_polished_gfa,
                                               polish_edge_sequences)
from flye_jax.utils.simulate import random_genome


def _noisy(seq, every=150, seed=3):
    rng = np.random.default_rng(seed)
    out = seq.copy()
    for pos in range(every, len(seq) - 1, every):
        out[pos] = (out[pos] + rng.integers(1, 4)) % 4
    return out


def test_polish_edge_sequences_replaces_errors():
    genome = random_genome(30000, seed=11)
    edge_true = genome[2000:22000]
    edge_noisy = _noisy(edge_true)
    updated = polish_edge_sequences(
        [("edge_1", edge_noisy)], [("contig_1", genome)])
    assert "edge_1" in updated
    new = updated["edge_1"]
    # the polished slice must be error-free genome sequence
    assert codes_to_str(new) in codes_to_str(genome)
    assert abs(len(new) - len(edge_true)) < 0.05 * len(edge_true)
    assert codes_to_str(new) != codes_to_str(edge_noisy)


def test_polish_edge_reverse_strand():
    from flye_jax.io.fasta import reverse_complement
    genome = random_genome(26000, seed=12)
    edge_true = reverse_complement(genome[1000:21000])
    edge_noisy = _noisy(edge_true)
    updated = polish_edge_sequences(
        [("edge_1", edge_noisy)], [("contig_1", genome)])
    assert "edge_1" in updated
    new = updated["edge_1"]
    # polished sequence comes out in edge orientation (rc of the contig)
    assert codes_to_str(reverse_complement(new)) in codes_to_str(genome)


def test_generate_polished_gfa(tmp_path):
    genome = random_genome(24000, seed=13)
    edge_noisy = _noisy(genome[500:20500])
    short_name = "edge_2"  # too short to map; must pass through unchanged
    edges_fa = tmp_path / "graph_final.fasta"
    write_fasta([("edge_1", edge_noisy),
                 (short_name, genome[100:300])], str(edges_fa))
    gfa_in = tmp_path / "graph_final.gfa"
    with open(gfa_in, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        f.write(f"S\tedge_1\t{codes_to_str(edge_noisy)}\tdp:i:30\n")
        f.write(f"S\t{short_name}\t{codes_to_str(genome[100:300])}"
                "\tdp:i:7\n")
        f.write("L\tedge_1\t+\tedge_2\t+\t0M\n")
    gfa_out = tmp_path / "polished_edges.gfa"
    n = generate_polished_gfa(str(edges_fa), str(gfa_in),
                              [("contig_1", genome)], str(gfa_out))
    assert n == 1
    lines = open(gfa_out).read().splitlines()
    s_lines = {l.split("\t")[1]: l.split("\t") for l in lines
               if l.startswith("S")}
    assert s_lines["edge_1"][2] != codes_to_str(edge_noisy)
    assert s_lines["edge_1"][2] in codes_to_str(genome)
    assert s_lines["edge_1"][3] == "dp:i:30"  # coverage tag preserved
    assert s_lines[short_name][2] == codes_to_str(genome[100:300])
    assert any(l.startswith("L\t") for l in lines)
