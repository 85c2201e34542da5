"""Scaffold composition tests (reference: flye/assembly/scaffolder.py).

The reference reverse-complements '-'-oriented members when stitching a
scaffold (reference: flye/assembly/scaffolder.py:30-56,66-73); these
tests pin that behavior plus the signed bidirectional walk.
"""

import numpy as np

from flye_jax.contigger.extender import ContigInfo
from flye_jax.io.fasta import codes_to_str, str_to_codes
from flye_jax.pipeline.scaffolder import build_scaffolds, write_assembly


def _contig(num, seq):
    codes = str_to_codes(seq)
    return ContigInfo(name=f"contig_{num}", sequence=codes,
                      length=len(codes), coverage=30, circular=False,
                      repetitive=False, multiplicity=1, alt_group=-1,
                      graph_path=str(num))


def _revcomp(s):
    return codes_to_str((3 - str_to_codes(s))[::-1])


def _read_fasta(path):
    seqs = {}
    name = None
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                name = line[1:].strip()
                seqs[name] = []
            else:
                seqs[name].append(line.strip())
    return {k: "".join(v) for k, v in seqs.items()}


def test_reverse_oriented_link_gets_rc_sequence(tmp_path):
    s1 = "ACGTACGTACGTACGTAAAA"
    s2 = "TTGGCCAATTGGCCAACCGG"
    contigs = [_contig(1, s1), _contig(2, s2)]
    # link: contig_1 forward -> contig_2 reverse-oriented
    scaffolds = build_scaffolds(contigs, [("+1", "-2")])
    assert scaffolds == {"scaffold_1": ["+contig_1", "-contig_2"]}

    fasta = tmp_path / "assembly.fasta"
    info = tmp_path / "assembly_info.txt"
    write_assembly(contigs, scaffolds, str(fasta), str(info))
    seqs = _read_fasta(fasta)
    assert seqs["scaffold_1"] == s1 + "N" * 100 + _revcomp(s2)


def test_walk_extends_both_directions():
    contigs = [_contig(i, "ACGT" * 5) for i in (1, 2, 3)]
    # 1 -> 2 -> 3; seeding the walk at contig_2 must still produce the
    # full chain (the reference walks left, flips, then walks right)
    scaffolds = build_scaffolds(
        [contigs[1], contigs[0], contigs[2]],
        [("+1", "+2"), ("+2", "+3")])
    assert scaffolds == {
        "scaffold_1": ["+contig_1", "+contig_2", "+contig_3"]}


def test_reverse_entry_into_link_map():
    # a link stated as (-2, -1) must also let a walk seeded at contig_1
    # traverse forward: rc of the link is (+1, +2)
    contigs = [_contig(1, "ACGT" * 5), _contig(2, "TTGG" * 5)]
    scaffolds = build_scaffolds(contigs, [("-2", "-1")])
    assert scaffolds == {"scaffold_1": ["+contig_1", "+contig_2"]}


def test_singleton_keeps_plain_name(tmp_path):
    contigs = [_contig(7, "ACGTACGTAC")]
    scaffolds = build_scaffolds(contigs, [])
    assert scaffolds == {"contig_7": ["+contig_7"]}
    fasta = tmp_path / "assembly.fasta"
    write_assembly(contigs, scaffolds, str(fasta),
                   str(tmp_path / "info.txt"))
    assert _read_fasta(fasta)["contig_7"] == "ACGTACGTAC"
