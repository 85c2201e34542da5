"""Scaffolding and final assembly statistics.

Behavioral port of flye/assembly/scaffolder.py: chain contigs along
scaffold links with 100-N gaps (:20-78), generate assembly_info.txt
(:104-213) and the N50 summary log.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np

from flye_jax.config.params import PIPELINE
from flye_jax.contigger.extender import ContigInfo
from flye_jax.io.fasta import codes_to_str

logger = logging.getLogger("flye_jax")


def _rc_sign(sign: str) -> str:
    return "-" if sign == "+" else "+"


def build_scaffolds(contigs: List[ContigInfo],
                    links: Sequence[Tuple[str, str]]
                    ) -> Dict[str, List[str]]:
    """Chain contigs into scaffolds following signed link pairs
    (reference: scaffolder.py:20-78 generate_scaffolds).

    Links carry signed unbranching-path names ('+3', '-5'); members are
    returned as signed contig names ('+contig_3') so the writer knows
    which ones to reverse-complement — the reference flips
    '-'-oriented members when composing the scaffold sequence
    (reference: scaffolder.py:66-73)."""
    names = {c.name for c in contigs}
    # bidirectional connection map over signed contig names; the rc
    # entry mirrors the link for walks arriving from the other side
    # (reference: scaffolder.py:27-34)
    connections: Dict[str, str] = {}
    for a, b in links:
        sa = a[0] if a[0] in "+-" else "+"
        sb = b[0] if b[0] in "+-" else "+"
        ca = f"contig_{a.lstrip('+-')}"
        cb = f"contig_{b.lstrip('+-')}"
        if ca in names and cb in names:
            connections[sa + ca] = sb + cb
            connections[_rc_sign(sb) + cb] = _rc_sign(sa) + ca

    scaffolds: Dict[str, List[str]] = {}
    used = set()
    for c in contigs:
        if c.name in used:
            continue
        used.add(c.name)
        # extend left (via the '-' orientation), flip, then extend right
        # (reference: scaffolder.py:40-57)
        scf = ["-" + c.name]
        while (scf[-1] in connections and
               connections[scf[-1]][1:] not in used):
            scf.append(connections[scf[-1]])
            used.add(scf[-1][1:])
        scf = [_rc_sign(m[0]) + m[1:] for m in scf][::-1]
        while (scf[-1] in connections and
               connections[scf[-1]][1:] not in used):
            scf.append(connections[scf[-1]])
            used.add(scf[-1][1:])
        if len(scf) == 1:
            scaffolds[c.name] = scf
        else:
            num = scf[0][1:].replace("contig_", "")
            scaffolds[f"scaffold_{num}"] = scf
    return scaffolds


def write_assembly(contigs: List[ContigInfo],
                   scaffolds: Dict[str, List[str]],
                   fasta_out: str, info_out: str) -> None:
    """Write assembly.fasta (with 100-N scaffold gaps) and
    assembly_info.txt (reference: scaffolder.py:104-213)."""
    by_name = {c.name: c for c in contigs}
    gap = "N" * int(PIPELINE["scaffold_gap"])
    records = []
    info_rows = []
    for scf_name, chain in scaffolds.items():
        # '-'-oriented members enter reverse-complemented
        # (reference: scaffolder.py:66-73)
        parts = []
        for m in chain:
            codes = by_name[m[1:]].sequence
            if m[0] == "-":
                codes = (3 - codes)[::-1]
            parts.append(codes_to_str(codes))
        seq = gap.join(parts)
        records.append((scf_name, seq))
        members = [by_name[m[1:]] for m in chain]
        first = members[0]
        length = sum(c.length for c in members) + \
            (len(chain) - 1) * int(PIPELINE["scaffold_gap"])
        cov = int(np.mean([c.coverage for c in members]))
        mult = min(c.multiplicity for c in members)
        info_rows.append((scf_name, length, cov,
                          "Y" if first.circular else "N",
                          "Y" if first.repetitive else "N",
                          mult,
                          first.alt_group if first.alt_group >= 0 else "*",
                          ",??,".join(c.graph_path for c in members)))

    with open(fasta_out, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i:i + 60] + "\n")

    info_rows.sort(key=lambda r: -r[1])
    with open(info_out, "w") as f:
        f.write("#seq_name\tlength\tcov.\tcirc.\trepeat\tmult.\t"
                "alt_group\tgraph_path\n")
        for row in info_rows:
            f.write("\t".join(str(x) for x in row) + "\n")

    lengths = [r[1] for r in info_rows]
    total = sum(lengths)
    n50 = 0
    acc = 0
    for ln in sorted(lengths, reverse=True):
        acc += ln
        if acc > total // 2:
            n50 = ln
            break
    mean_cov = (sum(r[1] * r[2] for r in info_rows) // total) if total \
        else 0
    logger.info(
        "Assembly statistics:\n\n\tTotal length:\t%d\n\tFragments:\t%d\n"
        "\tFragments N50:\t%d\n\tLargest frg:\t%d\n\tScaffolds:\t%d\n"
        "\tMean coverage:\t%d\n",
        total, len(info_rows), n50, max(lengths) if lengths else 0,
        sum(1 for s in scaffolds.values() if len(s) > 1), mean_cov)
