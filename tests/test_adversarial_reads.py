"""Adversarial read simulation: chimeric reads, adapter junk, coverage
dropouts (flye_jax/utils/simulate.py round-4 extensions), asserting the
defenses built for them actually fire (reference analog:
src/assemble/chimera.cpp:106-180 per-read coverage-drop testing).

The headline test assembles a read set with 15% chimeras twice — with
the chimera detector active and with it force-disabled — and checks
that the detector is LOAD-BEARING: active, the assembly's contigs map
collinearly onto the truth genome; disabled, at least one contig
contains an artifactual junction (adjacent windows anchoring to distal
truth loci) or the contig set degrades.
"""

import numpy as np
import pytest

from flye_jax.utils.simulate import random_genome, simulate_reads

pytestmark = pytest.mark.slow


def _pack_occ(genome, k=32):
    occ = {}
    out = np.zeros(len(genome) - k + 1, np.uint64)
    for i in range(k):
        out = (out << np.uint64(2)) | genome[i:i + len(out)].astype(
            np.uint64)
    for pos, km in enumerate(out):
        occ.setdefault(int(km), []).append(pos)
    return occ


def _max_junction_jump(contig, genome, k=32, stride=400):
    """Largest |truth-coordinate jump minus contig-coordinate advance|
    between consecutive anchored windows, for both orientations; a
    clean (non-chimeric) contig advances collinearly so the value stays
    near the indel noise (<~2 kb); a fused junction shows up as a jump
    of the distance between the fused loci."""
    occ = _pack_occ(genome, k)
    from flye_jax.io.fasta import COMPLEMENT
    best = None
    for seq in (contig, COMPLEMENT[contig[::-1]]):
        if len(seq) < k + stride:
            continue
        kms = np.zeros(len(seq) - k + 1, np.uint64)
        for i in range(k):
            kms = (kms << np.uint64(2)) | seq[i:i + len(kms)].astype(
                np.uint64)
        anchors = []
        for i in range(0, len(kms), stride):
            ps = occ.get(int(kms[i]))
            if ps is not None and len(ps) == 1:
                anchors.append((i, ps[0]))
        if len(anchors) < 5:
            continue
        jumps = [abs((t1 - t0) - (c1 - c0))
                 for (c0, t0), (c1, t1) in zip(anchors[:-1], anchors[1:])]
        m = max(jumps)
        cov = len(anchors)
        if best is None or cov > best[1]:
            best = (m, cov)
    return best[0] if best else None


def _assemble(reads, tmp_path, tag, which="00-assembly/draft_assembly"):
    from flye_jax.io.fasta import read_seq_file, write_fasta
    from flye_jax.main import main
    rp = tmp_path / f"reads_{tag}.fasta"
    if not rp.exists():
        write_fasta(reads, str(rp))
    out = tmp_path / f"out_{tag}"
    if not (out / "assembly.fasta").exists():
        rc = main(["--pacbio-raw", str(rp), "-o", str(out), "-g", "60k",
                   "-m", "1500"])
        assert rc == 0
    return read_seq_file(str(out / f"{which}.fasta"))


def test_chimera_detection_rate(tmp_path):
    """The per-read coverage-drop test must catch nearly every planted
    chimera (reference: chimera.cpp:106-180 testReadByCoverage)."""
    from flye_jax.assemble.chimera import ChimeraDetector
    from flye_jax.assemble.driver import build_read_index
    from flye_jax.config import Config
    from flye_jax.io.seqstore import SequenceStore
    from flye_jax.overlap import OverlapEngine, OverlapStore

    genome = random_genome(60000, seed=21)
    reads = simulate_reads(genome, coverage=25, mean_length=6000,
                           error_rate=0.05, seed=22, circular=False,
                           chimera_rate=0.15)
    n_chim = sum("_chimera" in n for n, _ in reads)
    assert n_chim >= 5
    store = SequenceStore()
    for n, c in reads:
        store.add(n, c)
    cfg = Config("raw", min_overlap=1500)
    index = build_read_index(store, cfg)
    engine = OverlapEngine(store, index, max_jump=cfg.maximum_jump,
                           min_overlap=1500,
                           max_overhang=cfg.maximum_overhang,
                           only_max_ext=True, max_divergence=1.0)
    ovlp = OverlapStore(engine, store)
    ovlp.estimate_overlaper_parameters()
    ovlp.set_divergence_threshold(
        cfg.assemble_ovlp_divergence,
        relative=bool(cfg.assemble_divergence_relative))
    chim = ChimeraDetector(store, ovlp, window=cfg.chimera_window,
                           max_overhang=cfg.maximum_overhang,
                           max_drop_rate=cfg.max_coverage_drop_rate,
                           uneven_coverage=False)
    chim.estimate_global_coverage()
    tp = fn = fp = tn = 0
    for sid in store.ids():
        if sid % 2:
            continue
        truth = "_chimera" in store.name(sid)
        pred = chim.is_chimeric(sid, ovlp.lazy_overlaps(sid))
        tp += truth and pred
        fn += truth and not pred
        fp += pred and not truth
        tn += not pred and not truth
    # measured on this seed: 24/25 caught, 31 false flags on 197 clean
    # reads (false flags only cost extension starts, not correctness)
    assert tp / (tp + fn) >= 0.85, (tp, fn)
    assert fp / (fp + tn) <= 0.35, (fp, tn)


def test_chimera_detector_is_load_bearing(tmp_path, monkeypatch):
    """End-to-end: with detection on, the FINAL assembly (after the
    graph stage's chimeric-junction fixing) is junction-free; with
    detection force-disabled, artifactual junctions reach the draft —
    the detector demonstrably carries weight at its stage."""
    genome = random_genome(60000, seed=21)
    reads = simulate_reads(genome, coverage=25, mean_length=6000,
                           error_rate=0.05, seed=22, circular=False,
                           chimera_rate=0.15)
    assert sum("_chimera" in n for n, _ in reads) >= 5

    contigs_on = _assemble(reads, tmp_path, "chim_on",
                           which="assembly")
    assert contigs_on, "no contigs with chimera detection on"
    jumps_on = [_max_junction_jump(s, genome) for _, s in contigs_on]
    jumps_on = [j for j in jumps_on if j is not None]
    assert jumps_on and max(jumps_on) < 2500, (
        f"chimeric junction leaked into the final assembly: {jumps_on}")

    # force-disable the detector and show the draft degrades
    from flye_jax.assemble import chimera as chim_mod
    monkeypatch.setattr(chim_mod.ChimeraDetector, "is_chimeric",
                        lambda self, sid, ovlps: False)
    draft_off = _assemble(reads, tmp_path, "chim_off")
    jumps_off = [_max_junction_jump(s, genome) for _, s in draft_off]
    jumps_off = [j for j in jumps_off if j is not None]
    degraded = (not jumps_off or max(jumps_off) >= 2500
                or len(draft_off) > len(contigs_on))
    assert degraded, (
        "disabling ChimeraDetector changed nothing — the stress set is "
        f"not stressful enough (jumps {jumps_off})")


def test_adapter_reads_do_not_break_assembly(tmp_path):
    genome = random_genome(50000, seed=31)
    reads = simulate_reads(genome, coverage=22, mean_length=6000,
                           error_rate=0.05, seed=32, circular=False,
                           adapter_rate=0.3)
    assert sum("_adapter" in n for n, _ in reads) >= 10
    contigs = _assemble(reads, tmp_path, "adapters")
    assert contigs
    jumps = [_max_junction_jump(s, genome) for _, s in contigs]
    jumps = [j for j in jumps if j is not None]
    assert jumps and max(jumps) < 2500, f"adapter junk leaked: {jumps}"


def test_dropout_splits_but_keeps_identity(tmp_path):
    genome = random_genome(60000, seed=41)
    hole = (30000, 31500)
    reads = simulate_reads(genome, coverage=25, mean_length=5000,
                           error_rate=0.05, seed=42, circular=False,
                           dropout=hole)
    # no read may touch the hole
    import re
    for n, _ in reads:
        m = re.match(r"sim_\d+_pos(\d+)_len(\d+)", n)
        p, ln = int(m.group(1)), int(m.group(2))
        assert not (p < hole[1] and p + ln > hole[0])
    contigs = _assemble(reads, tmp_path, "dropout")
    # the hole must not be bridged by fabricated sequence: every contig
    # still maps collinearly
    jumps = [_max_junction_jump(s, genome) for _, s in contigs]
    jumps = [j for j in jumps if j is not None]
    assert jumps and max(jumps) < 2500, f"dropout bridged wrongly: {jumps}"
