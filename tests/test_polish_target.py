"""Standalone polisher entry (--polish-target) and --hifi-error plumbing."""

import os

import numpy as np
import pytest

from flye_jax.io.fasta import read_seq_file, write_fasta
from flye_jax.utils.simulate import random_genome, simulate_reads


def test_polish_target_cli(tmp_path):
    from flye_jax.main import main

    genome = random_genome(8000, seed=11)
    reads = simulate_reads(genome, coverage=14, mean_length=3000,
                           error_rate=0.04, seed=2, circular=False)
    reads_path = str(tmp_path / "reads.fasta")
    write_fasta(reads, reads_path)
    # corrupt the draft with substitutions
    rng = np.random.default_rng(4)
    draft = genome.copy()
    idx = rng.choice(len(draft), 80, replace=False)
    draft[idx] = (draft[idx] + 1) % 4
    draft_path = str(tmp_path / "draft.fasta")
    write_fasta([("d", draft)], draft_path)

    out = str(tmp_path / "out")
    rc = main(["--pacbio-corr", reads_path, "-o", out,
               "--polish-target", draft_path, "-i", "1"])
    assert rc == 0
    polished = read_seq_file(os.path.join(out, "polished_1.fasta"))
    assert len(polished) == 1
    seq = polished[0][1]

    # edit distance, not positional mismatch: a single indel introduced
    # by polishing shifts every downstream position
    from flye_jax.ops.align import edit_distance_batch

    def ed(a, b):
        m = max(len(a), len(b))
        av = np.zeros((1, m), np.uint8)
        bv = np.zeros((1, m), np.uint8)
        av[0, :len(a)] = a
        bv[0, :len(b)] = b
        return int(np.asarray(edit_distance_batch(
            av, np.asarray([len(a)], np.int32),
            bv, np.asarray([len(b)], np.int32)))[0])

    before = ed(draft, genome)          # == 80 substitutions
    after = ed(seq, genome)
    assert after < before // 4


def test_hifi_error_requires_hifi(tmp_path, capsys):
    from flye_jax.main import main
    with pytest.raises(SystemExit):
        main(["--pacbio-raw", "x.fa", "-o", str(tmp_path), "-g", "1m",
              "--hifi-error", "0.003"])


def test_hifi_error_sets_divergence(tmp_path):
    from flye_jax.main import build_parser
    p = build_parser()
    a = p.parse_args(["--pacbio-hifi", "x.fa", "-o", str(tmp_path),
                      "-g", "1m", "--hifi-error", "0.003"])
    assert a.hifi_error == 0.003
