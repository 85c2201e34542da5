"""Full-pipeline CLI run + resume on a tiny simulated genome.

Covers the Job framework's file contract: a complete run, then
--resume-from restarting mid-pipeline with earlier stages' in-memory
context rebuilt from their on-disk outputs via Job.load_state
(reference resumes the same way, flye/main.py:539-576).
"""

import os

import numpy as np
import pytest

# full E2E runs: excluded from the fast unit gate (run with -m slow)
pytestmark = pytest.mark.slow

from flye_jax.io.fasta import read_seq_file, write_fasta
from flye_jax.utils.simulate import random_genome, simulate_reads


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    # low coverage keeps polishing windows in small branch buckets — the
    # CPU jnp scoring path cost scales with branch count
    genome = random_genome(20000, seed=3)
    reads = simulate_reads(genome, coverage=12, mean_length=4000,
                           error_rate=0.05, seed=5, circular=False)
    reads_path = d / "reads.fasta"
    write_fasta(reads, str(reads_path))
    # the pipeline runs HERE so every test of this module is
    # self-sufficient (under xdist, resume tests may land on a worker
    # that never executed test_full_pipeline)
    assert _run(reads_path, d / "out") == 0
    return d, genome, reads_path


def _run(reads_path, out, *extra):
    from flye_jax.main import main
    return main(["--pacbio-raw", str(reads_path), "-o", str(out),
                 "-g", "20k", "-m", "1500", *extra])


def test_full_pipeline(run_dir):
    d, genome, reads_path = run_dir
    out = d / "out"  # assembled by the fixture
    recs = read_seq_file(str(out / "assembly.fasta"))
    assert recs, "no contigs assembled"
    total = sum(len(s) for _, s in recs)
    assert total > 0.7 * len(genome)
    assert (out / "assembly_info.txt").exists()
    assert (out / "assembly_graph.gfa").exists()


def test_resume_from_polishing(run_dir):
    d, genome, reads_path = run_dir
    out = d / "out"
    asm = out / "assembly.fasta"
    before = read_seq_file(str(asm))
    os.remove(asm)
    assert _run(reads_path, out, "--resume-from", "polishing") == 0
    after = read_seq_file(str(asm))
    assert [n for n, _ in after] == [n for n, _ in before]
    for (_, a), (_, b) in zip(after, before):
        np.testing.assert_array_equal(a, b)


def test_resume_from_finalize(run_dir):
    d, genome, reads_path = run_dir
    out = d / "out"
    asm = out / "assembly.fasta"
    before = read_seq_file(str(asm))
    os.remove(asm)
    assert _run(reads_path, out, "--resume-from", "finalize") == 0
    after = read_seq_file(str(asm))
    assert [n for n, _ in after] == [n for n, _ in before]
    for (_, a), (_, b) in zip(after, before):
        np.testing.assert_array_equal(a, b)


def test_resume_missing_stage_outputs(run_dir, tmp_path):
    d, genome, reads_path = run_dir
    from flye_jax.main import main
    rc = main(["--pacbio-raw", str(reads_path), "-o", str(tmp_path),
               "-g", "20k", "--resume-from", "polishing"])
    assert rc != 0
