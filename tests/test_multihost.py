"""Multi-host (2-OS-process) pipeline execution over CPU devices.

The round-robin read partition (parallel/distributed.py host_partition)
splits the ava phase across processes; shards merge through the shared
filesystem; the coordinator runs the host-plane stages.  The assembled
output must be byte-identical to a single-process run — per-read
overlap results are independent of which process computes them
(SURVEY §2.3(c) / §5.8; the reference's analog is its thread pool over
the same loops, src/common/parallel.h:14-58).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from flye_jax.io.fasta import write_fasta
from flye_jax.utils.simulate import random_genome, simulate_reads

pytestmark = pytest.mark.slow

_STUB = """
import sys
pid = int(sys.argv[1])
import os
os.environ["JAX_COORDINATOR_ADDRESS"] = "127.0.0.1:{port}"
os.environ["JAX_NUM_PROCESSES"] = "2"
os.environ["JAX_PROCESS_ID"] = str(pid)
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
from flye_jax.main import main
rc = main(["--pacbio-raw", {reads!r}, "-o", {out!r},
           "-g", "20k", "-m", "1500"])
sys.exit(rc)
"""


def _run_single(reads_path, out):
    from flye_jax.main import main
    assert main(["--pacbio-raw", str(reads_path), "-o", str(out),
                 "-g", "20k", "-m", "1500"]) == 0


def test_two_process_run_matches_single(tmp_path):
    genome = random_genome(20000, seed=3)
    reads = simulate_reads(genome, coverage=12, mean_length=4000,
                           error_rate=0.05, seed=5, circular=False)
    reads_path = tmp_path / "reads.fasta"
    write_fasta(reads, str(reads_path))

    out1 = tmp_path / "out_single"
    _run_single(reads_path, out1)

    out2 = tmp_path / "out_multi"
    stub = tmp_path / "stub.py"
    stub.write_text(_STUB.format(port=29811, repo="/root/repo",
                                 reads=str(reads_path), out=str(out2)))
    env = dict(os.environ)
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, str(stub), str(pid)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for pid in (0, 1)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode()[-3000:]

    # the worker's shard file must exist: the partition really ran on
    # two processes
    assert (out2 / "00-assembly" / "ava_shard_1.npz").exists()

    with open(out1 / "assembly.fasta", "rb") as f:
        single = f.read()
    with open(out2 / "assembly.fasta", "rb") as f:
        multi = f.read()
    assert single == multi, "2-process assembly differs from 1-process"
    # stage outputs match too
    with open(out1 / "00-assembly" / "draft_assembly.fasta", "rb") as f:
        d1 = f.read()
    with open(out2 / "00-assembly" / "draft_assembly.fasta", "rb") as f:
        d2 = f.read()
    assert d1 == d2


def test_host_partition_covers_and_disjoint():
    from flye_jax.parallel.distributed import host_partition
    ids = list(range(0, 40))  # 20 fwd/rev pairs
    p0 = host_partition(ids, 0, 2)
    p1 = host_partition(ids, 1, 2)
    assert sorted(p0 + p1) == ids
    assert not set(p0) & set(p1)
    # strand pairs stay together
    for part in (p0, p1):
        s = set(part)
        for i in part:
            assert (i ^ 1) in s
