"""Multi-host runtime helpers (single-process degradation + partitioning)."""

import numpy as np

from flye_jax.parallel import host_partition, init_distributed, is_coordinator


def test_init_single_process_noop():
    pi, pc = init_distributed()
    assert (pi, pc) == (0, 1)
    assert is_coordinator()


def test_host_partition_identity_single():
    ids = [0, 1, 4, 5, 8, 9]
    assert host_partition(ids, 0, 1) == ids


def test_host_partition_balanced_and_disjoint():
    ids = [i for f in range(100) for i in (2 * f, 2 * f + 1)]
    parts = [host_partition(ids, p, 4) for p in range(4)]
    # disjoint cover
    union = sorted(x for p in parts for x in p)
    assert union == sorted(ids)
    # balanced within one fwd-read granule
    sizes = [len(p) for p in parts]
    assert max(sizes) - min(sizes) <= 2
    # strand pairs stay together
    for p in parts:
        s = set(p)
        for i in p:
            assert (i ^ 1) in s


def test_host_partition_deterministic():
    rng = np.random.default_rng(3)
    ids = list(rng.choice(1000, 200, replace=False) * 2)
    a = host_partition(ids, 1, 3)
    b = host_partition(ids, 1, 3)
    assert a == b
