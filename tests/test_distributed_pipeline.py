"""The PRODUCTION pipeline on a device mesh.

Round-1's distribution layer was a side-car; these tests pin the round-2
contract: with the parallel runtime active (8 virtual CPU devices), the
pipeline's own code paths — index build via the all-to-all mesh exchange,
flat-stream extraction/probe, chain DP, and the polish kernel, all with
their batch axes sharded — produce BYTE-IDENTICAL results to the
single-device run (SURVEY §5.2 determinism north star).
"""

import jax
import numpy as np
import pytest

from flye_jax.config import Config
from flye_jax.io import SequenceStore
from flye_jax.parallel import (ParallelContext, get_runtime, make_mesh,
                               set_runtime)
from flye_jax.utils.simulate import random_genome, simulate_reads


@pytest.fixture
def runtime_guard():
    yield
    set_runtime(None)


@pytest.fixture(scope="module")
def read_store():
    genome = random_genome(20000, seed=901)
    reads = simulate_reads(genome, coverage=12, mean_length=5000,
                           min_length=2000, error_rate=0.05,
                           circular=True, seed=902)
    store = SequenceStore()
    for name, codes in reads:
        store.add(name, codes)
    return store


def _with_mesh(n_devices):
    if n_devices > 1:
        set_runtime(ParallelContext(make_mesh(n_devices, axes=("data",))))
    else:
        set_runtime(ParallelContext())


def test_assemble_stage_mesh_identical(read_store, runtime_guard):
    """assemble_disjointigs through the runtime mesh == single device.

    This drives the production path end-to-end: build_read_index routes
    to ShardedKmerIndex.build_minimizers_mesh, every stream/chain kernel
    shards its batch axis, and the resulting disjointigs must match
    byte for byte."""
    from flye_jax.assemble import assemble_disjointigs

    results = {}
    for n in (1, len(jax.devices())):
        _with_mesh(n)
        cfg = Config("raw", min_overlap=2000)
        results[n] = assemble_disjointigs(read_store, cfg)
        set_runtime(None)
    base = results[1]
    other = results[len(jax.devices())]
    assert len(base) == len(other) and len(base) >= 1
    for (n1, s1), (n2, s2) in zip(base, other):
        assert n1 == n2
        np.testing.assert_array_equal(s1, s2)


def test_index_build_routes_to_mesh(read_store, runtime_guard):
    """build_minimizer_index must return the hash-sharded mesh-built
    index when the runtime is active, and answer identically."""
    from flye_jax.index import KmerIndex, build_minimizer_index
    from flye_jax.index.sharded import ShardedKmerIndex

    _with_mesh(len(jax.devices()))
    assert get_runtime().active
    idx = build_minimizer_index(read_store, 15, 5)
    assert isinstance(idx, ShardedKmerIndex)
    set_runtime(None)
    plain = KmerIndex.build_minimizers(read_store, 15, 5)
    assert idx.num_kmers == plain.num_kmers
    assert idx.index_size == plain.index_size
    rng = np.random.default_rng(0)
    q = np.asarray(plain.uniq_kmers)[
        rng.integers(0, plain.num_kmers, 64)]
    np.testing.assert_array_equal(idx.kmer_freq(q), plain.kmer_freq(q))


def test_polish_kernel_mesh_identical(runtime_guard):
    """The polish hill-climb with the bubble axis sharded over the mesh
    == single device (bit-identical f32: same program, partitioned)."""
    from flye_jax.ops.polish import polish_bubbles
    from flye_jax.polishing.matrices import get_subs_matrix

    rng = np.random.default_rng(7)
    B, Cb, R, S = 32, 96, 8, 96
    true = rng.integers(0, 4, size=(B, 64)).astype(np.uint8)
    cand = np.zeros((B, Cb), np.uint8)
    cand[:, :64] = true
    idx = rng.integers(0, 64, size=(B, 3))
    for i in range(B):
        cand[i, idx[i]] = (cand[i, idx[i]] + 1) % 4
    clen = np.full(B, 64, np.int32)
    branches = np.zeros((B, R, S), np.uint8)
    branches[:, :, :64] = true[:, None, :]
    blen = np.full((B, R), 64, np.int32)
    bmask = np.ones((B, R), bool)
    subs = get_subs_matrix("pacbio")

    out = {}
    for n in (1, len(jax.devices())):
        _with_mesh(n)
        c, l, sc, it = polish_bubbles(cand.copy(), clen, branches, blen,
                                      bmask, subs, max_iters=32)
        out[n] = (np.asarray(c), np.asarray(l), np.asarray(sc))
        set_runtime(None)
    np.testing.assert_array_equal(out[1][0], out[len(jax.devices())][0])
    np.testing.assert_array_equal(out[1][1], out[len(jax.devices())][1])
    np.testing.assert_allclose(out[1][2], out[len(jax.devices())][2],
                               rtol=1e-6)


def test_solid_index_build_routes_to_mesh(read_store, runtime_guard):
    """The raw-read (solid-kmer) build must also route to the
    hash-sharded mesh build when the runtime is active (round-2 gap:
    only the minimizer path had a mesh route)."""
    from flye_jax.index import build_solid_index
    from flye_jax.index.sharded import ShardedKmerIndex

    _with_mesh(len(jax.devices()))
    assert get_runtime().active
    idx = build_solid_index(read_store, 15, select_rate=0.4,
                            tandem_freq=10)
    assert isinstance(idx, ShardedKmerIndex)
    set_runtime(None)
    plain = build_solid_index(read_store, 15, select_rate=0.4,
                              tandem_freq=10)
    # identical content modulo shard-major key order: compare the
    # full posting multiset per kmer
    def canon_postings(ix):
        out = {}
        u = np.asarray(ix.uniq_kmers)
        for r in range(ix.num_kmers):
            s, e = ix.offsets[r], ix.offsets[r + 1]
            out[int(u[r])] = sorted(zip(ix.post_seq[s:e].tolist(),
                                        ix.post_pos[s:e].tolist(),
                                        ix.post_flip[s:e].tolist()))
        return out
    assert canon_postings(idx) == canon_postings(plain)
