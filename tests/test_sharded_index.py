import numpy as np
import pytest

from flye_jax.index import KmerIndex
from flye_jax.index.sharded import ShardedKmerIndex
from flye_jax.io import SequenceStore
from flye_jax.overlap import OverlapEngine
from flye_jax.utils.simulate import random_genome, simulate_reads


@pytest.fixture(scope="module")
def stores():
    genome = random_genome(15000, seed=801)
    reads = simulate_reads(genome, coverage=10, mean_length=4000,
                           min_length=1500, error_rate=0.03,
                           circular=False, seed=802)
    store = SequenceStore()
    for name, codes in reads:
        store.add(name, codes)
    return store


def test_sharded_matches_plain(stores):
    store = stores
    k, w = 15, 5
    plain = KmerIndex.build_minimizers(store, k, w)
    sharded = ShardedKmerIndex.build_minimizers(store, k, w, n_shards=4)
    assert sharded.num_kmers == plain.num_kmers
    assert sharded.index_size == plain.index_size
    # frequency answers identical for arbitrary queries
    rng = np.random.default_rng(0)
    queries = np.concatenate([
        np.asarray(plain.uniq_kmers)[rng.integers(0, plain.num_kmers, 50)],
        rng.integers(0, 2 ** 30, 20).astype(np.int64)])
    np.testing.assert_array_equal(sharded.kmer_freq(queries),
                                  plain.kmer_freq(queries))


def test_mesh_build_matches_host_shard_build(stores):
    """The all-to-all mesh build must produce exactly the host
    shard-partitioned index (same shards, same postings order)."""
    import jax

    from flye_jax.parallel import make_mesh

    store = stores
    k, w = 15, 5
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev, axes=("data",))
    host = ShardedKmerIndex.build_minimizers(store, k, w,
                                             n_shards=n_dev)
    dev = ShardedKmerIndex.build_minimizers_mesh(store, k, w, mesh)
    assert dev.num_kmers == host.num_kmers
    assert dev.index_size == host.index_size
    np.testing.assert_array_equal(np.asarray(dev.uniq_kmers),
                                  np.asarray(host.uniq_kmers))
    np.testing.assert_array_equal(dev.post_seq, host.post_seq)
    np.testing.assert_array_equal(dev.post_pos, host.post_pos)
    np.testing.assert_array_equal(dev.post_flip, host.post_flip)
    np.testing.assert_array_equal(dev.shard_row_base,
                                  host.shard_row_base)


def test_sharded_engine_equivalence(stores):
    store = stores
    k, w = 15, 5
    plain = KmerIndex.build_minimizers(store, k, w)
    sharded = ShardedKmerIndex.build_minimizers(store, k, w, n_shards=8)

    def overlaps(index):
        eng = OverlapEngine(store, index, max_jump=1500, min_overlap=1500,
                            max_overhang=1500)
        out = {}
        for sid in store.ids()[:10]:
            out[sid] = sorted(
                (o.ext_id, o.cur_begin, o.cur_end, o.ext_begin, o.ext_end)
                for o in eng.get_overlaps(store, sid))
        return out

    assert overlaps(sharded) == overlaps(plain)
