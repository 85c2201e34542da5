from flye_jax.index.kmer_index import KmerIndex


def build_minimizer_index(store, k, w, min_cov=1, repeat_kmer_rate=100,
                          ids=None):
    """Minimizer-index build routed through the parallel runtime: on a
    >1-device mesh the index is hash-sharded and built with the
    all-to-all posting exchange (SURVEY §2.3(a)); single-device builds
    use the plain sorted-array path.  Both produce identical postings
    per k-mer, so downstream overlap results are byte-identical
    (tests/test_distributed_pipeline.py)."""
    from flye_jax.parallel.runtime import get_runtime

    rt = get_runtime()
    if rt.active:
        from flye_jax.index.sharded import ShardedKmerIndex
        return ShardedKmerIndex.build_minimizers_mesh(
            store, k, w, rt.mesh, min_cov=min_cov,
            repeat_kmer_rate=repeat_kmer_rate, ids=ids)
    return KmerIndex.build_minimizers(
        store, k, w, min_cov=min_cov,
        repeat_kmer_rate=repeat_kmer_rate, ids=ids)


def build_solid_index(store, k, select_rate, tandem_freq,
                      global_min_freq=2, sample=1, repeat_kmer_rate=100,
                      ids=None):
    """Solid-kmer (raw-read) index build routed through the parallel
    runtime, like build_minimizer_index: a >1-device mesh hash-shards
    the selected postings with the all-to-all exchange; overlap results
    downstream are byte-identical either way
    (tests/test_distributed_pipeline.py raw-mode twin)."""
    from flye_jax.parallel.runtime import get_runtime

    rt = get_runtime()
    if rt.active:
        from flye_jax.index.sharded import ShardedKmerIndex
        return ShardedKmerIndex.build_solid_mesh(
            store, k, rt.mesh, select_rate=select_rate,
            tandem_freq=tandem_freq, global_min_freq=global_min_freq,
            sample=sample, repeat_kmer_rate=repeat_kmer_rate, ids=ids)
    return KmerIndex.build_solid(
        store, k, select_rate=select_rate, tandem_freq=tandem_freq,
        global_min_freq=global_min_freq, sample=sample,
        repeat_kmer_rate=repeat_kmer_rate, ids=ids)
