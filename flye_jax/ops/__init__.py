from flye_jax.ops.kmers import (
    extract_kmers,
    canonical_kmers,
    splitmix64,
    kmer_hashes,
    minimizer_mask,
    sample_mask,
)
