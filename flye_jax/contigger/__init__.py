from flye_jax.contigger.extender import generate_contigs, ContigInfo
