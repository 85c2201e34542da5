from flye_jax.polishing.matrices import get_subs_matrix
