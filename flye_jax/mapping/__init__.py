from flye_jax.mapping.mapper import ReadMapper
