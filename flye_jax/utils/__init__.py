from flye_jax.utils.logs import configure_logging, human_bytes
