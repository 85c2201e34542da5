from flye_jax.config.params import (
    Config,
    PIPELINE,
    setup_run_params,
)
