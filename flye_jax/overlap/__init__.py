from flye_jax.overlap.structs import Overlap
from flye_jax.overlap.engine import OverlapEngine, OverlapStore
