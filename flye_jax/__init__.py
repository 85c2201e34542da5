"""flye_jax — a JAX long-read de novo assembler.

A from-scratch rebuild of the Flye assembly pipeline (reference:
zovoilis-lab/Flye 2.8.1) with its hot loops as batched device
kernels:

- Device plane (JAX/XLA/Pallas): k-mer extraction & hashing, minimizer
  selection, sort-based k-mer counting/indexing, seed match chaining DP,
  banded edit-distance alignment, pileup consensus, and the bubble
  polishing kernel.
- Host plane (Python/NumPy): sequence IO, the greedy disjointig extender,
  repeat-graph construction & simplification, contig generation,
  orchestration with stage-level resume.
- Distribution: `jax.sharding.Mesh` over (data, index-shard) axes; k-mer
  histograms merge via psum, sharded index lookups via all-gather of
  per-shard hits.

64-bit integer support is required for packed k-mers (k up to 31 needs
62 bits), so x64 is enabled at import. All device kernels use explicit
dtypes (int32/float32 in the hot paths); int64 only appears in index
construction.
"""

import os as _os

from jax import config as _jax_config

_jax_config.update("jax_enable_x64", True)

# Persistent compilation cache: the pipeline compiles dozens of bucketed
# kernel shapes.  JAX itself honours JAX_COMPILATION_CACHE_DIR; without
# it, the cache lives in one fixed directory of the checkout (a fixed
# path keeps cache keys stable from run to run).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax_config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
_jax_config.update("jax_persistent_cache_min_compile_time_secs", 2)

__version__ = "0.1.0"
