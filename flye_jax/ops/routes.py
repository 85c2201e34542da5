"""Route choice per device op, taken from the platform.

Every op with more than one implementation asks this module which one
to run, so a platform's choices sit in one place:

- polish hill climb: the threaded native climber on the CPU, the
  on-device convergence loop with the Triton scorer on a GPU
  (ops/polish.py);
- chain DP: the lax.scan formulation on the CPU, the Triton kernel on a
  GPU (ops/chain.py);
- polish batch sizing: a share of the device's memory limit
  (polishing/polisher.py);
- the CLI's default mesh size (parallel/runtime.py).
"""

from __future__ import annotations

from typing import Optional

# share of the device memory limit one polish batch's working set may
# take (the rest stays free for the pipeline's other arrays and for
# XLA's temporaries beyond the per-lane model)
POLISH_MEMORY_SHARE = 0.25


def platform() -> str:
    import jax
    return jax.default_backend()


def polish_route(plat: Optional[str] = None) -> str:
    """'native' (threaded C++ climber, host) on the CPU; on a GPU the
    on-device convergence loop with the Triton scoring kernel ('triton'),
    which beat the same loop around the jnp scorer on the H100
    (PERF.md)."""
    return "native" if (plat or platform()) == "cpu" else "triton"


def chain_route(plat: Optional[str] = None) -> str:
    """'scan' (lax.scan) on the CPU; the Triton kernel ('triton') on a
    GPU, where it beat the scan on the H100 (PERF.md)."""
    return "scan" if (plat or platform()) == "cpu" else "triton"


def default_mesh_size(n_devices: int,
                      plat: Optional[str] = None) -> int:
    """Devices the CLI meshes when --shards is not given: all of them
    on the CPU; one card on a GPU host, where the sharded path has no
    passing full-size run yet (PERF.md) — --shards N opts in."""
    return n_devices if (plat or platform()) == "cpu" else 1


def device_memory_limit() -> int:
    """Bytes the first local device lets one process allocate; 0 when
    the backend reports no limit (the CPU)."""
    import jax
    stats = jax.local_devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit", 0))
