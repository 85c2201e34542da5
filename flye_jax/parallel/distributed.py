"""Multi-host runtime: jax.distributed init + per-host read sharding.

The reference is single-node (SURVEY §5.8); its "communication" is
shared memory and unix pipes.  The equivalent here is a
first-class runtime component: every host in a pod slice runs the same
pipeline process, `jax.distributed` wires them into one XLA runtime, the
read set is partitioned deterministically per host (the data-parallel
analog of the reference's thread pool over reads,
reference: src/common/parallel.h:14-58), and device collectives
(psum / all-to-all in parallel/mesh.py) merge per-shard results.

Single-process runs (the common case on one chip / CPU) skip
initialization entirely — every helper degrades to the identity.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger("flye_jax")

_initialized = False


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Initialize the multi-host JAX runtime when running on a pod slice.

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).
    On a GPU host each process needs its own card (CUDA_VISIBLE_DEVICES)
    or JAX_PLATFORMS=cpu: one JAX process reserves most of a card's
    memory.  Returns (process_index, process_count).  A no-op returning
    (0, 1) when no multi-host configuration is present.
    """
    global _initialized
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    num_str = os.environ.get("JAX_NUM_PROCESSES")
    num_processes = num_processes or (int(num_str) if num_str else None)
    pid_str = os.environ.get("JAX_PROCESS_ID")
    process_id = process_id if process_id is not None else (
        int(pid_str) if pid_str else None)

    if not _initialized and (coordinator or num_processes):
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator,
                num_processes=num_processes,
                process_id=process_id)
            _initialized = True
        except Exception as e:  # pragma: no cover - platform-specific
            logger.warning(
                "jax.distributed.initialize failed (%s); continuing "
                "with the env-configured topology over the file bus", e)
    if num_processes and process_id is not None:
        # env-first topology: the pipeline's multi-process plane is
        # file-bus based and only needs (index, count), so the explicit
        # configuration wins over what the backend reports (a backend
        # may accept the coordination service without registering the
        # process in jax.process_count())
        if _initialized and jax.process_count() != num_processes:
            logger.info(
                "backend reports %d process(es); using configured %d",
                jax.process_count(), num_processes)
        return process_id, num_processes
    if _initialized:
        logger.info("jax.distributed: process %d/%d, %d local / %d "
                    "global devices", jax.process_index(),
                    jax.process_count(), jax.local_device_count(),
                    jax.device_count())
    return jax.process_index(), jax.process_count()


def host_partition(ids: Sequence[int], process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> List[int]:
    """Deterministic per-host slice of a read-id list.

    Round-robin by sorted position so every host holds an interleaved,
    length-balanced subset regardless of id density.  With one process
    this is the identity.  Forward/reverse strand pairs (id, id^1) stay
    on the same host (partition on the forward id).
    """
    if process_index is None or process_count is None:
        from flye_jax.parallel.runtime import get_runtime
        rt = get_runtime()
        process_index = rt.process_index
        process_count = rt.process_count
    if process_count <= 1:
        return list(ids)
    fwd = sorted({i & ~1 for i in ids})
    mine = {f for n, f in enumerate(fwd) if n % process_count ==
            process_index}
    return [i for i in ids if (i & ~1) in mine]


def is_coordinator() -> bool:
    """True on the host that runs the (host-plane) graph phase.

    The repeat-graph / contigger stages are irregular host algorithms
    run on one process (SURVEY §7: "graph phase runs on host 0 from
    gathered overlap records"); other hosts idle through them and rejoin
    at the next device-parallel stage.
    """
    from flye_jax.parallel.runtime import get_runtime
    return get_runtime().process_index == 0


class BarrierAborted(RuntimeError):
    """The run's coordinator signalled completion/shutdown (DONE) while
    this process was waiting in a barrier — e.g. a `--stop-after` stage
    the coordinator never enters.  Callers on worker processes catch
    this and fall back to serving the task bus / exiting cleanly."""


_abort_file: Optional[str] = None


def set_barrier_abort_file(path: Optional[str]) -> None:
    """Register a sentinel (the task bus's DONE file) that aborts any
    in-progress file_barrier wait — so workers never sit out a full
    barrier timeout after the coordinator has already shut down."""
    global _abort_file
    _abort_file = path


def file_barrier(work_dir: str, name: str, timeout_s: float = 3600.0,
                 poll_s: float = 0.05) -> None:
    """Filesystem barrier across the run's processes.

    Replaces `multihost_utils.sync_global_devices` on the ava shard
    exchange: the collective barrier requires every process to share a
    collective transport, which a heterogeneous run (an accelerator
    coordinator + CPU workers on a single machine) cannot provide (the
    CPU and accelerator collective transports cannot rendezvous).  Processes already share a
    filesystem for the shard files themselves, so the barrier uses the
    same bus: each process drops `<name>.<pid>` and waits for all
    `process_count` sentinels.
    """
    import os
    import time as _time

    from flye_jax.parallel.runtime import get_runtime
    rt = get_runtime()
    pid, count = rt.process_index, rt.process_count
    if count <= 1:
        return
    bdir = os.path.join(work_dir, ".barriers")
    os.makedirs(bdir, exist_ok=True)
    mine = os.path.join(bdir, f"{name}.{pid}")
    with open(mine, "w") as f:
        f.write("x")
    deadline = _time.monotonic() + timeout_s
    while True:
        n = sum(os.path.exists(os.path.join(bdir, f"{name}.{p}"))
                for p in range(count))
        if n >= count:
            return
        if _abort_file is not None and os.path.exists(_abort_file):
            raise BarrierAborted(
                f"file_barrier {name}: coordinator DONE at {n}/{count}")
        if _time.monotonic() > deadline:
            raise TimeoutError(f"file_barrier {name}: {n}/{count}")
        _time.sleep(poll_s)
