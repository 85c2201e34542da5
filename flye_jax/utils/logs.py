"""Logging setup: timestamped console + optional file sink.

Mirrors the reference's dual console/file logging discipline
(reference: flye/main.py:579-599, src/common/logger.h) with one root
package logger.
"""

from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager
from typing import Optional


def configure_logging(log_file: Optional[str] = None, debug: bool = False) -> None:
    logger = logging.getLogger("flye_jax")
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()

    console = logging.StreamHandler(sys.stderr)
    console.setLevel(logging.DEBUG if debug else logging.INFO)
    console.setFormatter(
        logging.Formatter("[%(asctime)s] %(levelname)s: %(message)s",
                          "%Y-%m-%d %H:%M:%S"))
    logger.addHandler(console)

    if log_file:
        fh = logging.FileHandler(log_file, mode="a")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(
            logging.Formatter("[%(asctime)s] %(levelname)s: %(message)s",
                              "%Y-%m-%d %H:%M:%S"))
        logger.addHandler(fh)


def human_bytes(n: float) -> str:
    for unit in ("b", "Kb", "Mb", "Gb", "Tb"):
        if abs(n) < 1024:
            return f"{n:.1f} {unit}" if unit != "b" else f"{int(n)} {unit}"
        n /= 1024
    return f"{n:.1f} Pb"


def host_memory() -> tuple:
    """(current RSS, peak RSS) in bytes from /proc/self/status — the
    per-stage memory introspection of the reference
    (reference: src/common/memory_info.h getMemorySize/getPeakRSS,
    logged at stage boundaries in main_assemble.cpp:152-156,225-226)."""
    import resource
    rss = peak = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    peak = int(line.split()[1]) * 1024
    except OSError:
        pass
    # some sandboxed kernels report no VmHWM; getrusage gives the peak
    peak = peak or resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return rss, peak


def device_memory() -> Optional[tuple]:
    """(bytes_in_use, peak_bytes_in_use) of device 0's HBM, or None when
    the backend exposes no memory stats (CPU)."""
    try:
        import jax
        stats = jax.local_devices()[0].memory_stats()
        if stats:
            return (stats.get("bytes_in_use", 0),
                    stats.get("peak_bytes_in_use", 0))
    except Exception:
        pass
    return None


# (stage name, seconds) of every finished stage_timer, in finishing
# order; read with stage_walls(), cleared with reset_stage_walls()
_STAGE_WALLS: list = []


def stage_walls() -> list:
    return list(_STAGE_WALLS)


def reset_stage_walls() -> None:
    _STAGE_WALLS.clear()


@contextmanager
def stage_timer(name: str, logger: Optional[logging.Logger] = None):
    """Per-stage wall-clock timing + memory introspection (the reference
    keeps per-phase timers in its hot loops, src/sequence/overlap.cpp:
    128-158, and logs RSS at stage boundaries via memory_info.h)."""
    log = logger or logging.getLogger("flye_jax")
    start = time.monotonic()
    log.info("%s: started", name)
    try:
        yield
    finally:
        wall = time.monotonic() - start
        _STAGE_WALLS.append((name, wall))
        rss, peak = host_memory()
        dev = device_memory()
        mem = f"RSS {human_bytes(rss)} (peak {human_bytes(peak)})"
        if dev:
            mem += (f", HBM {human_bytes(dev[0])} "
                    f"(peak {human_bytes(dev[1])})")
        log.info("%s: done in %.1f s [%s]", name, wall, mem)
