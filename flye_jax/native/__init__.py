"""Native (C++) host helpers, built on first use with g++.

The compiled module is cached next to the source; if the toolchain is
unavailable the callers fall back to their pure-Python implementations.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import subprocess
import sysconfig

logger = logging.getLogger("flye_jax")

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "flye_native.cpp")
_SO = os.path.join(_DIR, "flye_native.so")
_module = None
_tried = False


def _build() -> bool:
    include = sysconfig.get_paths()["include"]
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           f"-I{include}", _SRC, "-o", _SO]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.debug("native build failed to launch: %s", e)
        return False
    if res.returncode != 0:
        logger.debug("native build failed:\n%s", res.stderr.decode())
        return False
    return True


def get() -> object:
    """The flye_native module, or None if unavailable."""
    global _module, _tried
    if _module is not None or _tried:
        return _module
    _tried = True
    if not os.path.exists(_SO) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        if not _build():
            return None
    try:
        spec = importlib.util.spec_from_file_location("flye_native", _SO)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _module = mod
        logger.debug("native helpers loaded")
    except Exception as e:
        logger.debug("native load failed: %s", e)
    return _module
