"""Process-wide JAX settings shared by every entry point.

The CLIs, :class:`rpcc.parallel.BatchEngine`, :class:`rpcc.models.pipeline.
RPCCCodec`, ``bench.py``, ``rd_sweep.py`` and ``chip_smoke.py`` call
:func:`setup_compile_cache` before their first compile, so every path keeps
its compiled XLA programs in one persistent cache.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Fixed and inside the checkout: JAX keys its cache entries by the directory,
# so a per-run temp name would never hit.  Listed in .gitignore.
DEFAULT_COMPILE_CACHE = os.path.join(REPO_ROOT, ".jax_cache")
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> Optional[str]:
    """The directory this program sets, or None when ``JAX_COMPILATION_CACHE_DIR``
    is set (JAX reads that variable itself and the program sets nothing)."""
    if environ.get(ENV_VAR):
        return None
    return DEFAULT_COMPILE_CACHE


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    unless the environment already chose one; returns the directory in use."""
    import jax

    path = compile_cache_dir()
    if path is not None and jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    return jax.config.jax_compilation_cache_dir


def require_gpus(n: int = 1):
    """The first ``n`` JAX devices, or SystemExit(2) unless they are GPUs.

    Measurement and smoke entry points call this first: a timing taken on
    the CPU backend is never reported as a device number."""
    import sys

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        print(f"needs {n} GPU(s); JAX found {len(devs)} {devs[0].platform} "
              f"device(s)", file=sys.stderr)
        raise SystemExit(2)
    return devs[:n]


def card_label() -> str:
    """``name, power.limit`` of the first card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints it."""
    import subprocess

    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no card")
    return lines[0]
