"""Device setup shared by the CLI, the bench scripts and ``chip_smoke.py``:
the check that JAX found the accelerator the caller asked for, the
persistent compilation cache, and the memory budget read from the device.
"""

from __future__ import annotations

import os
import subprocess

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

#: Compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is not
#: set: a fixed path inside the checkout (listed in ``.gitignore``), so a
#: later process on the same checkout finds the executables again.
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")

#: Budget on the CPU platform, which reports no memory limit. A fixed
#: value keeps every size decision deterministic in the CPU test suite.
CPU_BUDGET_BYTES = 8 << 30

#: Share of the device's memory limit held back from the budget for
#: XLA's own workspace (GEMM scratch, fusion temporaries) and allocator
#: fragmentation.
HEADROOM_FRACTION = 8  # budget = limit − limit / 8


def cpu_pinned() -> bool:
    """True when JAX is pinned to the CPU (``JAX_PLATFORMS=cpu`` or a
    ``jax_platforms`` config update)."""
    import jax

    return str(jax.config.jax_platforms or "").startswith("cpu")


def require_accelerator(allow_cpu: bool = False):
    """Return the first JAX device, or stop with an error naming what JAX
    found when it is the CPU and ``allow_cpu`` is False.

    Nothing falls back to the CPU silently: a run that was meant for the
    GPU and landed on the CPU would report CPU times as device times.
    The CLI allows the CPU when asked (``--cpu`` or ``JAX_PLATFORMS=cpu``,
    see :func:`cpu_pinned`); the bench scripts never do.
    """
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu" and not allow_cpu:
        raise SystemExit(
            f"no GPU found: JAX sees {jax.devices()} "
            f"(backend {jax.default_backend()!r}). Pass --cpu or set "
            "JAX_PLATFORMS=cpu to run the CLI on the CPU."
        )
    return dev


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (``name, power.limit``); every timing is quoted beside this line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def enable_persistent_cache() -> None:
    """Turn on JAX's persistent compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    no directory is set here; otherwise the cache goes to
    :data:`DEFAULT_CACHE_DIR`. Every entry point (CLI, benches, scripts)
    calls this before its first compile.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def device_memory_budget(device=None) -> int:
    """Bytes the sizing code may plan for on one device.

    On a GPU: ``memory_stats()["bytes_limit"]`` (what the JAX process
    reserved) less :data:`HEADROOM_FRACTION`. On the CPU platform:
    :data:`CPU_BUDGET_BYTES`. An accelerator that reports no limit is an
    error — guessing a size would either waste the card or run out of
    memory at scale.
    """
    if device is None:
        import jax

        device = jax.local_devices()[0]
    if device.platform == "cpu":
        return CPU_BUDGET_BYTES
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"device {device} reports no memory limit; pass an explicit "
            "budget"
        )
    return int(limit) - int(limit) // HEADROOM_FRACTION
