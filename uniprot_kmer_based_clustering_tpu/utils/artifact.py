"""Round-stamped bench artifacts.

Every bench script prints exactly ONE JSON line (the driver contract);
this helper additionally mirrors that line to ``BENCH_<name>_r<NN>.json``
at the repo root when ``UKC_BENCH_ROUND`` is set. Every artifact
self-describes with a ``provenance`` block — the exact reproduction
command, the device it ran on, the git commit of the tree, and the
timestamp — so any number can be re-derived by running the recorded
command on the recorded tree.
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import sys
import time
from typing import Optional


def _provenance() -> dict:
    env_bits = []
    for var in ("UKC_BENCH_ROUND", "UKC_BENCH_FASTA", "UKC_SCALE_N",
                "UKC_SCALE_K", "UKC_SCALE_TEMPLATES", "UKC_SCALE_MUTDIV",
                "UKC_SCALE_BLOCK", "UKC_SCALE_STRIP", "UKC_SCALE_DEVIDX",
                "UKC_SCALE_FUSED", "UKC_SCALE_STREAM",
                "UKC_SCALE_STREAM_ONLY", "UKC_SCALE_STREAM_BUDGET",
                "UKC_SCALE_STREAM_REPS",
                "UKC_BENCH_ENGINES", "UKC_POD_DEVICES", "UKC_QUERY_N"):
        if os.environ.get(var):
            env_bits.append(f"{var}={shlex.quote(os.environ[var])}")
    cmd = " ".join(env_bits + [shlex.quote(sys.executable)]
                   + [shlex.quote(a) for a in sys.argv])
    prov = {
        "repro_command": cmd,
        "written_utc": time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
        ),
        "captured_by": "bench script (utils/artifact.py), not the "
                       "driver — re-run repro_command to re-derive",
    }
    try:
        prov["git_commit"] = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except Exception:
        prov["git_commit"] = None
    # never import jax here: a host-only bench writing its artifact must
    # not be the thing that forces backend init — record the device only
    # when the bench already initialized jax itself
    jax = sys.modules.get("jax")
    try:
        if jax is not None:
            dev = jax.devices()[0]
            prov["device"] = str(dev)
            prov["platform"] = dev.platform
            prov["n_devices"] = jax.device_count()
    except Exception:
        prov["device"] = None
    return prov


def write_bench_artifact(
    name: str, line: dict, repo_dir: Optional[str] = None
) -> Optional[str]:
    """Write ``line`` to BENCH_<name>_r<NN>.json; returns the path, or
    None when UKC_BENCH_ROUND is unset (ad-hoc runs leave no artifact).
    A ``provenance`` block (repro command, device, git commit, UTC
    timestamp) is added unless the caller already supplied one."""
    rnd = os.environ.get("UKC_BENCH_ROUND")
    if not rnd:
        return None
    if repo_dir is None:
        # utils/ -> package -> repo root
        repo_dir = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
    if "provenance" not in line:
        line = {**line, "provenance": _provenance()}
    path = os.path.join(repo_dir, f"BENCH_{name}_r{int(rnd):02d}.json")
    with open(path, "w") as f:
        json.dump(line, f, indent=2)
        f.write("\n")
    return path
