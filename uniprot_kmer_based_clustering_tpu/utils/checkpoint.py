"""Stage-artifact checkpointing (save / resume).

The reference keeps all intermediate state in RAM and restarts from
scratch on any failure (SURVEY.md §5: no checkpoint/resume). Here every
stage's arrays are persisted as compressed .npz keyed by a config hash, so
a killed run resumes from the last completed stage and downstream stages
(clustering, alignment) can be re-run without recomputing the sweep.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class CheckpointStore:
    def __init__(self, directory: Optional[str]):
        self.directory = directory
        if directory:
            os.makedirs(directory, exist_ok=True)

    def path(self, key: str) -> Optional[str]:
        if not self.directory:
            return None
        return os.path.join(self.directory, f"{key}.npz")

    def load(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        p = self.path(key)
        if not p or not os.path.exists(p):
            return None
        with np.load(p, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def save(self, key: str, **arrays) -> None:
        p = self.path(key)
        if not p:
            return
        import sys

        # Only consult jax when the process actually runs a multi-host
        # cluster (jax.distributed.initialize was called). An
        # unconditional jax.process_count() would force backend init
        # from this numpy-only module (and open the device from a
        # pure-host run). is_initialized() touches no backend.
        jax = sys.modules.get("jax")
        if (
            jax is not None
            and jax.distributed.is_initialized()
            and jax.process_count() > 1
            and jax.process_index() != 0
        ):
            # multi-host: artifacts are replicated; only process 0 writes
            # (hosts share the checkpoint filesystem on a pod)
            return
        tmp = p[: -len(".npz")] + f".tmp.{os.getpid()}.npz"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, p)
