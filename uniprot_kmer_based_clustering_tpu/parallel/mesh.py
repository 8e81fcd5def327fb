"""Device mesh construction and sharding helpers.

The reference is a single-process shared-memory program whose only
"distribution" is OS threads claiming indices off atomic counters
(SURVEY.md §2.3). This framework's distribution unit is a 1-D protein
axis over a ``jax.sharding.Mesh``: the packed bitset matrix is sharded by
protein rows, doc-freq reductions ride ``psum``, and the O(N²) pair sweep
ring-rotates row blocks with ``ppermute`` (structurally the ring-attention
schedule). Works unchanged from 1 device to several hosts: initialize
``jax.distributed`` on each host and build the mesh over all devices.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize multi-host JAX (call once per host before make_mesh).

    Bare ``jax.distributed.initialize()`` works where the cluster
    environment describes itself (e.g. SLURM); explicit args cover manual
    clusters. After this, :func:`make_mesh` over ``jax.devices()`` spans
    every process's devices — the multi-host replacement for the
    reference's single-node SLURM envelope (run.sh:3-12).
    """
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def make_mesh(n_devices: int | None = None, axis: str = "p") -> Mesh:
    """1-D mesh over the first `n_devices` devices (all by default)."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_mesh_2d(
    n_hosts: int,
    n_chips: int,
    host_axis: str = "h",
    chip_axis: str = "c",
) -> Mesh:
    """(hosts × chips) mesh for the hierarchical 2-D ring sweep.

    Across hosts, ``jax.devices()`` orders devices process-major, so the
    host axis of the reshape is the actual host boundary: ``ppermute`` over
    `chip_axis` stays within a host and only the `host_axis` rotation
    crosses the network.
    """
    devs = jax.devices()
    need = n_hosts * n_chips
    if need > len(devs):
        raise ValueError(
            f"requested {need} devices, only {len(devs)} available"
        )
    if jax.process_count() > 1 and n_chips != jax.local_device_count():
        # the reshape's host axis is only the REAL host boundary when
        # each row holds exactly one process's devices — otherwise every
        # inner (chip-axis) rotation crosses hosts, silently inverting the
        # 2-D ring's whole premise (one cross-host hop per outer step)
        raise ValueError(
            f"n_chips={n_chips} must equal the per-process device count "
            f"({jax.local_device_count()}) on a multi-host mesh"
        )
    grid = np.array(devs[:need]).reshape(n_hosts, n_chips)
    return Mesh(grid, (host_axis, chip_axis))


def pad_for_mesh(n: int, n_devices: int, multiple: int) -> int:
    """Smallest N_pad ≥ n divisible by n_devices·multiple (so every device
    holds the same number of whole tiles)."""
    unit = n_devices * multiple
    return -(-n // unit) * unit


def shard_rows(mesh: Mesh, arr, axis: str = "p"):
    """Put an [N, ...] array row-sharded onto the mesh."""
    spec = P(axis, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))
