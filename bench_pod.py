"""Mesh scaling benchmark: ring-sweep pairs/s/chip at any device count.

The north-star targets (BASELINE.md) ask for pairs/s/chip measured at
1 chip, 1 host (all chips), and N ≥ 2 hosts with ≥80% scaling
efficiency. This harness measures all three with the same code path:

  python bench_pod.py                      # all local devices, flat ring
  UKC_POD_DEVICES=4 python bench_pod.py    # first 4 devices
  UKC_POD_MESH=2x2 python bench_pod.py     # hierarchical (hosts × devices)
  # multi-host: one process per host with UKC_POD_DISTRIBUTED=1

Prints one JSON line: pairs/s/chip on the mesh, the single-device
reference (measured in-process on device 0), and efficiency =
(mesh pairs/s) / (devices × single-device pairs/s). The sweep result is
gated like bench.py (golden counters on the bundled dataset, the native
sweep's on the synthetic corpus). A run that finds no GPU fails.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))


def _steady(fn, args, reps=5):
    import jax

    # Two warm iterations, each synced with a real host fetch, so no
    # compile or first-execution work leaks into the timed loop.
    for _ in range(2):
        out = fn(*args)
        np.asarray(jax.device_get(out[0])).ravel()[:1]
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    np.asarray(jax.device_get(out[0])).ravel()[:1]
    return (time.perf_counter() - t0) / reps, out


def _fail(msg: str) -> None:
    """One zero-valued record in the success shape, from process 0 only
    (an H-host run would otherwise print H shapeless duplicates)."""
    import jax

    if jax.process_index() == 0:
        print(json.dumps({
            "metric": "ring_sweep_scaling",
            "value": 0.0,
            "unit": "pairs/s/chip",
            "error": msg,
        }))


def main():
    sys.path.insert(0, _ROOT)
    import bench

    from uniprot_kmer_based_clustering_tpu.utils.accel import (
        card_line,
        enable_persistent_cache,
        require_accelerator,
    )

    if os.environ.get("UKC_POD_DISTRIBUTED"):
        # before anything touches a backend
        from uniprot_kmer_based_clustering_tpu.parallel import (
            init_distributed,
        )

        init_distributed()
    require_accelerator()
    enable_persistent_cache()
    with tempfile.TemporaryDirectory(prefix="ukc_pod_") as tmp:
        _run(bench, card_line(), bench.corpus_path(tmp))


def _run(bench, card, fasta):
    import jax

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from uniprot_kmer_based_clustering_tpu.io import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )
    from uniprot_kmer_based_clustering_tpu.parallel import (
        make_mesh,
        make_mesh_2d,
        pad_for_mesh,
    )
    from uniprot_kmer_based_clustering_tpu.parallel.sharded import (
        make_ring_sweep,
        make_ring_sweep_2d,
    )

    table = read_fasta(fasta)
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    idx = build_index(codes, koff, 5)
    GOLDEN = tuple(bench.expected_counters(fasta, table, idx).values())

    mesh_spec = os.environ.get("UKC_POD_MESH")
    if mesh_spec:
        hc, cc = (int(x) for x in mesh_spec.lower().split("x"))
        mesh = make_mesh_2d(hc, cc)
        axes = ("h", "c")
    else:
        nd = os.environ.get("UKC_POD_DEVICES")
        mesh = make_mesh(int(nd) if nd else None)
        axes = ("p",)
    d = int(mesh.devices.size)

    # largest tile whose mesh padding stays under ~7% — 512 matches the
    # flat engine's granularity (measured +6% on the D=1 ring vs 128);
    # large D falls back to finer tiles to keep padded rows (which the
    # sweep pays for but pairs/s does not credit) small
    block_tile = int(os.environ.get("UKC_POD_TILE", "0"))
    if not block_tile:
        for bt in (512, 256, 128):
            block_tile = bt
            if pad_for_mesh(table.n, d, bt) <= table.n * 1.07:
                break
    n_pad = pad_for_mesh(table.n, d, block_tile)
    bitset = pack_bitsets(
        idx.incidence_protein,
        idx.incidence_rank,
        table.n,
        idx.n_repeated,
        row_multiple=n_pad,
        word_multiple=128,
    )
    classes = np.full(bitset.n_pad, -1, np.int32)
    classes[: table.n] = table.amr_class_ids
    weights = np.ones(bitset.w_pad * 32, np.int8)
    n_pairs = table.n * (table.n - 1) / 2.0

    # stage the packed matrix onto the mesh ONCE (same as the pipeline):
    # every sweep/extract/fused call below then passes the committed
    # arrays straight through its internal device_put — without this the
    # warm loops each re-pay the host→device upload, which is harness
    # overhead, not the measured engine
    from uniprot_kmer_based_clustering_tpu.parallel.sharded import (
        stage_mesh_inputs,
    )

    words_st, classes_st = stage_mesh_inputs(mesh, bitset.words, classes)

    def run_mesh(mesh, axes, words_in, classes_in):
        # the library's own staging + replicate helpers (one multi-host
        # staging fix there reaches this harness automatically)
        from uniprot_kmer_based_clustering_tpu.parallel.sharded import (
            _replicate_row_stats,
            _stage_inputs,
        )

        row_spec = P(axes if len(axes) > 1 else axes[0], None)
        cls_spec = P(axes if len(axes) > 1 else axes[0])
        words_s, classes_s, weights_s, _ = _stage_inputs(
            mesh, words_in, classes_in, weights, row_spec, cls_spec
        )
        if len(axes) > 1:
            raw = make_ring_sweep_2d(
                mesh, table.n, 10, block_tile, axes[0], axes[1]
            )
        else:
            raw = make_ring_sweep(mesh, table.n, 10, block_tile, axes[0])

        def fn(*a):
            rs, hits = raw(*a)
            # replicate row_stats before any host fetch: it may be
            # row-sharded across processes and device_get cannot read
            # non-addressable shards (one all-gather)
            return _replicate_row_stats(mesh, rs), hits

        dt, out = _steady(fn, (words_s, classes_s, weights_s))
        row_stats, hits = jax.device_get(out)
        row_stats = np.asarray(row_stats).astype(np.int64)
        got = (
            int(row_stats[:, 0].sum()),
            int(row_stats[:, 1].sum()),
            int(row_stats[:, 2].sum()),
            int(row_stats[:, 3].max()),
        )
        return dt, got, int(np.asarray(hits)[..., 0].max())

    dt_mesh, got, tile_cap = run_mesh(mesh, axes, words_st, classes_st)
    if got != GOLDEN:
        _fail(f"golden parity FAILED: {got}")
        return

    # mesh-parallel extraction (same schedule, no full-matrix replication)
    from uniprot_kmer_based_clustering_tpu.parallel.sharded import (
        sharded_extract_pairs,
    )
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        EXTRACT_USE_TOPK,
    )

    extract_kwargs = dict(
        block_tile=block_tile,
        tile_cap=tile_cap if EXTRACT_USE_TOPK else None,
    )
    # two warm reps (first carries the compile; the wrapper's device_get
    # is a real fetch), then best-of-2 timed
    for _ in range(2):
        pairs = sharded_extract_pairs(
            mesh, words_st, classes_st, table.n, 10, **extract_kwargs
        )
    t_extract = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        pairs = sharded_extract_pairs(
            mesh, words_st, classes_st, table.n, 10, **extract_kwargs
        )
        t_extract = min(t_extract, time.perf_counter() - t0)
    if len(pairs) != GOLDEN[2] or int(pairs[:, 2].max()) != GOLDEN[3]:
        _fail(f"extraction parity FAILED: {len(pairs)}")
        return

    # fused ring (flat mesh): stats + compacted survivors in ONE pass —
    # compare its end-to-end time against sweep + extract above
    fused_stats = {}
    if len(axes) == 1 and os.environ.get("UKC_POD_FUSED", "1") != "0":
        from uniprot_kmer_based_clustering_tpu.parallel.sharded import (
            sharded_pairwise_fused,
        )

        fused_kwargs = dict(
            block_tile=block_tile,
            k=(
                max(512, 1 << int(np.ceil(np.log2(max(tile_cap, 1)))))
                if EXTRACT_USE_TOPK
                else 0
            ),
        )
        for _ in range(2):  # compile + warm, each fetch-synced inside
            out = sharded_pairwise_fused(
                mesh, words_st, classes_st, table.n, 10, **fused_kwargs
            )
        t_fused = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            out = sharded_pairwise_fused(
                mesh, words_st, classes_st, table.n, 10, **fused_kwargs
            )
            t_fused = min(t_fused, time.perf_counter() - t0)
        rs_f, _, _, pairs_f = out
        got_f = (
            int(rs_f[:, 0].sum()), int(rs_f[:, 1].sum()),
            int(rs_f[:, 2].sum()), int(rs_f[:, 3].max()),
        )
        if got_f != GOLDEN or not np.array_equal(pairs_f, pairs):
            _fail("fused ring parity FAILED")
            return
        speedup = (dt_mesh + t_extract) / t_fused
        fused_stats = {
            "fused_seconds": round(t_fused, 4),
            "fused_speedup": round(speedup, 2),
            # the comparison is regime-dependent: fused pays per-step
            # candidate compaction in EVERY sub-block, two-pass pays a
            # second full pass over hit tiles only
            "fused_speedup_note": (
                f"fused {'wins' if speedup >= 1 else 'loses'} at this "
                f"scale ({speedup:.2f}x vs sweep+extract); regime-"
                f"dependent — see DESIGN.md known-limits"
            ),
        }

    # single-device reference with the same engine (process 0's device);
    # only meaningful single-process — on a pod the published 1-chip
    # number travels via UKC_1CHIP_PAIRS_PER_S instead.
    env_ref = os.environ.get("UKC_1CHIP_PAIRS_PER_S")
    if env_ref:
        one_chip = float(env_ref)
    elif d == 1:
        one_chip = n_pairs / dt_mesh
    elif jax.process_count() == 1:
        # the 1-chip reference runs on its own mesh: stage fresh (numpy)
        # inputs for it rather than cross-mesh transfers
        dt_one, _, _ = run_mesh(make_mesh(1), ("p",), bitset.words, classes)
        one_chip = n_pairs / dt_one
    else:
        one_chip = None

    per_chip = n_pairs / dt_mesh / d
    rec = {
        "metric": "ring_sweep_scaling",
        "value": round(per_chip, 1),
        "unit": "pairs/s/chip",
        "devices": d,
        "hosts": int(jax.process_count()),
        "mesh": mesh_spec or f"{d}",
        "pairs_per_s": round(n_pairs / dt_mesh, 1),
        "pairs_per_s_per_chip": round(per_chip, 1),
        "sweep_seconds": round(dt_mesh, 4),
        "extract_seconds": round(t_extract, 4),
        "block_tile": block_tile,
        "parity": "exact",
        "card": card,
        "device_kind": jax.devices()[0].device_kind,
        **fused_stats,
    }
    if one_chip:
        rec["one_chip_pairs_per_s"] = round(one_chip, 1)
        rec["scaling_efficiency"] = round(n_pairs / dt_mesh / (d * one_chip), 4)
    if jax.process_index() == 0:
        print(json.dumps(rec))
        from uniprot_kmer_based_clustering_tpu.utils.artifact import (
            write_bench_artifact,
        )

        write_bench_artifact("pod", rec)


if __name__ == "__main__":
    main()
