"""Headline benchmark: pairwise-similarity pairs/s/chip of the int8
matmul sweep on one GPU.

Prints ONE JSON line:
  {"metric": "pairwise_similarity", "value": <pairs/s/chip>,
   "unit": "pairs/s/chip", "vs_baseline": <ratio>, "card": ..., ...}

Corpus: ``UKC_BENCH_FASTA``, else the bundled ``data/uniprot_arg.fasta``
when the checkout has it, else a 10,619-protein synthetic corpus written
from a fixed seed (bench_scale.synth_proteins). Quality gate: the run only
reports if the sweep reproduces the parity counters — the golden ones
(BASELINE.md) on the bundled dataset, the native C++ sparse sweep's on
any other corpus — so a fast wrong kernel scores zero. A run that finds
no GPU fails; nothing falls back to the CPU.

Baseline: the reference is a multithreaded Rust CPU program with no
published numbers (BASELINE.md); its 258M-edge graph engine needed a
512 GB/12 h SLURM envelope (run.sh). As a *conservative* stand-in we
measure the strongest CPU formulation of the same computation on this
host — scipy.sparse B·Bᵀ over the incidence matrix (exploits sparsity,
far faster than the reference's atomic-pointer graph) — and report
vs_baseline against it. Beating this stand-in by 10× strictly implies
beating the reference by more.

(The framework's own CPU fallback — the native sparse Gustavson sweep,
io/native.py sparse_sweep — is ~9× faster again than this scipy
stand-in, but it is part of the framework under test, not a baseline;
the baseline deliberately stays an independent external implementation.)
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
BUNDLED = os.path.join(_ROOT, "data", "uniprot_arg.fasta")
FASTA = os.environ.get("UKC_BENCH_FASTA", BUNDLED)
GOLDEN = {
    "edges_after_amr_filter": 5_300_233,
    "pairs_after_merge": 4_350_628,
    "pairs_over_threshold": 465,
    "max_shared_kmers": 567,
}


def _cpu_baseline_pairs_per_s(idx, table, n_pairs: float):
    """Scipy-sparse stand-in baseline, or None when scipy is missing —
    the bench must still emit its one JSON line (a completed device
    measurement would otherwise die on the baseline import)."""
    try:
        import scipy.sparse as sp
    except ImportError:
        return None

    best = float("inf")
    for _ in range(3):  # best-of-3: host timings are noisy
        t0 = time.perf_counter()
        b = sp.csr_matrix(
            (
                np.ones(idx.nnz, np.int32),
                (idx.incidence_protein, idx.incidence_rank),
            ),
            shape=(table.n, idx.n_repeated),
        )
        c = (b @ b.T).tocoo()
        i, j, v = c.row, c.col, c.data
        m = i < j
        cls = table.amr_class_ids
        vm = v[m]
        cross = cls[i[m]] != cls[j[m]]
        vc = vm[cross]
        # same reductions as the device sweep
        _ = (int(vc.sum()), int(cross.sum()), int((vc > 10).sum()))
        best = min(best, time.perf_counter() - t0)
    return n_pairs / best


def _baseline_fields(value: float, baseline):
    """vs_baseline record fields, tolerating a missing scipy baseline."""
    if baseline is None:
        return {"vs_baseline": 0.0, "baseline_unavailable": "scipy missing"}
    return {
        "vs_baseline": round(value / baseline, 2),
        "cpu_baseline_pairs_per_s": round(baseline, 1),
    }


def expected_counters(path, table, idx):
    """The gate: the golden counters on the bundled dataset, else the
    native sparse sweep's totals on the same index."""
    if os.path.abspath(path) == BUNDLED:
        return GOLDEN
    from uniprot_kmer_based_clustering_tpu.io import native

    out = native.sparse_sweep(
        idx.incidence_protein, idx.incidence_rank, table.n,
        idx.n_repeated, np.asarray(table.amr_class_ids, np.int32), 10,
    )
    if out is None:
        raise SystemExit("bench: the native C++ reference did not build")
    totals, maxes = out[0].sum(axis=0), out[0].max(axis=0)
    return {
        "edges_after_amr_filter": int(totals[0]),
        "pairs_after_merge": int(totals[1]),
        "pairs_over_threshold": int(totals[2]),
        "max_shared_kmers": int(maxes[3]),
    }


def corpus_path(tmp: str) -> str:
    if os.path.exists(FASTA):
        return FASTA
    import bench_scale

    path = os.path.join(tmp, "synthetic_10619.fasta")
    return bench_scale.write_fasta(path, *bench_scale.synth_proteins(
        10_619, seed=0, n_templates=9_619
    ))


def main():
    sys.path.insert(0, _ROOT)
    import jax

    from uniprot_kmer_based_clustering_tpu.utils.accel import (
        card_line,
        enable_persistent_cache,
        require_accelerator,
    )

    require_accelerator()
    enable_persistent_cache()
    with tempfile.TemporaryDirectory(prefix="ukc_bench_") as tmp:
        _run(jax, card_line(), corpus_path(tmp))


def _run(jax, card, path):

    import jax.numpy as jnp

    from uniprot_kmer_based_clustering_tpu.io import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import sweep_mxu

    table = read_fasta(path)
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    idx = build_index(codes, koff, 5)
    expected = expected_counters(path, table, idx)
    bitset = pack_bitsets(
        idx.incidence_protein,
        idx.incidence_rank,
        table.n,
        idx.n_repeated,
        row_multiple=512,
    )
    words = jnp.asarray(bitset.words)
    classes = np.full(bitset.n_pad, -1, np.int32)
    classes[: table.n] = table.amr_class_ids
    classes = jnp.asarray(classes)
    n_pairs = table.n * (table.n - 1) / 2.0

    # warm-up / compile + quality gate
    row_stats, tile_hits, tiles = sweep_mxu(words, classes, table.n, 10)
    totals = row_stats.sum(axis=0)
    maxes = row_stats.max(axis=0)
    got = {
        "edges_after_amr_filter": int(totals[0]),
        "pairs_after_merge": int(totals[1]),
        "pairs_over_threshold": int(totals[2]),
        "max_shared_kmers": int(maxes[3]),
    }
    if got != expected:
        print(json.dumps({
            "metric": "pairwise_similarity",
            "value": 0.0,
            "unit": "pairs/s/chip",
            "vs_baseline": 0.0,
            "error": f"parity FAILED: {got} != {expected}",
            "card": card,
        }))
        raise SystemExit(1)

    from uniprot_kmer_based_clustering_tpu.ops.bitmul import sweep_mxu_async

    # single synchronous call latency (includes the host fetch)
    reps = int(os.environ.get("UKC_BENCH_REPS", "5"))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        rs, _, _ = sweep_mxu(words, classes, table.n, 10)
        times.append(time.perf_counter() - t0)
    latency = min(times)

    # steady-state throughput: dispatch `reps` back-to-back sweeps, fetch
    # once — the production regime (device work pipelines; the host fetch
    # amortizes). Best of two loops. The finalized stats re-check the
    # parity gate.
    steady = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        handles = None
        for _ in range(reps):
            handles, finalize = sweep_mxu_async(words, classes, table.n, 10)
        rs2, _, _ = finalize(handles)
        steady = min(steady, (time.perf_counter() - t0) / reps)
        if not (rs2 == row_stats).all():
            print(json.dumps({
                "metric": "pairwise_similarity", "value": 0.0,
                "unit": "pairs/s/chip", "vs_baseline": 0.0,
                "error": "steady-state rerun diverged from golden run",
                "card": card,
            }))
            raise SystemExit(1)
    value = n_pairs / steady

    baseline = _cpu_baseline_pairs_per_s(idx, table, n_pairs)

    # the framework's own CPU fallback rate (native sparse sweep) —
    # reported for observability, NOT used as the baseline (it is part
    # of the framework under test)
    native_rate = None
    from uniprot_kmer_based_clustering_tpu.io import native as _native

    if _native.available():
        best = float("inf")
        for _ in range(2):  # best-of-2, like the scipy baseline
            t0 = time.perf_counter()
            out = _native.sparse_sweep(
                idx.incidence_protein, idx.incidence_rank, table.n,
                idx.n_repeated,
                np.asarray(table.amr_class_ids, np.int32), 10,
            )
            if out is None:
                break
            best = min(best, time.perf_counter() - t0)
        if best < float("inf"):
            native_rate = round(n_pairs / best, 1)

    print(json.dumps({
        "metric": "pairwise_similarity",
        "value": round(value, 1),
        "unit": "pairs/s/chip",
        **_baseline_fields(value, baseline),
        "sweep_seconds": round(steady, 4),
        "sync_latency_seconds": round(latency, 4),
        "cpu_native_engine_pairs_per_s": native_rate,
        "parity": (
            "golden-exact" if expected is GOLDEN
            else "exact vs native sparse sweep (synthetic corpus)"
        ),
        "corpus": os.path.basename(path),
        "device": str(jax.devices()[0]),
        "device_kind": jax.devices()[0].device_kind,
        "card": card,
    }))


if __name__ == "__main__":
    main()
