"""True multi-process distributed test: 2 jax.distributed processes × 2
virtual CPU devices each, gloo collectives — the closest CPU analogue of a
2-host cluster (SURVEY.md §4: multi-host testing is greenfield; §5:
doc-freq psum + ring sweep + final all-gather are the only cross-host
traffic).

Asserts the ring sweep and the distributed doc-freq are bit-identical to
the single-process oracle, and that both processes observe identical
(replicated) results.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(worker_name, tmp_path, extra_args=(), timeout=240):
    """Launch a 2-process gloo cluster of `worker_name`; return the two
    result npz paths (argv = pid nproc port *extra_args out_npz)."""
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), worker_name)
    outs = [str(tmp_path / f"proc{i}.npz") for i in range(2)]
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port)]
            + list(extra_args)
            + [outs[i]],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=repo_root,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        logs.append(out.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    return outs


def test_two_process_ring_sweep(tmp_path):
    outs = _run_workers("_mp_worker.py", tmp_path)

    a = np.load(outs[0])
    b = np.load(outs[1])
    # both processes observe the identical replicated result
    for key in ("agg", "tile_hits", "pairs", "labels", "freq_nnz"):
        assert np.array_equal(a[key], b[key]), key

    # single-process oracle (this pytest process runs on the 8-device
    # virtual CPU mesh, but sweep_xla is mesh-independent). Per-row stat
    # attribution is engine-specific; the engine contract is aggregate
    # equality + exact pair-set equality (tests/test_sharded.py).
    import jax.numpy as jnp

    from uniprot_kmer_based_clustering_tpu.ops.popcount import sweep_xla
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        extract_pairs,
    )

    rng = np.random.default_rng(123)
    n_pad, w = 512, 32
    n = 500
    words = rng.integers(0, 2**32, size=(n_pad, w), dtype=np.uint32)
    words[n:] = 0
    classes = rng.integers(0, 4, size=n_pad).astype(np.int32)
    classes[n:] = -1
    rs_ref, th_ref, tiles_ref = sweep_xla(
        jnp.asarray(words), classes, n, 10, tile=128
    )
    agg_ref = np.concatenate(
        [
            rs_ref[:, [0, 1, 2, 4, 5, 6]].sum(axis=0),
            rs_ref[:, [3, 7]].max(axis=0),
        ]
    )
    pairs_ref = extract_pairs(
        jnp.asarray(words), classes, th_ref, tiles_ref, n=n, threshold=10
    )
    assert np.array_equal(a["agg"], agg_ref)
    assert np.array_equal(a["pairs"], pairs_ref)

    # collective cluster merge matches the host union-find
    from uniprot_kmer_based_clustering_tpu.models.components import (
        connected_components,
    )

    assert np.array_equal(a["labels"], connected_components(n, pairs_ref))

    # doc-freq oracle: per-row dedup then count
    codes = rng.integers(0, 21**5, size=(4 * 2, 16), dtype=np.int64)
    freq = np.zeros(21**5, np.int64)
    for row in codes:
        freq[np.unique(row)] += 1
    assert a["freq_nnz"][0] == int((freq > 0).sum())
    assert a["freq_nnz"][1] == int(freq.sum())


def test_two_process_full_pipeline(tmp_path):
    """End-to-end `run_pipeline` over a real 2-process distributed mesh
    (the production CLI path on a 2-host slice): both processes must
    produce the identical replicated result, equal to the single-process
    pipeline on the same FASTA."""
    from tests._toy_data import write_toy_fasta

    fasta = write_toy_fasta(str(tmp_path / "toy.fasta"))
    outs = _run_workers(
        "_mp_pipeline_worker.py", tmp_path, extra_args=[fasta], timeout=300
    )

    a = np.load(outs[0])
    b = np.load(outs[1])
    for key in ("pairs", "labels", "report"):
        assert np.array_equal(a[key], b[key]), key

    # single-process oracle (same config as the workers)
    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline

    ref = run_pipeline(
        fasta,
        PipelineConfig(
            tile=16, strip=32, engine="xla", threshold=2
        ),
    )
    rep = ref.parity_report()
    assert np.array_equal(
        a["report"], np.array([rep[k] for k in sorted(rep)], dtype=np.int64)
    )
    assert np.array_equal(a["pairs"], ref.pairwise.pairs)
    assert np.array_equal(a["labels"], ref.cluster_labels)
