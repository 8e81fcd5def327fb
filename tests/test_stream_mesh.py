"""Sharded out-of-core sweep (parallel/stream_mesh.py) vs the
single-chip engines.

The invariant is the strongest one in the repo: the mesh-composed
stream engine must agree EXACTLY — pair-list equality and identical
aggregate statistics — with the single-chip stream engine AND the
in-core engines, for every device count and every blocking/budget
choice (including budgets that force multi-group re-streaming and
per-device capacities that force the overflow redo).
"""

import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.ops.stream import (
    CSRBlockSource,
    sweep_extract_stream,
)
from uniprot_kmer_based_clustering_tpu.parallel.mesh import make_mesh
from uniprot_kmer_based_clustering_tpu.parallel.stream_mesh import (
    _segment_bounds,
    sweep_extract_stream_mesh,
)
from uniprot_kmer_based_clustering_tpu.similarity import pairwise_similarity
from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
    pairs_as_array,
)

THR = 3


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    n, k = 180, 1200
    rows, cols = np.nonzero(rng.random((n, k)) < 0.06)
    rows = rows.astype(np.int32)
    cols = cols.astype(np.int32)
    bs = pack_bitsets(rows, cols, n, k, row_multiple=16, word_multiple=128)
    classes = rng.integers(0, 3, n).astype(np.int32)
    ref = pairwise_similarity(
        bs, classes,
        PipelineConfig(threshold=THR, tile=16, engine="xla"),
    )
    src = CSRBlockSource(rows, cols, bs.n_pad, bs.w_pad)
    return bs, rows, cols, classes, ref, src


def _stats8(rs):
    rs = np.asarray(rs)
    return tuple(
        int(v)
        for v in np.concatenate(
            [rs[:, [0, 1, 2, 4, 5, 6]].sum(axis=0),
             rs[:, [3, 7]].max(axis=0)]
        )
    )


def _run_mesh(problem, d, **kw):
    bs, rows, cols, classes, ref, src = problem
    mesh = make_mesh(d)
    return sweep_extract_stream_mesh(
        mesh, classes, bs.n, THR, block_source=src, block=16, **kw
    )


def _check_vs_ref(out, problem):
    bs, rows, cols, classes, ref, src = problem
    rs, th, tiles, pairs = out
    assert np.array_equal(pairs_as_array(pairs), ref.pairs)
    s = _stats8(rs)
    assert s[:3] == (ref.cross_weight, ref.cross_pairs, ref.cross_over)
    assert s[3:6] == (ref.same_weight, ref.same_pairs, ref.same_over)
    assert s[6:] == (ref.cross_max, ref.same_max)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_mesh_stream_matches_incore_every_d(problem, d):
    _check_vs_ref(_run_mesh(problem, d, bs=32), problem)


@pytest.mark.parametrize("d", [2, 8])
def test_mesh_stream_budget_forces_regroup(problem, d):
    """A max_group=1 cap (the multi-group re-streaming schedule) and a
    tiny per-device HBM budget must not change results."""
    out = _run_mesh(
        problem, d, bs=16, max_group=1, hbm_budget_bytes=1 << 20,
        scan_chunk=3,
    )
    _check_vs_ref(out, problem)


def test_mesh_stream_matches_single_chip_stream(problem):
    """Same engine, 1-device mesh vs the plain single-chip one-pass
    engine: identical tile hits too (same bs ⇒ same tile grid)."""
    bs, rows, cols, classes, ref, src = problem
    rs1, th1, tl1, pr1 = sweep_extract_stream(
        None, classes, n=bs.n, threshold=THR, bs=32, block=16,
        block_source=CSRBlockSource(rows, cols, bs.n_pad, bs.w_pad),
    )
    rs2, th2, tl2, pr2 = _run_mesh(problem, 4, bs=32)
    assert np.array_equal(th1, th2)
    assert np.array_equal(pairs_as_array(pr1), pairs_as_array(pr2))
    assert _stats8(rs1) == _stats8(rs2)


def test_mesh_stream_packed_format(problem):
    bs, rows, cols, classes, ref, src = problem
    out = _run_mesh(problem, 4, bs=32, pair_format="packed")
    pairs = out[3]
    assert pairs.ndim == 1 and pairs.dtype == np.int64
    assert np.array_equal(pairs_as_array(pairs), ref.pairs)


def test_mesh_stream_overflow_redo(problem):
    """Per-device capacity below the survivor count: the exact redo
    path (grouped single-device extractor) must deliver the identical
    pair list."""
    from uniprot_kmer_based_clustering_tpu.parallel import stream_mesh

    out = _run_mesh(problem, 4, bs=32, cap=8)
    assert stream_mesh.last_mesh_trace["overflow"]
    _check_vs_ref(out, problem)


def test_mesh_stream_weighted(problem):
    """BLOSUM-style int8 column weights flow through the mesh
    composition identically to the single-chip stream engine."""
    bs, rows, cols, classes, ref, src = problem
    rng = np.random.default_rng(3)
    weights = rng.integers(1, 5, bs.w_pad * 32).astype(np.int8)
    rs1, th1, _, pr1 = sweep_extract_stream(
        None, classes, n=bs.n, threshold=THR, bs=32, block=16,
        weights=weights,
        block_source=CSRBlockSource(rows, cols, bs.n_pad, bs.w_pad),
    )
    rs2, th2, _, pr2 = _run_mesh(problem, 2, bs=32, weights=weights)
    assert np.array_equal(th1, th2)
    assert np.array_equal(pairs_as_array(pr1), pairs_as_array(pr2))
    assert _stats8(rs1) == _stats8(rs2)


def test_mesh_stream_include_same(problem):
    """cross_amr_only=False (same-class pairs kept) matches the
    single-chip engine."""
    bs, rows, cols, classes, ref, src = problem
    rs1, th1, _, pr1 = sweep_extract_stream(
        None, classes, n=bs.n, threshold=THR, bs=32, block=16,
        cross_amr_only=False,
        block_source=CSRBlockSource(rows, cols, bs.n_pad, bs.w_pad),
    )
    rs2, th2, _, pr2 = _run_mesh(
        problem, 4, bs=32, cross_amr_only=False
    )
    assert np.array_equal(th1, th2)
    assert np.array_equal(pairs_as_array(pr1), pairs_as_array(pr2))


def test_segment_bounds_balance():
    """The weighted contiguous split: monotone bounds covering the
    range, and no device more than one max-weight item above the
    ideal share."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        m = int(rng.integers(1, 40))
        d = int(rng.choice([1, 2, 4, 8]))
        w = rng.integers(1, 23, m).astype(np.int64)
        b = _segment_bounds(w, d)
        assert b[0] == 0 and b[-1] == m
        assert (np.diff(b) >= 0).all()
        per = np.array([w[b[k]: b[k + 1]].sum() for k in range(d)])
        assert per.sum() == w.sum()
        assert per.max() <= w.sum() / d + w.max()


def test_mesh_stream_real_data_slice():
    """A real-data slice of the bundled reference corpus (full runs are
    hardware-bench territory — the 10.6k² CPU matmul takes >15 min on
    this host): the mesh composition must equal the single-chip
    one-pass engine exactly, threshold 3 (the 600-protein strided
    sample carries 60 cross-AMR survivors there; at the full corpus's
    threshold 10 the sample has none), real AMR classes. The full
    bundled golden (465/567) is gated on hardware by bench_scale's
    stream-mesh mode and by the dryrun at synthetic scale."""
    import os

    p = "/root/reference/uniprot_arg.fasta"
    if not os.path.exists(p):
        pytest.skip("reference dataset not available")
    from uniprot_kmer_based_clustering_tpu.io.fasta import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers.encode import encode_kmers
    from uniprot_kmer_based_clustering_tpu.kmers.index import build_index

    table = read_fasta(p)
    # strided sample so the slice mixes AMR classes (the file is
    # class-clustered — a contiguous prefix is all one class and has
    # zero cross-AMR survivors)
    sel = np.arange(0, table.n, 17)[:600]
    n = len(sel)
    parts = [
        table.seq_buf[table.offsets[i]: table.offsets[i + 1]]
        for i in sel
    ]
    seq_buf = np.concatenate(parts)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(s) for s in parts], out=offs[1:])
    codes, koff = encode_kmers(seq_buf, offs, 5)
    index = build_index(codes, koff, 5)
    w_pad = -(-index.n_repeated // 32 // 128) * 128
    n_pad = -(-n // 128) * 128
    classes = np.asarray(table.amr_class_ids, np.int32)[sel]
    src = CSRBlockSource(
        index.incidence_protein, index.incidence_rank, n_pad, w_pad
    )
    rs1, th1, _, pr1 = sweep_extract_stream(
        None, classes, n=n, threshold=3, bs=256, block=128,
        block_source=src, pair_format="packed",
    )
    rs2, th2, _, pr2 = sweep_extract_stream_mesh(
        make_mesh(8), classes, n, 3,
        block_source=CSRBlockSource(
            index.incidence_protein, index.incidence_rank, n_pad, w_pad
        ),
        bs=256, block=128, pair_format="packed",
    )
    assert np.array_equal(th1, th2)
    assert np.array_equal(pairs_as_array(pr1), pairs_as_array(pr2))
    assert _stats8(rs1) == _stats8(rs2)
    assert pairs_as_array(pr1).shape[0] > 0  # real survivors in the slice


def test_mesh_stream_checkpoint_kill_resume(problem, tmp_path):
    """Mesh kill/resume: die after one group (fault seam), resume with
    the same store/key on the SAME mesh — and then resume a single-chip
    snapshot THROUGH the mesh engine (the snapshots are
    layout-compatible) — all bit-identical to an uncheckpointed run."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        sweep_extract_stream,
    )
    from uniprot_kmer_based_clustering_tpu.parallel import stream_mesh
    from uniprot_kmer_based_clustering_tpu.utils.checkpoint import (
        CheckpointStore,
    )

    bs, rows, cols, classes, ref, src = problem
    store = CheckpointStore(str(tmp_path))
    kw = dict(bs=16, max_group=1, scan_chunk=3)
    rs0, th0, _, pr0 = _run_mesh(problem, 4, **kw)

    with pytest.raises(RuntimeError, match="fault injection"):
        _run_mesh(
            problem, 4, checkpoint_store=store, checkpoint_key="m",
            fail_after_groups=2, **kw
        )
    snap = store.load("m")
    assert snap is not None and len(snap["groups_done"]) == 2
    rs1, th1, _, pr1 = _run_mesh(
        problem, 4, checkpoint_store=store, checkpoint_key="m", **kw
    )
    assert stream_mesh.last_mesh_trace["groups_skipped"] == 2
    assert np.array_equal(th1, th0)
    assert np.array_equal(pairs_as_array(pr1), pairs_as_array(pr0))
    assert _stats8(rs1) == _stats8(rs0)
    assert store.load("m") is None  # completed run removed the snapshot

    # cross-engine resume: a SINGLE-CHIP pass dies mid-sweep, the MESH
    # engine picks the snapshot up (identical geometry layout) — and
    # the reverse. Same (bs, g) geometry via max_group=1/bs=16.
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    with pytest.raises(RuntimeError, match="fault injection"):
        sweep_extract_stream(
            None, cls, n=bs.n, threshold=THR, bs=16, block=16,
            max_group=1,
            block_source=CSRBlockSource(rows, cols, bs.n_pad, bs.w_pad),
            checkpoint_store=store, checkpoint_key="x",
            fail_after_groups=3,
        )
    rs2, th2, _, pr2 = _run_mesh(
        problem, 2, checkpoint_store=store, checkpoint_key="x", **kw
    )
    assert stream_mesh.last_mesh_trace["groups_skipped"] == 3
    assert np.array_equal(pairs_as_array(pr2), pairs_as_array(pr0))
    assert _stats8(rs2) == _stats8(rs0)
