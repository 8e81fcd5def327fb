"""Out-of-core streaming engine (ops/stream.py) vs the in-core engines.

The invariant is the usual one: every sweep engine must agree EXACTLY —
pair-list equality and identical statistics — for every blocking choice.
"""

import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.similarity import pairwise_similarity

THR = 3


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    n, k = 150, 1200
    rows, cols = np.nonzero(rng.random((n, k)) < 0.06)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=16, word_multiple=128,
    )
    classes = rng.integers(0, 3, n).astype(np.int32)
    ref = pairwise_similarity(
        bs, classes,
        PipelineConfig(threshold=THR, tile=16, engine="xla"),
    )
    return bs, classes, ref


def _check_same(a, b):
    for f in (
        "cross_weight", "cross_pairs", "cross_over", "cross_max",
        "same_weight", "same_pairs", "same_over", "same_max",
    ):
        assert getattr(a, f) == getattr(b, f), f
    assert np.array_equal(a.pairs, b.pairs)


def test_stream_engine_matches_xla(problem):
    bs, classes, ref = problem
    cfg = PipelineConfig(
        threshold=THR, tile=16, engine="stream"
    )
    _check_same(pairwise_similarity(bs, classes, cfg), ref)


@pytest.mark.parametrize("bs_rows", [16, 32, 48, 160])
def test_stream_blocking_invariance(problem, bs_rows):
    """Bit-identical for every stream-block size, including one that
    forces row padding beyond the packed matrix (160 rows = one block)
    and one that doesn't divide the padded row count (48)."""
    bs, classes, ref = problem
    cfg = PipelineConfig(
        threshold=THR, tile=16, engine="stream",
        strip=bs_rows,
    )
    _check_same(pairwise_similarity(bs, classes, cfg), ref)


def test_stream_small_group_budget(problem):
    """A budget so small that the stationary group degenerates to one
    block per group — maximum re-streaming — must not change results."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        extract_pairs_stream,
        sweep_mxu_stream,
    )

    bs, classes, ref = problem
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    rs, th, tiles = sweep_mxu_stream(
        bs.words, cls, n=bs.n, threshold=THR, bs=16, block=16,
        hbm_budget_bytes=1 << 20, inflight=1,
    )
    tot = rs.sum(axis=0)
    assert (int(tot[0]), int(tot[1]), int(tot[2])) == (
        ref.cross_weight, ref.cross_pairs, ref.cross_over,
    )
    assert int(rs[:, 3].max()) == ref.cross_max
    got = extract_pairs_stream(
        bs.words, cls, th, tiles, n=bs.n, threshold=THR
    )
    assert np.array_equal(got, ref.pairs)


def test_stream_word_chunked(problem):
    """Contraction-axis chunking: word_chunk=64 < w_words=128 actually
    takes the lax.scan chunked branch (128 would be the unchunked one)."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import sweep_mxu_stream

    bs, classes, ref = problem
    assert bs.w_pad > 64  # the chunked branch requires word_chunk < W
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    rs, th, tiles = sweep_mxu_stream(
        bs.words, cls, n=bs.n, threshold=THR, bs=32, block=16,
        word_chunk=64,
    )
    tot = rs.sum(axis=0)
    assert (int(tot[0]), int(tot[1])) == (ref.cross_weight, ref.cross_pairs)


def test_stream_dense_scatter_path(problem, monkeypatch):
    """Ultra-dense tiles route to the cumsum+scatter extractor: shrink
    the density crossover so every hit tile counts as dense, then demand
    bit-identical output at threshold 0 (the densest regime)."""
    import uniprot_kmer_based_clustering_tpu.ops.stream as stream_mod

    bs, classes, _ = problem
    ref = pairwise_similarity(
        bs, classes,
        PipelineConfig(threshold=0, tile=16, engine="xla"),
    )
    monkeypatch.setattr(stream_mod, "TOPK_CAP", 1)
    got = pairwise_similarity(
        bs, classes,
        PipelineConfig(
            threshold=0, tile=16, engine="stream", strip=32
        ),
    )
    _check_same(got, ref)


def test_stream_cross_amr_false(problem):
    bs, classes, _ = problem
    ref = pairwise_similarity(
        bs, classes,
        PipelineConfig(
            threshold=THR, tile=16, engine="xla",
            cross_amr_only=False,
        ),
    )
    got = pairwise_similarity(
        bs, classes,
        PipelineConfig(
            threshold=THR, tile=16, engine="stream",
            cross_amr_only=False, strip=32,
        ),
    )
    _check_same(got, ref)


def test_stream_weighted_matches_mxu(problem):
    """BLOSUM-style int8 column weights ride the streaming matmul; the
    weighted dispatch must not silently reroute stream to in-core mxu
    (it carries weights natively)."""
    bs, classes, _ = problem
    rng = np.random.default_rng(3)
    weights = rng.integers(1, 12, bs.w_pad * 32).astype(np.int8)
    cfg_m = PipelineConfig(
        threshold=THR, tile=16, engine="mxu",
        weighting="blosum62", weighted_threshold=THR * 6,
    )
    cfg_s = PipelineConfig(
        threshold=THR, tile=16, engine="stream",
        weighting="blosum62", weighted_threshold=THR * 6, strip=32,
    )
    ref = pairwise_similarity(bs, classes, cfg_m, weights=weights)
    got = pairwise_similarity(bs, classes, cfg_s, weights=weights)
    _check_same(got, ref)


def test_stream_fused_matches_two_pass(problem):
    """Fused (in-sweep candidate drain) extraction is bit-identical to
    the two-pass stream extractor."""
    bs, classes, ref = problem
    cfg = PipelineConfig(
        threshold=THR, tile=16, engine="stream",
        extract="fused", strip=32,
    )
    _check_same(pairwise_similarity(bs, classes, cfg), ref)


def test_stream_fused_overflow_redo(problem):
    """A candidate capacity smaller than the densest tile's hit count
    forces the truncation-detect + two-pass-redo path; output must stay
    bit-identical (threshold 0 maximizes per-tile density)."""
    bs, classes, _ = problem
    ref = pairwise_similarity(
        bs, classes,
        PipelineConfig(threshold=0, tile=16, engine="xla"),
    )
    cfg = PipelineConfig(
        threshold=0, tile=16, engine="stream",
        extract="fused", extract_k=8, strip=32,  # 8 << 16*16 tile area
    )
    _check_same(pairwise_similarity(bs, classes, cfg), ref)


def test_stream_fused_all_pairs(problem):
    """cross_amr_only=False rides the fused_same candidate mask."""
    bs, classes, _ = problem
    ref = pairwise_similarity(
        bs, classes,
        PipelineConfig(
            threshold=THR, tile=16, engine="xla",
            cross_amr_only=False,
        ),
    )
    got = pairwise_similarity(
        bs, classes,
        PipelineConfig(
            threshold=THR, tile=16, engine="stream",
            cross_amr_only=False, extract="fused", strip=32,
        ),
    )
    _check_same(got, ref)


def test_stream_fused_weighted(problem):
    """Weighted scores ride the fused candidate drain (bc carries the
    weighted counts) — reachable in production since weighted runs stay
    on the stream engine."""
    bs, classes, _ = problem
    rng = np.random.default_rng(5)
    weights = rng.integers(1, 12, bs.w_pad * 32).astype(np.int8)
    kwargs = dict(
        threshold=THR, tile=16, 
        weighting="blosum62", weighted_threshold=THR * 6, strip=32,
    )
    ref = pairwise_similarity(
        bs, classes, PipelineConfig(engine="mxu", **kwargs),
        weights=weights,
    )
    got = pairwise_similarity(
        bs, classes,
        PipelineConfig(engine="stream", extract="fused", **kwargs),
        weights=weights,
    )
    _check_same(got, ref)


def test_stream_fused_extract_k_over_tile_area(problem):
    """extract_k beyond the sub-tile area must be clamped, not crash in
    lax.top_k (the in-core engine clamps; the keep/redo split must use
    the clamped value on BOTH sides)."""
    bs, classes, ref = problem
    cfg = PipelineConfig(
        threshold=THR, tile=16, engine="stream",
        extract="fused", extract_k=4096, strip=32,  # 4096 >> 16*16
    )
    _check_same(pairwise_similarity(bs, classes, cfg), ref)


def test_stream_fuzz_parity():
    """Randomized shapes/densities/thresholds/class layouts (the native
    fuzz matrix): stream must match xla exactly, row stats AND pairs,
    including degenerate inputs (single protein, empty incidence,
    threshold 0 with same-class pairs kept)."""
    rng = np.random.default_rng(11)
    cases = [
        (1, 40, 0.2, 1, 0),
        (2, 40, 0.0, 3, 1),    # no incidences at all
        (17, 130, 0.3, 1, 0),  # all same class, threshold 0
        (33, 513, 0.08, 4, 2),
        (64, 64, 0.5, 2, 5),   # dense bitset, high counts
    ]
    for n, k, dens, n_cls, thr in cases:
        rows, cols = np.nonzero(rng.random((n, k)) < dens)
        bs = pack_bitsets(
            rows.astype(np.int32), cols.astype(np.int32), n, k,
            row_multiple=8, word_multiple=128,
        )
        classes = rng.integers(0, n_cls, n).astype(np.int32)
        for cross_only in (True, False):
            ref = pairwise_similarity(
                bs, classes,
                PipelineConfig(
                    threshold=thr, tile=8, engine="xla",
                    cross_amr_only=cross_only,
                ),
            )
            got = pairwise_similarity(
                bs, classes,
                PipelineConfig(
                    threshold=thr, tile=8, engine="stream",
                    cross_amr_only=cross_only, strip=16,
                ),
            )
            _check_same(got, ref)


def _sweep_and_ref(problem, threshold=THR):
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        sweep_mxu_stream,
    )

    bs, classes, ref = problem
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    rs, th, tiles = sweep_mxu_stream(
        bs.words, cls, n=bs.n, threshold=threshold, bs=32, block=16
    )
    return bs, cls, th, tiles, ref


@pytest.mark.parametrize("gbs", [16, 48, 160, None])
def test_stream_grouped_matches_two_pass(problem, gbs):
    """The grouped (sweep-schedule) extractor is bit-identical to the
    per-tile window extractor for every blocking choice, including a
    block that doesn't divide the padded rows (48), one block total
    (160), and the budget-auto choice (None)."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        extract_pairs_stream_grouped,
    )

    bs, cls, th, tiles, ref = _sweep_and_ref(problem)
    got = extract_pairs_stream_grouped(
        bs.words, cls, th, tiles, n=bs.n, threshold=THR, bs=gbs
    )
    assert np.array_equal(got, ref.pairs)


def test_stream_grouped_tiny_budget(problem):
    """Budget so small the stationary group is one block — maximum
    re-streaming, plus the word-chunked operand path."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        extract_pairs_stream_grouped,
    )

    bs, cls, th, tiles, ref = _sweep_and_ref(problem)
    got = extract_pairs_stream_grouped(
        bs.words, cls, th, tiles, n=bs.n, threshold=THR, bs=16,
        hbm_budget_bytes=1 << 20, inflight=1,
    )
    assert np.array_equal(got, ref.pairs)


def test_stream_grouped_masked_subset(problem):
    """A tile_hits mask restricted to a subset of hit tiles (the fused
    redo contract) must return exactly that subset's pairs."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        extract_pairs_stream_grouped,
    )

    bs, cls, th, tiles, ref = _sweep_and_ref(problem)
    ti, tj, tile = tiles
    th = np.asarray(th)
    hit = np.nonzero(th[:, 0] > 0)[0]
    rng = np.random.default_rng(2)
    sel = rng.choice(hit, size=max(1, len(hit) // 3), replace=False)
    masked = np.zeros_like(th)
    masked[sel] = th[sel]
    got = extract_pairs_stream_grouped(
        bs.words, cls, masked, tiles, n=bs.n, threshold=THR, bs=32
    )
    # expected: the reference pairs whose tile is in the subset
    sel_set = {(int(ti[s]), int(tj[s])) for s in sel}
    want = np.array(
        [
            p for p in ref.pairs
            if (int(p[0]) // tile, int(p[1]) // tile) in sel_set
        ],
        dtype=np.int32,
    ).reshape(-1, 3)
    assert np.array_equal(got, want)


def test_stream_grouped_all_pairs_and_weighted(problem):
    """cross_amr_only=False and int8 column weights both ride the
    grouped pass (same mask/operand semantics as the window path)."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        extract_pairs_stream,
        extract_pairs_stream_grouped,
        sweep_mxu_stream,
    )

    bs, classes, _ = problem
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    rng = np.random.default_rng(9)
    weights = rng.integers(1, 12, bs.w_pad * 32).astype(np.int8)
    for cross_only, wts in (
        (False, None), (True, weights), (False, weights),
    ):
        rs, th, tiles = sweep_mxu_stream(
            bs.words, cls, n=bs.n, threshold=THR * 4, bs=32, block=16,
            weights=wts,
        )
        kw = dict(
            n=bs.n, threshold=THR * 4, cross_amr_only=cross_only,
            weights=wts,
        )
        want = extract_pairs_stream(bs.words, cls, th, tiles, **kw)
        got = extract_pairs_stream_grouped(
            bs.words, cls, th, tiles, bs=32, **kw
        )
        assert np.array_equal(got, want)


def test_stream_extract_auto(problem):
    """The volume dispatcher gives the same answer as both extractors
    (whichever side of the crossover this problem lands on)."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        extract_pairs_stream_auto,
    )

    bs, cls, th, tiles, ref = _sweep_and_ref(problem)
    got = extract_pairs_stream_auto(
        bs.words, cls, th, tiles, n=bs.n, threshold=THR
    )
    assert np.array_equal(got, ref.pairs)


def test_stream_fused_redo_grouped(problem):
    """The fused overflow redo can take the grouped pass explicitly and
    must stay bit-identical (threshold 0 + tiny capacity = every tile
    truncated, the regime the grouped redo exists for)."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        extract_pairs_stream_fused,
        sweep_mxu_stream,
    )

    bs, classes, _ = problem
    ref = pairwise_similarity(
        bs, classes,
        PipelineConfig(threshold=0, tile=16, engine="xla"),
    )
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    rs, th, tiles, cands = sweep_mxu_stream(
        bs.words, cls, n=bs.n, threshold=0, bs=32, block=16, fused_k=8
    )
    got = extract_pairs_stream_fused(
        bs.words, cls, th, tiles, cands, n=bs.n, threshold=0,
        redo="grouped",
    )
    assert np.array_equal(got, ref.pairs)


def test_stream_grouped_word_chunked_unweighted(problem):
    """The chunked operand path slices the weights array
    unconditionally — the unweighted grouped call must still feed it an
    array (regression: the first hardware engines-gate run crashed on
    NoneType.ndim in dynamic_slice_in_dim)."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        extract_pairs_stream_grouped,
    )

    bs, cls, th, tiles, ref = _sweep_and_ref(problem)
    got = extract_pairs_stream_grouped(
        bs.words, cls, th, tiles, n=bs.n, threshold=THR, bs=32,
        word_chunk=64,  # < w_words=128: the chunked branch
    )
    assert np.array_equal(got, ref.pairs)


def test_stream_grouped_empty(problem):
    """All-zero tile hits: the early return, no device work."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        extract_pairs_stream_grouped,
    )

    bs, cls, th, tiles, _ = _sweep_and_ref(problem)
    got = extract_pairs_stream_grouped(
        bs.words, cls, np.zeros_like(np.asarray(th)), tiles,
        n=bs.n, threshold=THR,
    )
    assert got.shape == (0, 3)


@pytest.mark.parametrize("obs", [16, 48, None])
def test_stream_onepass_matches_reference(problem, obs):
    """The one-pass sweep+extract engine: stats AND pairs from a single
    streamed pass, bit-identical to the xla reference for every blocking
    choice."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        sweep_extract_stream,
    )

    bs, classes, ref = problem
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    rs, th, tiles, pairs = sweep_extract_stream(
        bs.words, cls, n=bs.n, threshold=THR, bs=obs, block=16
    )
    tot = rs.sum(axis=0)
    assert (int(tot[0]), int(tot[1]), int(tot[2])) == (
        ref.cross_weight, ref.cross_pairs, ref.cross_over,
    )
    assert int(rs[:, 3].max()) == ref.cross_max
    assert np.array_equal(pairs, ref.pairs)


def test_stream_onepass_packed_pairs(problem):
    """pair_format="packed": the int64 packed list decodes to exactly
    the canonical [M, 3] matrix (8 B/pair fetch — the beyond-HBM
    readback optimization), and the per-element helpers agree."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        sweep_extract_stream,
    )
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        packed_key,
        packed_pair,
        pairs_as_array,
        unpack_pairs,
    )

    bs, classes, ref = problem
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    rs, th, tiles, pairs = sweep_extract_stream(
        bs.words, cls, n=bs.n, threshold=THR, bs=32, block=16,
        pair_format="packed",
    )
    assert pairs.ndim == 1 and pairs.dtype == np.int64
    assert np.array_equal(unpack_pairs(pairs), ref.pairs)
    assert np.array_equal(pairs_as_array(pairs), ref.pairs)
    assert pairs_as_array(ref.pairs) is ref.pairs
    # packed values are sorted and the key helper is the searchsorted
    # lower bound of each stored pair
    assert np.all(np.diff(pairs) > 0)
    i, j, c = (int(v) for v in ref.pairs[len(ref.pairs) // 2])
    p = int(np.searchsorted(pairs, packed_key(i, j)))
    assert packed_pair(pairs[p]) == (i, j, c)


def test_stream_onepass_packed_overflow_redo(problem):
    """The capacity-miss redo (grouped pass) honors the packed format
    too — the artifact's fetch discipline must not silently regress on
    overflow."""
    from uniprot_kmer_based_clustering_tpu.ops import stream as stream_mod
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        sweep_extract_stream,
    )
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        unpack_pairs,
    )

    bs, classes, ref = problem
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    rs, th, tiles, pairs = sweep_extract_stream(
        bs.words, cls, n=bs.n, threshold=THR, bs=32, block=16, cap=8,
        pair_format="packed",
    )
    assert stream_mod.last_onepass_trace["overflow"] is True
    assert pairs.ndim == 1
    assert np.array_equal(unpack_pairs(pairs), ref.pairs)


def test_packed_fetch_count_fallback():
    """A stored count ≥ 2^16 cannot pack — the finalize must detect it
    on device and fall back to the [M, 3] format (never corrupt)."""
    import jax.numpy as jnp

    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _fetch_sorted_pairs,
    )

    bi = jnp.asarray(np.array([3, 1], np.int32))
    bj = jnp.asarray(np.array([5, 2], np.int32))
    bc = jnp.asarray(np.array([1 << 16, 7], np.int32))
    got = _fetch_sorted_pairs(bi, bj, bc, 2, "packed", n_rows=10)
    assert got.ndim == 2
    assert np.array_equal(got, [[1, 2, 7], [3, 5, 1 << 16]])
    # counts strictly below the limit pack fine
    bc_ok = jnp.asarray(np.array([(1 << 16) - 1, 7], np.int32))
    got = _fetch_sorted_pairs(bi, bj, bc_ok, 2, "packed", n_rows=10)
    assert got.ndim == 1
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        unpack_pairs,
    )

    assert np.array_equal(
        unpack_pairs(got), [[1, 2, 7], [3, 5, (1 << 16) - 1]]
    )


def test_packed_fetch_row_limit():
    """Row indices ≥ 2^23 set the int64 sign bit at the i-field shift
    (bits 40-63): the pack must refuse such corpora (n_rows bound) and
    stay exact right up to the bound (advisor r04 medium finding)."""
    import jax.numpy as jnp

    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _PACK_ROW_LIMIT,
        _fetch_sorted_pairs,
        packed_key,
        packed_pair,
        unpack_pairs,
    )

    assert _PACK_ROW_LIMIT == 1 << 23
    hi = _PACK_ROW_LIMIT - 2  # largest valid i (j = i + 1 < limit)
    bi = jnp.asarray(np.array([hi, 1], np.int32))
    bj = jnp.asarray(np.array([hi + 1, 2], np.int32))
    bc = jnp.asarray(np.array([9, 7], np.int32))
    # n_rows at the bound: falls back to [M, 3] (sign-bit hazard)
    got = _fetch_sorted_pairs(bi, bj, bc, 2, "packed",
                              n_rows=_PACK_ROW_LIMIT)
    assert got.ndim == 2
    # n_rows just inside: packs, sorts canonically, round-trips
    got = _fetch_sorted_pairs(bi, bj, bc, 2, "packed",
                              n_rows=_PACK_ROW_LIMIT - 1)
    assert got.ndim == 1 and np.all(got > 0)  # sign bit clear
    assert np.array_equal(
        unpack_pairs(got), [[1, 2, 7], [hi, hi + 1, 9]]
    )
    assert packed_pair(packed_key(hi, hi + 1) | 9) == (hi, hi + 1, 9)


def test_stream_onepass_capacity_miss_redo(problem):
    """A capacity smaller than the survivor count must be detected from
    the cursor/stats mismatch and redone exactly (never truncated)."""
    from uniprot_kmer_based_clustering_tpu.ops import stream as stream_mod
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        sweep_extract_stream,
    )

    bs, classes, ref = problem
    assert len(ref.pairs) > 8
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    rs, th, tiles, pairs = sweep_extract_stream(
        bs.words, cls, n=bs.n, threshold=THR, bs=32, block=16, cap=8
    )
    assert stream_mod.last_onepass_trace["overflow"] is True
    assert np.array_equal(pairs, ref.pairs)


def test_stream_onepass_all_pairs_weighted_and_budget(problem):
    """all-pairs mode, int8 weights, and a starvation budget all ride
    the one-pass engine exactly."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        extract_pairs_stream,
        sweep_extract_stream,
        sweep_mxu_stream,
    )

    bs, classes, _ = problem
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    rng = np.random.default_rng(13)
    weights = rng.integers(1, 12, bs.w_pad * 32).astype(np.int8)
    for cross_only, wts, kw in (
        (False, None, {}),
        (True, weights, {}),
        (True, None, dict(hbm_budget_bytes=1 << 20, inflight=1)),
    ):
        rs_w, th_w, tl_w = sweep_mxu_stream(
            bs.words, cls, n=bs.n, threshold=THR * 4, bs=32, block=16,
            weights=wts,
        )
        want = extract_pairs_stream(
            bs.words, cls, th_w, tl_w, n=bs.n, threshold=THR * 4,
            cross_amr_only=cross_only, weights=wts,
        )
        rs, th, tiles, pairs = sweep_extract_stream(
            bs.words, cls, n=bs.n, threshold=THR * 4, bs=32, block=16,
            weights=wts, cross_amr_only=cross_only, **kw,
        )
        assert np.array_equal(np.asarray(rs), np.asarray(rs_w))
        assert np.array_equal(pairs, want)


def test_stream_onepass_via_config(problem):
    """extract='onepass' through the production dispatch."""
    bs, classes, ref = problem
    cfg = PipelineConfig(
        threshold=THR, tile=16, engine="stream",
        extract="onepass", strip=32,
    )
    _check_same(pairwise_similarity(bs, classes, cfg), ref)


def test_onepass_requires_stream_engine(problem):
    bs, classes, _ = problem
    with pytest.raises(ValueError, match="stream"):
        pairwise_similarity(
            bs, classes,
            PipelineConfig(
                threshold=THR, tile=16, engine="xla",
                extract="onepass",
            ),
        )


def test_stream_empty_result():
    """No pair clears an impossible threshold — the empty-extraction
    early return."""
    rng = np.random.default_rng(1)
    n, k = 40, 300
    rows, cols = np.nonzero(rng.random((n, k)) < 0.03)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=16, word_multiple=128,
    )
    classes = rng.integers(0, 2, n).astype(np.int32)
    r = pairwise_similarity(
        bs, classes,
        PipelineConfig(
            threshold=10**6, tile=16, engine="stream"
        ),
    )
    assert r.pairs.shape == (0, 3)


def test_sort_compact_append_contract():
    """Direct unit pin of the sort-based append: survivors land
    contiguously at the cursor, tails are sentinels, repeated appends
    chain, and the window write never clamps while cursor <= vcap
    (buffers carry one window of slack)."""
    import jax.numpy as jnp

    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        sort_compact_append,
    )
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _IMAX,
        _new_pair_buffers,
    )

    rng = np.random.default_rng(3)
    window, vcap = 64, 128
    gbi, gbj, gbc, cursor = _new_pair_buffers(vcap + window)

    expect = []
    for _ in range(3):  # three chained appends, mixed densities
        keep = jnp.asarray(rng.random((8, 8)) < 0.4)
        gi = jnp.asarray(rng.integers(0, 1000, (8, 8)), jnp.int32)
        gj = jnp.asarray(rng.integers(0, 1000, (8, 8)), jnp.int32)
        c = jnp.asarray(rng.integers(1, 99, (8, 8)), jnp.int32)
        gbi, gbj, gbc, cursor = sort_compact_append(
            gbi, gbj, gbc, cursor, keep, gi, gj, c
        )
        m = np.asarray(keep).ravel()
        expect.extend(
            zip(np.asarray(gi).ravel()[m], np.asarray(gj).ravel()[m],
                np.asarray(c).ravel()[m])
        )

    n_kept = int(cursor)
    assert n_kept == len(expect)
    got = set(
        zip(np.asarray(gbi)[:n_kept], np.asarray(gbj)[:n_kept],
            np.asarray(gbc)[:n_kept])
    )
    assert got == set(expect)  # exact survivor multiset (values unique enough)
    # everything past the cursor is sentinel
    assert (np.asarray(gbi)[n_kept:] == _IMAX).all()
    assert (np.asarray(gbc)[n_kept:] == -1).all()

    # zero-survivor append: cursor unchanged, no corruption
    gbi2, gbj2, gbc2, cur2 = sort_compact_append(
        gbi, gbj, gbc, cursor,
        jnp.zeros((8, 8), bool),
        jnp.zeros((8, 8), jnp.int32),
        jnp.zeros((8, 8), jnp.int32),
        jnp.zeros((8, 8), jnp.int32),
    )
    assert int(cur2) == n_kept
    assert np.array_equal(np.asarray(gbi2)[:n_kept], np.asarray(gbi)[:n_kept])

    # full-window append with cursor at vcap: lands in the slack region
    # without clamping away valid rows
    gbi3, gbj3, gbc3, cur3 = _new_pair_buffers(vcap + window)
    gbi3, gbj3, gbc3, cur3 = sort_compact_append(
        gbi3, gbj3, gbc3, jnp.int32(vcap),
        jnp.ones((8, 8), bool),
        jnp.full((8, 8), 7, jnp.int32),
        jnp.full((8, 8), 9, jnp.int32),
        jnp.full((8, 8), 3, jnp.int32),
    )
    assert int(cur3) == vcap + window
    assert (np.asarray(gbi3)[vcap:] == 7).all()
    assert (np.asarray(gbi3)[:vcap] == _IMAX).all()  # untouched


def test_stream_multigroup_schedule_matches_single(problem):
    """max_group=1 forces the multi-group re-streaming schedule
    (stationary groups + per-group moving re-uploads) that real budgets
    only trigger at beyond-HBM scale — outputs must be bit-identical to
    the default single-group pass for all three stream entry points."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        extract_pairs_stream_grouped,
        sweep_extract_stream,
        sweep_mxu_stream,
    )

    bs, classes, _ref = problem
    n = bs.n
    ref_rs, ref_th, ref_tl = sweep_mxu_stream(
        bs.words, classes, n=n, threshold=THR, bs=64, block=16
    )
    rs, th, tl = sweep_mxu_stream(
        bs.words, classes, n=n, threshold=THR, bs=64, block=16,
        max_group=1,
    )
    assert np.array_equal(np.asarray(rs), np.asarray(ref_rs))
    assert np.array_equal(th, ref_th)

    r_rs, r_th, _, r_pairs = sweep_extract_stream(
        bs.words, classes, n=n, threshold=THR, bs=64, block=16
    )
    m_rs, m_th, _, m_pairs = sweep_extract_stream(
        bs.words, classes, n=n, threshold=THR, bs=64, block=16,
        max_group=1,
    )
    assert np.array_equal(np.asarray(m_rs), np.asarray(r_rs))
    assert np.array_equal(m_th, r_th)
    assert np.array_equal(m_pairs, r_pairs)

    g_pairs = extract_pairs_stream_grouped(
        bs.words, classes, ref_th, ref_tl, n=n, threshold=THR,
        bs=64, max_group=1,
    )
    assert np.array_equal(g_pairs, r_pairs)


def test_csr_block_source_matches_packed(problem):
    """Device-materialized blocks (CSRBlockSource) must equal the packed
    matrix's row slices bit for bit, including ragged/padding blocks,
    and the stream engines must produce identical results from either
    block source."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        CSRBlockSource,
        sweep_extract_stream,
        sweep_mxu_stream,
    )

    rng = np.random.default_rng(11)
    n, k = 150, 1200
    rows, cols = np.nonzero(rng.random((n, k)) < 0.06)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=16, word_multiple=128,
    )
    classes = rng.integers(0, 3, n).astype(np.int32)

    src = CSRBlockSource(rows, cols, bs.n_pad, bs.w_pad)
    src.prepare(64, n_pad=192)  # extends past n_pad with zero blocks
    words = np.asarray(bs.words)
    for b in range(3):
        got = np.asarray(src.put(b))
        want = np.zeros((64, bs.w_pad), np.uint32)
        chunk = words[b * 64 : (b + 1) * 64]
        want[: chunk.shape[0]] = chunk
        assert np.array_equal(got, want), b

    ref = sweep_mxu_stream(bs.words, classes, n=n, threshold=THR,
                           bs=64, block=16)
    got = sweep_mxu_stream(None, classes, n=n, threshold=THR,
                           bs=64, block=16, block_source=src)
    assert np.array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    assert np.array_equal(got[1], ref[1])

    r_rs, r_th, _, r_pairs = sweep_extract_stream(
        bs.words, classes, n=n, threshold=THR, bs=64, block=16
    )
    c_rs, c_th, _, c_pairs = sweep_extract_stream(
        None, classes, n=n, threshold=THR, bs=64, block=16,
        block_source=src, max_group=1,
    )
    assert np.array_equal(np.asarray(c_rs), np.asarray(r_rs))
    assert np.array_equal(c_th, r_th)
    assert np.array_equal(c_pairs, r_pairs)

    # capacity-miss redo through the grouped extractor, CSR-sourced
    _, _, _, o_pairs = sweep_extract_stream(
        None, classes, n=n, threshold=THR, bs=64, block=16,
        block_source=src, cap=128,
    )
    assert len(r_pairs) > 128  # the cap genuinely missed
    assert np.array_equal(o_pairs, r_pairs)


def test_stream_scan_dispatch(problem):
    """The scan-chunked CSR dispatch (_stream_scan_chunk) must be
    bit-identical to the per-step loop for every chunk size, group
    size, capacity, and pair format — including chunk-padding tails,
    the in-group moving-block reuse branch, and the overflow redo."""
    from uniprot_kmer_based_clustering_tpu.ops import stream as stream_mod
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        CSRBlockSource,
        sweep_extract_stream,
    )
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        unpack_pairs,
    )

    rng = np.random.default_rng(23)
    n, k = 150, 1200
    rows, cols = np.nonzero(rng.random((n, k)) < 0.06)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=16, word_multiple=128,
    )
    classes = rng.integers(0, 3, n).astype(np.int32)
    src = CSRBlockSource(rows, cols, bs.n_pad, bs.w_pad)

    r_rs, r_th, _, r_pairs = sweep_extract_stream(
        None, classes, n=n, threshold=THR, bs=32, block=16,
        block_source=src, dispatch="steps",
    )
    assert stream_mod.last_onepass_trace["dispatch"] == "steps"

    for chunk, mg in ((1, 1), (3, 2), (8, None), (64, None)):
        s_rs, s_th, _, s_pairs = sweep_extract_stream(
            None, classes, n=n, threshold=THR, bs=32, block=16,
            block_source=src, dispatch="scan", scan_chunk=chunk,
            max_group=mg,
        )
        tr = stream_mod.last_onepass_trace
        assert tr["dispatch"] == "scan"
        assert tr["launches"] <= tr["steps"]
        if chunk >= 8 and mg is None:
            assert tr["launches"] < tr["steps"]
        assert np.array_equal(np.asarray(s_rs), np.asarray(r_rs)), (
            chunk, mg)
        assert np.array_equal(s_th, r_th), (chunk, mg)
        assert np.array_equal(s_pairs, r_pairs), (chunk, mg)

    # capacity miss under scan dispatch: detected exactly, redone
    o_rs, o_th, _, o_pairs = sweep_extract_stream(
        None, classes, n=n, threshold=THR, bs=32, block=16,
        block_source=src, dispatch="scan", cap=8,
    )
    assert stream_mod.last_onepass_trace["overflow"] is True
    assert len(r_pairs) > 8
    assert np.array_equal(o_pairs, r_pairs)

    # packed pair format rides the scan dispatch
    _, _, _, p_pairs = sweep_extract_stream(
        None, classes, n=n, threshold=THR, bs=32, block=16,
        block_source=src, dispatch="scan", pair_format="packed",
    )
    assert p_pairs.ndim == 1
    assert np.array_equal(unpack_pairs(p_pairs), r_pairs)

    # scan without a CSR source is a contract error
    with pytest.raises(ValueError, match="scan"):
        sweep_extract_stream(
            bs.words, classes, n=n, threshold=THR, bs=32, block=16,
            dispatch="scan",
        )


def test_stream_csr_via_config(problem):
    """The config-level stream_source='csr' path: identical result to
    the host-words stream engine, and the validation gates."""
    bs, classes, ref = problem

    class _Idx:  # the three members the csr path consumes
        has_incidences = True

        def __init__(self, words):
            w = np.asarray(words)
            rows, wordcols = np.nonzero(w)
            ranks = []
            prot = []
            for rr, wc in zip(rows, wordcols):
                v = int(w[rr, wc])
                for b in range(32):
                    if v >> b & 1:
                        prot.append(rr)
                        ranks.append(wc * 32 + b)
            self.incidence_protein = np.asarray(prot, np.int32)
            self.incidence_rank = np.asarray(ranks, np.int32)

    got = pairwise_similarity(
        bs, classes,
        PipelineConfig(
            threshold=THR, tile=16, engine="stream",
            extract="onepass", stream_source="csr",
        ),
        index=_Idx(bs.words),
    )
    _check_same(ref, got)
    assert np.array_equal(ref.pairs, got.pairs)

    with pytest.raises(ValueError, match="onepass"):
        PipelineConfig(engine="stream", extract="fused",
                       stream_source="csr")
    with pytest.raises(ValueError, match="incidence"):
        pairwise_similarity(
            bs, classes,
            PipelineConfig(
                threshold=THR, tile=16, 
                engine="stream", stream_source="csr",
            ),
        )


def test_pipeline_packless_csr(tmp_path):
    """engine=stream + stream_source='csr' + components clustering runs
    the whole pipeline WITHOUT ever materializing the dense matrix:
    results equal the host-engine run, and the carried bitset raises
    loudly on any dense-path access."""
    from uniprot_kmer_based_clustering_tpu import cluster_fasta
    from uniprot_kmer_based_clustering_tpu.kmers.bitset import (
        VirtualBitsetMatrix,
    )

    rng = np.random.default_rng(31)
    aas = "CSTAGPDEQNHRKMILVWYF"
    fasta = tmp_path / "toy.fasta"
    with open(fasta, "w") as f:
        base = "".join(aas[i] for i in rng.integers(0, 20, 60))
        for i in range(50):
            seq = list(base)
            for p in rng.integers(0, 60, 6):
                seq[p] = aas[rng.integers(0, 20)]
            f.write(f">P{i}|x|U|class{i % 3}|g\n{''.join(seq)}\n")

    ref = cluster_fasta(
        str(fasta), engine="xla", threshold=3, tile=16, 
        cluster="components",
    )
    got = cluster_fasta(
        str(fasta), engine="stream", stream_source="csr", threshold=3,
        tile=16, cluster="components",
    )
    assert isinstance(got.bitset, VirtualBitsetMatrix)
    assert got.bitset.n_pad == ref.bitset.n_pad
    assert got.bitset.w_pad == ref.bitset.w_pad
    assert np.array_equal(got.pairwise.pairs, ref.pairwise.pairs)
    assert got.parity_report() == ref.parity_report()
    assert np.array_equal(got.cluster_labels, ref.cluster_labels)
    with pytest.raises(RuntimeError, match="never materialized"):
        got.bitset.words.shape
    with pytest.raises(RuntimeError, match="never materialized"):
        got.bitset.device_words()


def test_stream_csr_weighted_matches_host_source(problem):
    """BLOSUM-style weighted sweeps through the CSR block source must
    equal the host-words stream engine exactly (weights scale the
    materialized operand the same way)."""
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        CSRBlockSource,
        sweep_extract_stream,
    )

    rng = np.random.default_rng(41)
    n, k = 150, 1200
    rows, cols = np.nonzero(rng.random((n, k)) < 0.06)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=16, word_multiple=128,
    )
    classes = rng.integers(0, 3, n).astype(np.int32)
    wts = rng.integers(1, 30, size=bs.w_pad * 32).astype(np.int8)

    r_rs, r_th, _, r_pairs = sweep_extract_stream(
        bs.words, classes, n=n, threshold=60, bs=64, block=16,
        weights=wts,
    )
    src = CSRBlockSource(rows, cols, bs.n_pad, bs.w_pad)
    c_rs, c_th, _, c_pairs = sweep_extract_stream(
        None, classes, n=n, threshold=60, bs=64, block=16,
        weights=wts, block_source=src,
    )
    assert np.array_equal(np.asarray(c_rs), np.asarray(r_rs))
    assert np.array_equal(c_th, r_th)
    assert np.array_equal(c_pairs, r_pairs)
    assert len(r_pairs) > 0


def test_stream_checkpoint_kill_resume(problem, tmp_path):
    """Group-boundary checkpointing: kill the one-pass sweep after one
    stationary group (fault-injection seam), resume with the same
    store/key — the resumed run must skip the completed group and the
    final (stats, tile hits, pair list) must be bit-identical to an
    uncheckpointed run. A geometry change must IGNORE the snapshot, and
    a completed run must remove it."""
    import pytest

    from uniprot_kmer_based_clustering_tpu.ops import stream as sm
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        sweep_extract_stream,
    )
    from uniprot_kmer_based_clustering_tpu.utils.checkpoint import (
        CheckpointStore,
    )

    bs, classes, ref = problem
    cls = np.full(bs.n_pad, -1, np.int32)
    cls[: bs.n] = classes
    kw = dict(n=bs.n, threshold=THR, bs=16, block=16, max_group=1)
    rs0, th0, _, pr0 = sweep_extract_stream(bs.words, cls, **kw)

    store = CheckpointStore(str(tmp_path))
    key = "stream-test"
    with pytest.raises(RuntimeError, match="fault injection"):
        sweep_extract_stream(
            bs.words, cls, checkpoint_store=store, checkpoint_key=key,
            fail_after_groups=2, **kw
        )
    snap = store.load(key)
    assert snap is not None and len(snap["groups_done"]) == 2

    rs1, th1, _, pr1 = sweep_extract_stream(
        bs.words, cls, checkpoint_store=store, checkpoint_key=key, **kw
    )
    assert sm.last_onepass_trace["groups_skipped"] == 2
    assert np.array_equal(rs1, rs0)
    assert np.array_equal(th1, th0)
    assert np.array_equal(pr1, pr0)
    assert store.load(key) is None  # completed run removed the snapshot

    # packed pair format through a resume
    with pytest.raises(RuntimeError, match="fault injection"):
        sweep_extract_stream(
            bs.words, cls, checkpoint_store=store, checkpoint_key=key,
            fail_after_groups=1, pair_format="packed", **kw
        )
    _, _, _, pr_p = sweep_extract_stream(
        bs.words, cls, checkpoint_store=store, checkpoint_key=key,
        pair_format="packed", **kw
    )
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        pairs_as_array,
    )

    assert np.array_equal(pairs_as_array(pr_p), pr0)

    # geometry change ignores the stale snapshot (fresh full run)
    with pytest.raises(RuntimeError, match="fault injection"):
        sweep_extract_stream(
            bs.words, cls, checkpoint_store=store, checkpoint_key=key,
            fail_after_groups=1, **kw
        )
    kw2 = dict(kw, bs=32)
    rs2, th2, _, pr2 = sweep_extract_stream(
        bs.words, cls, checkpoint_store=store, checkpoint_key=key, **kw2
    )
    assert "groups_skipped" not in sm.last_onepass_trace
    assert np.array_equal(pr2, pr0)

    # resume works through the CSR block source too (the scale path)
    from uniprot_kmer_based_clustering_tpu.ops.stream import (
        CSRBlockSource,
    )

    rows_np, cols_np = problem_incidence(bs)
    src = CSRBlockSource(rows_np, cols_np, bs.n_pad, bs.w_pad)
    with pytest.raises(RuntimeError, match="fault injection"):
        sweep_extract_stream(
            None, cls, block_source=src, checkpoint_store=store,
            checkpoint_key=key, fail_after_groups=2, **kw
        )
    rs3, th3, _, pr3 = sweep_extract_stream(
        None, cls, block_source=src, checkpoint_store=store,
        checkpoint_key=key, **kw
    )
    assert np.array_equal(pr3, pr0)
    assert np.array_equal(rs3, rs0)


def problem_incidence(bs):
    """(rows, cols) incidence lists recovered from a packed matrix —
    helper for CSR-source tests."""
    words = np.asarray(bs.words)
    rows, wi = np.nonzero(words)
    out_r, out_c = [], []
    for r, w, v in zip(rows, wi, words[rows, wi]):
        for b in range(32):
            if v >> b & 1:
                out_r.append(r)
                out_c.append(w * 32 + b)
    return (np.asarray(out_r, np.int32), np.asarray(out_c, np.int32))
