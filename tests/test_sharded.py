"""Ring-rotation sharded sweep: bit-identical to single-chip for any D."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from uniprot_kmer_based_clustering_tpu.kmers.bitset import pack_bitsets
from uniprot_kmer_based_clustering_tpu.ops.popcount import sweep_xla
from uniprot_kmer_based_clustering_tpu.parallel import (
    make_mesh,
    sharded_pairwise_similarity,
)
from uniprot_kmer_based_clustering_tpu.similarity.pairwise import extract_pairs

SUM_LANES = [0, 1, 2, 4, 5, 6]
MAX_LANES = [3, 7]
THR = 4


def _problem(n_pad):
    rng = np.random.default_rng(5)
    n, k = 500, 1500
    rows, cols = np.nonzero(rng.random((n, k)) < 0.04)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=n_pad, word_multiple=128,
    )
    classes = np.full(bs.n_pad, -1, np.int32)
    classes[:n] = rng.integers(0, 4, n)
    return bs, classes, n


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_ring_matches_oracle_even(d):
    bs, classes, n = _problem(1024)
    w = jnp.asarray(bs.words)
    rsx, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)

    mesh = make_mesh(d)
    rs, th, tl = sharded_pairwise_similarity(
        mesh, bs.words, classes, n, THR, block_tile=128
    )
    assert np.array_equal(
        rs[:, SUM_LANES].sum(axis=0), rsx[:, SUM_LANES].sum(axis=0)
    )
    assert np.array_equal(
        rs[:, MAX_LANES].max(axis=0), rsx[:, MAX_LANES].max(axis=0)
    )
    ps = extract_pairs(w, classes, th, tl, n=n, threshold=THR)
    assert np.array_equal(px, ps)


@pytest.mark.parametrize("d", [3, 5, 7])
def test_ring_matches_oracle_odd(d):
    n_pad = d * 128 * 2
    bs, classes, n = _problem(n_pad)
    w = jnp.asarray(bs.words)
    rsx, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)

    mesh = make_mesh(d)
    rs, th, tl = sharded_pairwise_similarity(
        mesh, bs.words, classes, n, THR, block_tile=128
    )
    assert np.array_equal(
        rs[:, SUM_LANES].sum(axis=0), rsx[:, SUM_LANES].sum(axis=0)
    )
    ps = extract_pairs(w, classes, th, tl, n=n, threshold=THR)
    assert np.array_equal(px, ps)


def test_doc_freq_psum_matches_host():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from uniprot_kmer_based_clustering_tpu.kmers.encode import (
        encode_kmers_device,
    )
    from uniprot_kmer_based_clustering_tpu.parallel import doc_freq_psum

    rng = np.random.default_rng(9)
    n_prot, lmax = 32, 40
    seqs = rng.integers(0, 21, (n_prot, lmax)).astype(np.int32)
    lengths = rng.integers(10, lmax + 1, n_prot).astype(np.int32)

    mesh = make_mesh(8)
    codes, valid = encode_kmers_device(
        jnp.asarray(seqs), jnp.asarray(lengths), 5
    )
    codes = jax.device_put(codes, NamedSharding(mesh, P("p", None)))
    valid = jax.device_put(valid, NamedSharding(mesh, P("p", None)))
    freq = np.asarray(doc_freq_psum(mesh, codes, valid, 5))

    # host oracle
    expect = {}
    for i in range(n_prot):
        ks = set()
        for p in range(int(lengths[i]) - 4):
            code = 0
            for j in range(5):
                code = code * 21 + int(seqs[i, p + j])
            ks.add(code)
        for c in ks:
            expect[c] = expect.get(c, 0) + 1
    got = {int(c): int(freq[c]) for c in np.nonzero(freq)[0]}
    assert got == expect


def test_ring_weighted_matches_mxu():
    """BLOSUM-weighted ring sweep == single-chip weighted matmul sweep."""
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import sweep_mxu

    bs, classes, n = _problem(1024)
    rng = np.random.default_rng(17)
    wts = rng.integers(1, 50, size=bs.w_pad * 32).astype(np.int8)
    w = jnp.asarray(bs.words)
    rs_ref, th_ref, tiles_ref = sweep_mxu(
        w, jnp.asarray(classes), n, 40, weights=wts,
        strip=bs.n_pad, block=128,
    )

    SUM = [0, 1, 2, 4, 5, 6]
    MAX = [3, 7]
    for d in (1, 4):
        mesh = make_mesh(d)
        rs, th, tl = sharded_pairwise_similarity(
            mesh, bs.words, classes, n, 40, block_tile=128, weights=wts
        )
        assert np.array_equal(rs[:, SUM].sum(axis=0), rs_ref[:, SUM].sum(axis=0)), d
        assert np.array_equal(rs[:, MAX].max(axis=0), rs_ref[:, MAX].max(axis=0)), d
        ps = extract_pairs(w, classes, th, tl, n=n, threshold=40, weights=jnp.asarray(wts))
        px = extract_pairs(w, classes, th_ref, tiles_ref, n=n, threshold=40, weights=jnp.asarray(wts))
        assert np.array_equal(px, ps), d


@pytest.mark.parametrize("hc,cc", [(1, 8), (2, 4), (4, 2), (8, 1), (2, 2), (2, 3), (3, 2)])
def test_ring_2d_matches_oracle(hc, cc):
    """Hierarchical (hosts × chips) ring == single-chip sweep, any H × C."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        make_mesh_2d,
        sharded_pairwise_similarity_2d,
    )

    d = hc * cc
    n_pad = 128 * d * (2 if d <= 4 else 1)
    bs, classes, n = _problem(n_pad)
    w = jnp.asarray(bs.words)
    rsx, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)

    mesh = make_mesh_2d(hc, cc)
    rs, th, tl = sharded_pairwise_similarity_2d(
        mesh, bs.words, classes, n, THR, block_tile=128
    )
    assert np.array_equal(
        rs[:, SUM_LANES].sum(axis=0), rsx[:, SUM_LANES].sum(axis=0)
    )
    assert np.array_equal(
        rs[:, MAX_LANES].max(axis=0), rsx[:, MAX_LANES].max(axis=0)
    )
    ps = extract_pairs(w, classes, th, tl, n=n, threshold=THR)
    assert np.array_equal(px, ps)


def test_ring_2d_weighted_matches_mxu():
    """BLOSUM-weighted 2-D ring == single-chip weighted matmul sweep."""
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import sweep_mxu
    from uniprot_kmer_based_clustering_tpu.parallel import (
        make_mesh_2d,
        sharded_pairwise_similarity_2d,
    )

    bs, classes, n = _problem(1024)
    rng = np.random.default_rng(17)
    wts = rng.integers(1, 50, size=bs.w_pad * 32).astype(np.int8)
    w = jnp.asarray(bs.words)
    rs_ref, th_ref, tiles_ref = sweep_mxu(
        w, jnp.asarray(classes), n, 40, weights=wts,
        strip=bs.n_pad, block=128,
    )
    mesh = make_mesh_2d(2, 4)
    rs, th, tl = sharded_pairwise_similarity_2d(
        mesh, bs.words, classes, n, 40, block_tile=128, weights=wts
    )
    assert np.array_equal(rs[:, SUM_LANES].sum(axis=0), rs_ref[:, SUM_LANES].sum(axis=0))
    assert np.array_equal(rs[:, MAX_LANES].max(axis=0), rs_ref[:, MAX_LANES].max(axis=0))
    ps = extract_pairs(w, classes, th, tl, n=n, threshold=40, weights=jnp.asarray(wts))
    px = extract_pairs(w, classes, th_ref, tiles_ref, n=n, threshold=40, weights=jnp.asarray(wts))
    assert np.array_equal(px, ps)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_kaxis_matches_oracle(d):
    """Contraction-axis (k-mer) sharded sweep == single-chip sweep."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        sharded_pairwise_similarity_kaxis,
    )

    bs, classes, n = _problem(640)
    assert bs.w_pad % d == 0
    w = jnp.asarray(bs.words)
    rsx, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)

    mesh = make_mesh(d, axis="k")
    rs, th, tl = sharded_pairwise_similarity_kaxis(
        mesh, bs.words, classes, n, THR, block_tile=128
    )
    assert np.array_equal(
        rs[:, SUM_LANES].sum(axis=0), rsx[:, SUM_LANES].sum(axis=0)
    )
    assert np.array_equal(
        rs[:, MAX_LANES].max(axis=0), rsx[:, MAX_LANES].max(axis=0)
    )
    ps = extract_pairs(w, classes, th, tl, n=n, threshold=THR)
    assert np.array_equal(px, ps)


def test_kaxis_weighted_matches_mxu():
    """BLOSUM-weighted K-axis sweep == single-chip weighted matmul sweep."""
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import sweep_mxu
    from uniprot_kmer_based_clustering_tpu.parallel import (
        sharded_pairwise_similarity_kaxis,
    )

    bs, classes, n = _problem(640)
    rng = np.random.default_rng(17)
    wts = rng.integers(1, 50, size=bs.w_pad * 32).astype(np.int8)
    w = jnp.asarray(bs.words)
    rs_ref, th_ref, tiles_ref = sweep_mxu(
        w, jnp.asarray(classes), n, 40, weights=wts,
        strip=bs.n_pad, block=128,
    )
    mesh = make_mesh(4, axis="k")
    rs, th, tl = sharded_pairwise_similarity_kaxis(
        mesh, bs.words, classes, n, 40, block_tile=128, weights=wts
    )
    assert np.array_equal(rs[:, SUM_LANES].sum(axis=0), rs_ref[:, SUM_LANES].sum(axis=0))
    assert np.array_equal(rs[:, MAX_LANES].max(axis=0), rs_ref[:, MAX_LANES].max(axis=0))
    ps = extract_pairs(w, classes, th, tl, n=n, threshold=40, weights=jnp.asarray(wts))
    px = extract_pairs(w, classes, th_ref, tiles_ref, n=n, threshold=40, weights=jnp.asarray(wts))
    assert np.array_equal(px, ps)


@pytest.mark.parametrize("layout", ["ring1", "ring4", "ring2x4"])
def test_ring_epilogue_parity(layout):
    """The two XLA statistics epilogues of the ring sweeps — the flat
    mask/reduce chain ("xla") and the tiled reduce behind an
    optimization barrier ("xla_tiled_barrier", the "auto" default) —
    are bit-identical on the flat ring (D=1, 4) and the 2-D ring."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        make_mesh_2d,
        sharded_pairwise_similarity_2d,
    )

    bs, classes, n = _problem(1024)
    if layout == "ring2x4":
        mesh, fn = make_mesh_2d(2, 4), sharded_pairwise_similarity_2d
    else:
        mesh, fn = make_mesh(int(layout[4:])), sharded_pairwise_similarity
    rs_x, th_x, _ = fn(
        mesh, bs.words, classes, n, THR, block_tile=128, stats_engine="xla"
    )
    rs_t, th_t, _ = fn(
        mesh, bs.words, classes, n, THR, block_tile=128,
        stats_engine="xla_tiled_barrier",
    )
    assert np.array_equal(rs_t, rs_x)
    assert np.array_equal(th_t, th_x)
    assert th_x[:, 0].sum() > 0  # the gate is not vacuous


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_sharded_extraction_matches_single_chip(d):
    """Ring extraction (no full-matrix replication) == extract_pairs,
    for every device count."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        sharded_extract_pairs,
    )

    bs, classes, n = _problem(1024)
    w = jnp.asarray(bs.words)
    _, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)

    mesh = make_mesh(d)
    ps = sharded_extract_pairs(
        mesh, bs.words, classes, n, THR, block_tile=128
    )
    assert np.array_equal(px, ps)


def test_sharded_extraction_all_pairs_and_weighted():
    from uniprot_kmer_based_clustering_tpu.parallel import (
        sharded_extract_pairs,
    )

    bs, classes, n = _problem(1024)
    w = jnp.asarray(bs.words)
    mesh = make_mesh(4)

    # all-pairs (same-class kept)
    _, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(
        w, classes, thx, tx, n=n, threshold=THR, cross_amr_only=False
    )
    ps = sharded_extract_pairs(
        mesh, bs.words, classes, n, THR, block_tile=128,
        cross_amr_only=False,
    )
    assert np.array_equal(px, ps)

    # weighted scores
    rng = np.random.default_rng(9)
    wts = rng.integers(1, 30, bs.w_pad * 32).astype(np.int8)
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import sweep_mxu

    rsm, thm, tm = sweep_mxu(
        w, jnp.asarray(classes), n, 40, strip=128, block=128, weights=wts
    )
    pxw = extract_pairs(w, classes, thm, tm, n=n, threshold=40, weights=wts)
    psw = sharded_extract_pairs(
        mesh, bs.words, classes, n, 40, block_tile=128, weights=wts
    )
    assert np.array_equal(pxw, psw)


def test_sharded_extraction_overflow_raises():
    from uniprot_kmer_based_clustering_tpu.parallel import (
        sharded_extract_pairs,
    )

    bs, classes, n = _problem(1024)
    mesh = make_mesh(2)
    with pytest.raises(ValueError, match="overflow"):
        sharded_extract_pairs(
            mesh, bs.words, classes, n, 0, block_tile=128, cap=64
        )


@pytest.mark.parametrize("hc,cc", [(2, 2), (2, 4), (4, 2), (3, 2), (2, 3)])
def test_sharded_extraction_2d_matches(hc, cc):
    """Hierarchical 2-D ring extraction == single-chip, any H×C shape."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        make_mesh_2d,
        sharded_extract_pairs,
    )

    if hc * cc > len(jax.devices()):
        pytest.skip("not enough virtual devices")
    bs, classes, n = _problem(hc * cc * 128)
    w = jnp.asarray(bs.words)
    _, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)

    ps = sharded_extract_pairs(
        make_mesh_2d(hc, cc), bs.words, classes, n, THR, block_tile=128
    )
    assert np.array_equal(px, ps)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_extraction_kaxis_matches(d):
    """Contraction-axis extraction (column-sharded bitset, replicated
    compaction) == single-chip, including weighted."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        sharded_extract_pairs,
    )

    bs, classes, n = _problem(1024)
    w = jnp.asarray(bs.words)
    _, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)

    mesh = make_mesh(d, axis="k")
    ps = sharded_extract_pairs(
        mesh, bs.words, classes, n, THR, block_tile=128
    )
    assert np.array_equal(px, ps)


@pytest.mark.parametrize("d", [1, 4])
def test_sharded_extraction_topk_path_matches(d):
    """The per-sub-tile top_k compaction (used when tile_cap is passed)
    == the scatter path == single-chip."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        sharded_extract_pairs,
    )

    bs, classes, n = _problem(1024)
    w = jnp.asarray(bs.words)
    _, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)
    tile_cap = int(thx[:, 0].max())

    mesh = make_mesh(d)
    ps = sharded_extract_pairs(
        mesh, bs.words, classes, n, THR, block_tile=128, tile_cap=tile_cap
    )
    assert np.array_equal(px, ps)

    # and on the k-axis layout
    ps_k = sharded_extract_pairs(
        make_mesh(max(d, 2), axis="k"), bs.words, classes, n, THR,
        block_tile=128, tile_cap=tile_cap,
    )
    assert np.array_equal(px, ps_k)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("k", [0, 512])
def test_fused_ring_matches_single_chip(d, k):
    """The fused ring (stats + in-pass compaction, ONE pass over the
    block pairs) == the separate sweep + extraction, for every device
    count, on both compaction paths (k=0 scatter, k>0 per-sub-tile
    top_k). Capacities are generous here — no fallback triggers, so
    this pins the pure fused path."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        sharded_pairwise_fused,
    )

    n_pad = 1024 if d != 3 else 3 * 128 * 2
    bs, classes, n = _problem(n_pad)
    w = jnp.asarray(bs.words)
    rsx, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)

    mesh = make_mesh(d)
    rs, th, tl, ps = sharded_pairwise_fused(
        mesh, bs.words, classes, n, THR, block_tile=128, k=k,
    )
    assert np.array_equal(
        rs[:, SUM_LANES].sum(axis=0), rsx[:, SUM_LANES].sum(axis=0)
    )
    assert np.array_equal(
        rs[:, MAX_LANES].max(axis=0), rsx[:, MAX_LANES].max(axis=0)
    )
    assert np.array_equal(th[:, 0], thx[:, 0])
    assert np.array_equal(px, ps)
    assert len(ps) > 0


def test_fused_ring_fallback_regimes_stay_exact():
    """When the capacity guesses miss — a sub-tile over k survivors, or
    more than cap total — the fused wrapper must fall back to the
    two-pass extraction and stay bit-identical (stats are valid either
    way)."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        sharded_pairwise_fused,
    )

    bs, classes, n = _problem(1024)
    w = jnp.asarray(bs.words)
    rsx, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)
    mesh = make_mesh(4)

    # k far below the densest tile: sub-tiles get dropped in-pass
    assert int(thx[:, 0].max()) > 4
    rs, th, tl, ps = sharded_pairwise_fused(
        mesh, bs.words, classes, n, THR, block_tile=128, k=4,
    )
    assert np.array_equal(px, ps)
    assert np.array_equal(
        rs[:, SUM_LANES].sum(axis=0), rsx[:, SUM_LANES].sum(axis=0)
    )

    # cap below the survivor total: the gather overflows
    assert len(px) > 64
    _, _, _, ps2 = sharded_pairwise_fused(
        mesh, bs.words, classes, n, THR, block_tile=128, k=0, cap=64,
    )
    assert np.array_equal(px, ps2)


def test_fused_ring_weighted_and_all_pairs():
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import sweep_mxu
    from uniprot_kmer_based_clustering_tpu.parallel import (
        sharded_pairwise_fused,
    )

    bs, classes, n = _problem(1024)
    w = jnp.asarray(bs.words)
    mesh = make_mesh(4)

    # all-pairs (same-class kept)
    _, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(
        w, classes, thx, tx, n=n, threshold=THR, cross_amr_only=False
    )
    _, _, _, ps = sharded_pairwise_fused(
        mesh, bs.words, classes, n, THR, block_tile=128,
        cross_amr_only=False, k=512,
    )
    assert np.array_equal(px, ps)

    # weighted scores
    rng = np.random.default_rng(9)
    wts = rng.integers(1, 30, bs.w_pad * 32).astype(np.int8)
    rsm, thm, tm = sweep_mxu(
        w, jnp.asarray(classes), n, 40, strip=128, block=128, weights=wts
    )
    pxw = extract_pairs(w, classes, thm, tm, n=n, threshold=40, weights=wts)
    _, _, _, psw = sharded_pairwise_fused(
        mesh, bs.words, classes, n, 40, block_tile=128, weights=wts, k=512,
    )
    assert np.array_equal(pxw, psw)


@pytest.mark.parametrize("hc,cc", [(2, 2), (2, 4), (3, 2), (2, 3)])
def test_fused_ring_2d_matches_single_chip(hc, cc):
    """The fused hierarchical 2-D ring == single-chip sweep + extraction
    for any H×C shape."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        make_mesh_2d,
        sharded_pairwise_fused,
    )

    if hc * cc > len(jax.devices()):
        pytest.skip("not enough virtual devices")
    bs, classes, n = _problem(hc * cc * 128)
    w = jnp.asarray(bs.words)
    rsx, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)

    rs, th, _, ps = sharded_pairwise_fused(
        make_mesh_2d(hc, cc), bs.words, classes, n, THR,
        block_tile=128, k=512,
    )
    assert np.array_equal(
        rs[:, SUM_LANES].sum(axis=0), rsx[:, SUM_LANES].sum(axis=0)
    )
    assert np.array_equal(th[:, 0], thx[:, 0])
    assert np.array_equal(px, ps)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("k", [0, 512])
def test_fused_kaxis_matches_single_chip(d, k):
    """The fused contraction-axis sweep (one psum per row block for both
    stats and survivors) == single-chip, both compaction paths."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        sharded_pairwise_fused,
    )

    bs, classes, n = _problem(1024)
    w = jnp.asarray(bs.words)
    rsx, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)

    mesh = make_mesh(d, axis="k")
    rs, th, _, ps = sharded_pairwise_fused(
        mesh, bs.words, classes, n, THR, block_tile=128, k=k,
    )
    assert np.array_equal(
        rs[:, SUM_LANES].sum(axis=0), rsx[:, SUM_LANES].sum(axis=0)
    )
    assert np.array_equal(
        rs[:, MAX_LANES].max(axis=0), rsx[:, MAX_LANES].max(axis=0)
    )
    assert np.array_equal(th[:, 0], thx[:, 0])
    assert np.array_equal(px, ps)


def test_fused_2d_and_kaxis_fallback_stay_exact():
    """Capacity misses on the 2-D and k-axis fused layouts fall back to
    two-pass extraction and stay bit-identical."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        make_mesh_2d,
        sharded_pairwise_fused,
    )

    bs, classes, n = _problem(1024)
    w = jnp.asarray(bs.words)
    _, thx, tx = sweep_xla(w, jnp.asarray(classes), n, THR, tile=128)
    px = extract_pairs(w, classes, thx, tx, n=n, threshold=THR)
    assert int(thx[:, 0].max()) > 4

    _, _, _, ps = sharded_pairwise_fused(
        make_mesh_2d(2, 4), bs.words, classes, n, THR, block_tile=128, k=4,
    )
    assert np.array_equal(px, ps)
    _, _, _, ps_k = sharded_pairwise_fused(
        make_mesh(4, axis="k"), bs.words, classes, n, THR,
        block_tile=128, k=0, cap=64,
    )
    assert np.array_equal(px, ps_k)


def test_stage_mesh_inputs_pass_through_all_layouts():
    """stage_mesh_inputs stages once; the wrappers' internal device_put
    must pass the committed arrays through unchanged (no re-upload) and
    produce bit-identical results to raw numpy inputs on every layout.
    The no-op property is what makes the pipeline's one-time staging
    worth anything: jax.device_put with an identical NamedSharding must
    return the same committed buffers."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        make_mesh,
        make_mesh_2d,
        sharded_extract_pairs,
        sharded_pairwise_similarity,
        sharded_pairwise_similarity_2d,
        sharded_pairwise_similarity_kaxis,
    )
    from uniprot_kmer_based_clustering_tpu.parallel.sharded import (
        stage_mesh_inputs,
    )

    bs, classes, n = _problem(1024)
    layouts = [
        (make_mesh(4), sharded_pairwise_similarity),
        (make_mesh_2d(2, 2), sharded_pairwise_similarity_2d),
        (make_mesh(4, axis="k"), sharded_pairwise_similarity_kaxis),
    ]
    for mesh, sweep in layouts:
        rs_np, th_np, tl_np = sweep(
            mesh, bs.words, classes, n, THR, block_tile=128
        )
        words_s, classes_s = stage_mesh_inputs(mesh, bs.words, classes)
        # the staged arrays already carry the wrapper's sharding — a
        # second device_put must be the no-op fast path
        assert (
            jax.device_put(words_s, words_s.sharding) is words_s
        ), "device_put with identical sharding should pass through"
        rs_s, th_s, tl_s = sweep(
            mesh, words_s, classes_s, n, THR, block_tile=128
        )
        assert np.array_equal(rs_np, rs_s)
        assert np.array_equal(th_np, th_s)
        p_np = sharded_extract_pairs(
            mesh, bs.words, classes, n, THR, block_tile=128
        )
        p_s = sharded_extract_pairs(
            mesh, words_s, classes_s, n, THR, block_tile=128
        )
        assert np.array_equal(p_np, p_s)


def test_stage_mesh_inputs_csr_matches_packed():
    """CSR mesh staging (dense shards materialized ON DEVICE from the
    sparse incidences — no dense host staging) must equal pack_bitsets'
    matrix bit for bit, and the ring sweep over it must match the
    host-staged sweep exactly."""
    from uniprot_kmer_based_clustering_tpu.parallel import (
        make_mesh,
        stage_mesh_inputs_csr,
    )

    rng = np.random.default_rng(23)
    n, k = 500, 1500
    rows, cols = np.nonzero(rng.random((n, k)) < 0.04)
    bs = pack_bitsets(
        rows.astype(np.int32), cols.astype(np.int32), n, k,
        row_multiple=1024, word_multiple=128,
    )
    classes = np.full(bs.n_pad, -1, np.int32)
    classes[:n] = rng.integers(0, 4, n)

    mesh = make_mesh(4)
    words_s, classes_s = stage_mesh_inputs_csr(
        mesh, rows, cols, bs.n_pad, bs.w_pad, classes
    )
    assert np.array_equal(np.asarray(words_s), np.asarray(bs.words))
    assert np.array_equal(np.asarray(classes_s), classes)

    rs_ref, th_ref, _ = sharded_pairwise_similarity(
        mesh, bs.words, classes, n, THR, block_tile=128
    )
    rs, th, _ = sharded_pairwise_similarity(
        mesh, words_s, classes_s, n, THR, block_tile=128
    )
    assert np.array_equal(th, th_ref)
    assert np.array_equal(
        rs[:, SUM_LANES].sum(axis=0), rs_ref[:, SUM_LANES].sum(axis=0)
    )


def test_pipeline_mesh_csr_packless(tmp_path):
    """run_pipeline(mesh=...) with stream_source='csr': the dense
    matrix is never built on host, and results equal the dense-staged
    mesh run on every layout — the flat mesh routes to the sharded
    OUT-OF-CORE stream composition (parallel/stream_mesh.py), the 2-D
    ring and the k-axis layouts to packless in-core staging (row shards
    resp. column-range shards materialized on device)."""
    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.kmers.bitset import (
        VirtualBitsetMatrix,
    )
    from uniprot_kmer_based_clustering_tpu.parallel import (
        make_mesh,
        make_mesh_2d,
    )
    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline

    rng = np.random.default_rng(37)
    aas = "CSTAGPDEQNHRKMILVWYF"
    fasta = tmp_path / "toy.fasta"
    with open(fasta, "w") as f:
        base = "".join(aas[i] for i in rng.integers(0, 20, 60))
        for i in range(50):
            seq = list(base)
            for p in rng.integers(0, 60, 6):
                seq[p] = aas[rng.integers(0, 20)]
            f.write(f">P{i}|x|U|class{i % 3}|g\n{''.join(seq)}\n")

    base_cfg = dict(threshold=3, tile=16, 
                    cluster="components")
    ref = run_pipeline(
        str(fasta), PipelineConfig(**base_cfg), mesh=make_mesh(4)
    )
    for mesh in (make_mesh(4), make_mesh_2d(2, 2), make_mesh(4, axis="k")):
        got = run_pipeline(
            str(fasta),
            PipelineConfig(engine="stream", stream_source="csr",
                           **base_cfg),
            mesh=mesh,
        )
        assert isinstance(got.bitset, VirtualBitsetMatrix)
        assert np.array_equal(got.pairwise.pairs, ref.pairwise.pairs)
        assert got.parity_report() == ref.parity_report()
        assert np.array_equal(got.cluster_labels, ref.cluster_labels)
