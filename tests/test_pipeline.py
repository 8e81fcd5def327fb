"""End-to-end pipeline tests on synthetic data + checkpoint/resume."""

import numpy as np
import pytest

from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline

CFG = dict(tile=16, strip=32, engine="xla", threshold=2)


def test_end_to_end_toy(toy_fasta):
    res = run_pipeline(toy_fasta, PipelineConfig(**CFG))
    rep = res.parity_report()
    assert rep["proteins"] == 60
    assert rep["distinct_kmers"] == rep["unique_kmers"] + rep["repeated_kmers"]
    assert rep["pairs_over_threshold"] == res.pairwise.pairs.shape[0]
    assert res.cluster_labels is not None
    # every clustered pair shares a component
    for i, j, _ in res.pairwise.pairs:
        assert res.cluster_labels[i] == res.cluster_labels[j]
    # cluster labels are canonical minima
    summary = res.cluster_summary()
    assert summary["clusters"] >= 1


def test_engines_agree_end_to_end(toy_fasta):
    r_xla = run_pipeline(toy_fasta, PipelineConfig(**CFG))
    r_mxu = run_pipeline(toy_fasta, PipelineConfig(**{**CFG, "engine": "mxu"}))
    assert r_xla.parity_report() == r_mxu.parity_report()
    assert np.array_equal(r_xla.pairwise.pairs, r_mxu.pairwise.pairs)
    # the out-of-core streaming engine is a full pipeline citizen too
    r_str = run_pipeline(
        toy_fasta, PipelineConfig(**{**CFG, "engine": "stream"})
    )
    assert r_xla.parity_report() == r_str.parity_report()
    assert np.array_equal(r_xla.pairwise.pairs, r_str.pairwise.pairs)


def test_checkpoint_resume(toy_fasta, tmp_path):
    cfg = PipelineConfig(**CFG)
    r1 = run_pipeline(toy_fasta, cfg, checkpoint_dir=str(tmp_path))
    files = list(tmp_path.iterdir())
    assert files, "no checkpoints written"
    r2 = run_pipeline(toy_fasta, cfg, checkpoint_dir=str(tmp_path))
    assert r1.parity_report() == r2.parity_report()
    assert np.array_equal(r1.pairwise.pairs, r2.pairwise.pairs)
    # a different config key does not collide
    cfg7 = PipelineConfig(**{**CFG, "k": 7})
    r7 = run_pipeline(toy_fasta, cfg7, checkpoint_dir=str(tmp_path))
    assert r7.index.k == 7
    assert r7.parity_report() != r1.parity_report()


def test_random10_sampling_pipeline(toy_fasta):
    cfg = PipelineConfig(**{**CFG, "sampling": "random10", "seed": 3})
    r = run_pipeline(toy_fasta, cfg)
    full = run_pipeline(toy_fasta, PipelineConfig(**CFG))
    assert r.index.nnz <= full.index.nnz
    # deterministic under the same seed
    r2 = run_pipeline(toy_fasta, cfg)
    assert r.parity_report() == r2.parity_report()


def test_sharded_pipeline_matches(toy_fasta):
    from uniprot_kmer_based_clustering_tpu.parallel import make_mesh

    single = run_pipeline(toy_fasta, PipelineConfig(**CFG))
    mesh = make_mesh(4)
    sharded = run_pipeline(toy_fasta, PipelineConfig(**CFG), mesh=mesh)
    s, m = single.parity_report(), sharded.parity_report()
    assert s == m
    assert np.array_equal(single.pairwise.pairs, sharded.pairwise.pairs)
    # extract='fused' on a flat mesh routes through the fused ring (one
    # pass for stats + pairs) and must stay bit-identical
    fused = run_pipeline(
        toy_fasta, PipelineConfig(**{**CFG, "extract": "fused"}), mesh=mesh
    )
    assert s == fused.parity_report()
    assert np.array_equal(single.pairwise.pairs, fused.pairwise.pairs)


def test_elastic_resume_across_mesh_sizes(toy_fasta, tmp_path):
    """Checkpoints are device-topology-independent (elastic recovery):
    a run checkpointed single-chip resumes on an 8-device mesh — and
    back — with bit-identical results. The reference has no recovery
    story at all (SURVEY.md §5: any panic aborts the 12 h job)."""
    from uniprot_kmer_based_clustering_tpu.parallel import make_mesh

    cfg = PipelineConfig(**CFG)
    r1 = run_pipeline(toy_fasta, cfg, checkpoint_dir=str(tmp_path))
    # resume the same artifacts on a larger topology
    r8 = run_pipeline(
        toy_fasta, cfg, checkpoint_dir=str(tmp_path), mesh=make_mesh(8)
    )
    assert r1.parity_report() == r8.parity_report()
    assert np.array_equal(r1.pairwise.pairs, r8.pairwise.pairs)
    assert np.array_equal(r1.cluster_labels, r8.cluster_labels)
    # and shrink back down
    r2 = run_pipeline(
        toy_fasta, cfg, checkpoint_dir=str(tmp_path), mesh=make_mesh(2)
    )
    assert np.array_equal(r1.pairwise.pairs, r2.pairwise.pairs)


@pytest.mark.golden
def test_golden_full_dataset_7mer(arg_fasta):
    """7-mer config (BASELINE config #2) goldens, derived once from the
    scipy oracle and cross-checked against the device matmul engine."""
    from uniprot_kmer_based_clustering_tpu.io import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers import (
        build_index,
        encode_kmers,
    )

    table = read_fasta(arg_fasta)
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 7)
    idx = build_index(codes, koff, 7)
    assert idx.n_distinct == 731043
    assert idx.n_unique == 442492
    assert idx.n_repeated == 288551
    assert idx.nnz == 2929337

    # pairwise stage goldens (scipy oracle; cross-checked on the device
    # matmul engine): cross-AMR pairs 22,732; Σ shared 7-mers 99,250; pairs
    # sharing > 10 → 463 (max shared 565)
    import scipy.sparse as sp

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
    cross = cls[i[m]] != cls[j[m]]
    vm = v[m][cross]
    assert int(cross.sum()) == 22732
    assert int(vm.sum()) == 99250
    assert int((vm > 10).sum()) == 463
    assert int(vm.max()) == 565


@pytest.mark.golden
def test_golden_full_dataset(arg_fasta):
    """Full-dataset golden parity via the host/scipy path (slow: ~30 s).

    The device engines are checked against the same goldens on the device
    by bench.py; here scipy stands in so the oracle runs on CPU-only CI.
    """
    import scipy.sparse as sp

    from uniprot_kmer_based_clustering_tpu.io import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers import (
        build_index,
        encode_kmers,
    )

    table = read_fasta(arg_fasta)
    codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    idx = build_index(codes, koff, 5)
    assert table.n == 10619
    assert idx.n_distinct == 430853
    assert idx.n_unique == 199600
    assert idx.n_repeated == 231253
    assert idx.nnz == 3189295
    assert idx.multigraph_edge_count() == 258621291

    b = sp.csr_matrix(
        (np.ones(idx.nnz, np.int32),
         (idx.incidence_protein, idx.incidence_rank)),
        shape=(table.n, idx.n_repeated),
    )
    c = (b @ b.T).tocoo()
    i, j, v = c.row, c.col, c.data
    m = i < j
    i, j, v = i[m], j[m], v[m]
    cross = table.amr_class_ids[i] != table.amr_class_ids[j]
    assert int(v[cross].sum()) == 5300233
    assert int(cross.sum()) == 4350628
    assert int((v[cross] > 10).sum()) == 465
    assert int(v[cross].max()) == 567


def test_cluster_fasta_api(toy_fasta):
    """The one-call library entry point."""
    import uniprot_kmer_based_clustering_tpu as ukc

    result = ukc.cluster_fasta(toy_fasta, k=5, threshold=4)
    assert result.pairwise.pairs.shape[1] == 3
    assert result.cluster_labels is not None
    assert result.parity_report()["proteins"] == 60


def test_checkpoint_survives_engine_and_cluster_changes(toy_fasta, tmp_path):
    """Stage artifacts are engine-independent by the framework's core
    invariant — switching engine, devices, or cluster-only knobs must
    resume from (not invalidate) the index/pairs checkpoints."""
    base = PipelineConfig(**CFG)
    k_idx = base.cache_key("index", "f")
    k_pairs = base.cache_key("pairs", "f")
    same = [
        PipelineConfig(**{**CFG, "engine": "mxu"}),
        PipelineConfig(**{**CFG, "cluster": "agglomerative",
                          "min_shared": 5}),
        PipelineConfig(**{**CFG, "tile": 8}),
    ]
    for cfg in same:
        assert cfg.cache_key("index", "f") == k_idx
        assert cfg.cache_key("pairs", "f") == k_pairs
    # semantic knobs DO invalidate
    assert PipelineConfig(**{**CFG, "k": 7}).cache_key("index", "f") != k_idx
    assert (
        PipelineConfig(**{**CFG, "threshold": 9}).cache_key("pairs", "f")
        != k_pairs
    )
    # threshold does not touch the index artifact
    assert (
        PipelineConfig(**{**CFG, "threshold": 9}).cache_key("index", "f")
        == k_idx
    )


def test_checkpoint_resume_skips_sweep(toy_fasta, tmp_path):
    """Resume actually loads the saved pairs artifact: the O(N²) sweep
    stage (the expensive one) does not run again."""
    cfg = PipelineConfig(**CFG)
    r1 = run_pipeline(toy_fasta, cfg, checkpoint_dir=str(tmp_path))
    assert "sweep" in r1.timings
    r2 = run_pipeline(toy_fasta, cfg, checkpoint_dir=str(tmp_path))
    assert "sweep" not in r2.timings, "sweep recomputed despite checkpoint"
    assert r1.parity_report() == r2.parity_report()
    assert np.array_equal(r1.pairwise.pairs, r2.pairwise.pairs)
    assert np.array_equal(r1.cluster_labels, r2.cluster_labels)


def test_query_serving_matches_pipeline(toy_fasta):
    """query_shared_kmers (the serving path: new sequence vs the standing
    corpus index) reproduces the batch sweep's counts exactly for a
    corpus member's own sequence."""
    from uniprot_kmer_based_clustering_tpu.similarity import (
        query_shared_kmers,
    )

    cfg = PipelineConfig(**{**CFG, "cross_amr_only": False})
    res = run_pipeline(toy_fasta, cfg)
    qi = 7
    matches = query_shared_kmers(
        res.index, res.bitset, [res.table.seq(qi)], threshold=cfg.threshold
    )[0]
    got = {int(j): int(c) for j, c in matches}

    # self-match count = the row's repeated-k-mer popcount
    row = np.asarray(res.bitset.words)[qi]
    assert got[qi] == int(np.bitwise_count(row).sum())

    # exact agreement with every batch pair involving qi — and nothing else
    expected = {qi: got[qi]}
    for i, j, c in res.pairwise.pairs:
        if i == qi:
            expected[int(j)] = int(c)
        elif j == qi:
            expected[int(i)] = int(c)
    assert got == expected

    # a never-seen sequence returns no spurious matches above the gate
    novel = query_shared_kmers(
        res.index, res.bitset, ["WWWWWWYYYYYYWWWWWW"], threshold=2
    )[0]
    assert novel.shape == (0, 2)

    # a standing QueryServer reuses its device-resident corpus across
    # calls and reproduces the one-shot result exactly
    from uniprot_kmer_based_clustering_tpu.similarity import QueryServer

    srv = QueryServer(res.index, res.bitset)
    first = srv.query([res.table.seq(qi)], threshold=cfg.threshold)[0]
    again = srv.query([res.table.seq(qi)], threshold=cfg.threshold)[0]
    assert np.array_equal(first, matches)
    assert np.array_equal(again, matches)

    # edge cases: no queries; a query shorter than k (no k-mers at
    # all); unknown characters route through the '*' catch-all rather
    # than crashing (src/protein.rs:49-54 semantics)
    assert srv.query([]) == []
    short = srv.query(["MKT"], threshold=0)[0]
    assert short.shape == (0, 2)
    unk = srv.query(["MK@3xZJMK@3xZJ"], threshold=0)[0]
    assert unk.shape[1] == 2 and unk.dtype == np.int64

    # the host CSR-walk path and the device blocked-matmul path must
    # answer identically (auto picks host on CPU; force both) — in
    # unweighted AND BLOSUM-weighted mode
    from uniprot_kmer_based_clustering_tpu.utils.blosum import (
        rank_weights_int8,
    )

    batch = [res.table.seq(i) for i in (0, qi, 3)] + ["MKT"]
    weights = rank_weights_int8(
        res.index.repeated_codes, cfg.k, res.bitset.w_pad * 32
    )
    for w in (None, weights):
        h = QueryServer(res.index, res.bitset, weights=w, mode="host")
        d = QueryServer(res.index, res.bitset, weights=w, mode="device")
        hq = h.query(batch, threshold=1)
        dq = d.query(batch, threshold=1)
        assert any(m.shape[0] for m in hq)
        for hm, dm in zip(hq, dq):
            assert np.array_equal(hm, dm), (w is None)

    # arbitrary user weights may be NEGATIVE and thresholds below -1 —
    # the top-k epilogue's non-hit sentinel must rank under EVERY real
    # hit (regression: a -1 sentinel outranked hits with counts < -1 and
    # returned sentinel lanes as answers)
    from uniprot_kmer_based_clustering_tpu.kmers import pack_bitsets

    # repack at the default 512-row padding: the toy pipeline's 64-row
    # pad makes the full-counts fetch smaller than any useful top-k
    # fetch, which (correctly) disables the epilogue under test
    bs512 = pack_bitsets(
        res.index.incidence_protein, res.index.incidence_rank,
        res.table.n, res.index.n_repeated,
    )
    rng = np.random.default_rng(0)
    wneg = rng.integers(-5, 6, size=bs512.w_pad * 32).astype(np.int8)
    hn = QueryServer(res.index, bs512, weights=wneg, mode="host")
    hcounts = hn._counts_host(batch)
    t_all = int(hcounts.min()) - 1  # every corpus row is a hit
    assert (hcounts < -1).any(), "weights produced no sub--1 hit counts"
    cap_fit = bs512.n  # nhits == n ≤ cap, and 2·cap+1 < n_pad
    assert 2 * cap_fit + 1 < bs512.n_pad
    dn = QueryServer(
        res.index, bs512, weights=wneg, mode="device",
        topk_cap=cap_fit,
    )
    for hm, dm in zip(
        hn.query(batch, threshold=t_all), dn.query(batch, threshold=t_all)
    ):
        assert np.array_equal(hm, dm)

    # mesh-parallel serving: corpus rows sharded over a mesh (GSPMD
    # partitions the same kernel) must answer exactly like one device
    from uniprot_kmer_based_clustering_tpu.parallel import make_mesh

    one_dev = QueryServer(res.index, res.bitset, mode="device").query(
        batch, threshold=1
    )
    for d in (2, 4):
        if res.bitset.n_pad % d:
            continue
        mq = QueryServer(res.index, res.bitset, mesh=make_mesh(d))
        for mm, dm in zip(mq.query(batch, threshold=1), one_dev):
            assert np.array_equal(mm, dm), d

    # hit-compacted serving epilogue: capacity 1 must detect overflow on
    # any multi-hit query and fall back to the exact full-counts kernel;
    # 0 disables the fast path outright — every capacity answers
    # identically (the default-cap run above already exercised the
    # in-capacity top-k lane ordering against the host lexsort)
    for cap in (0, 1, 512):
        s = QueryServer(
            res.index, res.bitset, mode="device", topk_cap=cap
        )
        for sm, dm in zip(s.query(batch, threshold=1), one_dev):
            assert np.array_equal(sm, dm), cap

    # stream-mode serving (host-resident corpus, row blocks streamed
    # through the device — the beyond-HBM serving path): multiple
    # blocks + a ragged tail + the per-block overflow redo (cap 1),
    # from BOTH block sources (host-words upload and on-device CSR
    # materialization — "auto" resolves to csr here), must all answer
    # exactly like the resident device server
    for src in ("host", "auto", "csr"):
        for sbs, cap in ((16, 512), (16, 1), (res.bitset.n_pad, 2)):
            s = QueryServer(
                res.index, res.bitset, mode="stream", stream_bs=sbs,
                topk_cap=cap, stream_source=src,
            )
            for sm, dm in zip(s.query(batch, threshold=1), one_dev):
                assert np.array_equal(sm, dm), (src, sbs, cap)

    # negative threshold admits count-0 corpus rows — but NEVER the
    # n_pad padding rows; pins the top-k epilogue's col<n mask against
    # the full-counts path's [:, :n] slice
    h_all = QueryServer(res.index, res.bitset, mode="host").query(
        batch, threshold=-1
    )
    d_all = QueryServer(
        res.index, res.bitset, mode="device", topk_cap=res.bitset.n_pad
    ).query(batch, threshold=-1)
    for hm, dm in zip(h_all, d_all):
        assert np.array_equal(hm, dm)
        assert hm.shape[0] == res.table.n

    # self-query oracle: querying EVERY corpus sequence against the
    # index must reproduce the batch sweep's full pair list exactly
    # (both directions) plus each protein's self match
    srv_all = QueryServer(res.index, res.bitset)
    allq = srv_all.query(
        [res.table.seq(i) for i in range(res.table.n)],
        threshold=cfg.threshold,
    )
    got_pairs = set()
    words_np = np.asarray(res.bitset.words)
    for i, m in enumerate(allq):
        self_cnt = int(np.bitwise_count(words_np[i]).sum())
        selfs = {int(j) for j, _ in m if int(j) == i}
        assert selfs == ({i} if self_cnt > cfg.threshold else set()), i
        for j, c in m:
            if j != i:
                a, b = (i, int(j)) if i < j else (int(j), i)
                got_pairs.add((a, b, int(c)))
    want_pairs = {(int(i), int(j), int(c)) for i, j, c in res.pairwise.pairs}
    assert got_pairs == want_pairs


def test_query_pipelined_async_matches_sync(toy_fasta):
    """query_async/query_wait with several batches in flight answers
    exactly like sequential query() on every serving path: the
    hit-compacted fast path, overflow fallback (cap=1), the full-counts
    kernel (cap=0), host mode, and mesh-sharded serving."""
    from uniprot_kmer_based_clustering_tpu.parallel import make_mesh
    from uniprot_kmer_based_clustering_tpu.similarity import QueryServer

    cfg = PipelineConfig(**{**CFG, "cross_amr_only": False})
    res = run_pipeline(toy_fasta, cfg)
    batches = [
        [res.table.seq(i) for i in (0, 3)],
        [res.table.seq(7), "MKT", res.table.seq(1)],
        ["WWWWWWYYYYYYWWWWWW"],
    ]

    servers = [
        QueryServer(res.index, res.bitset, mode="device", topk_cap=cap)
        for cap in (512, 1, 0)
    ] + [QueryServer(res.index, res.bitset, mode="host")]
    if res.bitset.n_pad % 2 == 0:
        servers.append(
            QueryServer(res.index, res.bitset, mesh=make_mesh(2))
        )
    for srv in servers:
        seq_ans = [srv.query(b, threshold=1) for b in batches]
        handles = [srv.query_async(b, threshold=1) for b in batches]
        pipe_ans = [srv.query_wait(h) for h in handles]
        for sa, pa in zip(seq_ans, pipe_ans):
            assert len(sa) == len(pa)
            for sm, pm in zip(sa, pa):
                assert np.array_equal(sm, pm)
        # the `top` truncation applies at wait time
        h = srv.query_async(batches[1], threshold=1)
        for sm, pm in zip(
            srv.query(batches[1], threshold=1, top=2),
            srv.query_wait(h, top=2),
        ):
            assert np.array_equal(sm, pm)
    # empty batch round-trips
    srv = servers[0]
    assert srv.query_wait(srv.query_async([])) == []


def test_query_latency_route(toy_fasta):
    """Small batches route through the host CSR walk when enabled
    (identical answers to the device kernel); batches above the
    break-even and explicit-mode servers keep the device path."""
    from uniprot_kmer_based_clustering_tpu.similarity import QueryServer

    res = run_pipeline(toy_fasta, PipelineConfig(**CFG))
    seqs = [res.table.seq(0)]
    dev = QueryServer(res.index, res.bitset, mode="device")
    routed = QueryServer(
        res.index, res.bitset, mode="device", host_route_max=2
    )
    h = routed.query_async(seqs, threshold=1)
    assert "counts_host" in h  # routed to the CSR walk
    assert np.array_equal(
        routed.query_wait(h)[0], dev.query(seqs, threshold=1)[0]
    )
    batch5 = [res.table.seq(i) for i in range(5)]
    h2 = routed.query_async(batch5, threshold=1)
    assert "counts_host" not in h2  # above break-even: device kernel
    for a, b in zip(
        routed.query_wait(h2), dev.query(batch5, threshold=1)
    ):
        assert np.array_equal(a, b)
    # an explicitly device-mode server never routes by default
    h3 = dev.query_async(seqs, threshold=1)
    assert "counts_host" not in h3
    dev.query_wait(h3)
    # weighted routing agrees too (the CSR walk carries weights)
    from uniprot_kmer_based_clustering_tpu.utils.blosum import (
        rank_weights_int8,
    )

    w = rank_weights_int8(
        res.index.repeated_codes, 5, res.bitset.w_pad * 32
    )
    dw = QueryServer(res.index, res.bitset, weights=w, mode="device")
    rw = QueryServer(
        res.index, res.bitset, weights=w, mode="device",
        host_route_max=1,
    )
    hw = rw.query_async(seqs, threshold=1)
    assert "counts_host" in hw
    assert np.array_equal(
        rw.query_wait(hw)[0], dw.query(seqs, threshold=1)[0]
    )


def test_canonical_lane_sort_contract():
    """The serving top-k epilogue's lane canonicalization: count desc,
    index asc on ties, INT32_MIN sentinels LAST (bitwise-not keys are
    overflow-safe where plain negation is not). Exists because
    lax.top_k's tie order varies with lane width between backends."""
    import jax.numpy as jnp

    from uniprot_kmer_based_clustering_tpu.similarity.query import (
        _canonical_lane_sort,
    )

    sent = np.iinfo(np.int32).min
    vals = jnp.asarray([[5, 7, sent, 7, 5, sent]], jnp.int32)
    idx = jnp.asarray([[9, 4, 0, 2, 3, 1]], jnp.int32)
    v, i = _canonical_lane_sort(vals, idx)
    assert np.array_equal(np.asarray(v)[0], [7, 7, 5, 5, sent, sent])
    assert np.array_equal(np.asarray(i)[0], [2, 4, 3, 9, 0, 1])
