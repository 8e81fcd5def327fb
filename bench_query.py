"""Serving benchmark: shared-k-mer queries/s against a standing corpus.

The reference has no serving story (its only mode is one batch run);
QueryServer is the framework's production-serving surface: the packed
corpus bitset stays device-resident and each request answers with
blocked int8 matmuls (similarity/query.py). This bench measures, on one
GPU, against the corpus of bench.py (the bundled 10,619-protein dataset
when the checkout has it, else the synthetic corpus written from a seed;
UKC_QUERY_N=<n> switches to bench_scale's synthetic set of n proteins):

  * a batch-size saturation CURVE (1 / 16 / 64 / 256 queries per
    request, synchronous dispatch),
  * single-query latency (batch 1, includes host k-mer encoding +
    packing + the device matmul + the device→host round trip),
  * PIPELINED throughput: several batches in flight via
    query_async/query_wait, hiding the per-batch round trip behind
    device compute — the sustained-qps ceiling,

gated on EXACT agreement with the host rank-CSR server (an independent
structure — the Gustavson walk — over the same index) for every
measured query, plus a self-query spot-check against the golden pair
list's counts.

Prints ONE JSON line; mirrors to BENCH_query_r{NN}.json when
UKC_BENCH_ROUND is set. A run that finds no GPU fails.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))


def _fail(msg: str) -> None:
    print(json.dumps({
        "metric": "query_serving",
        "value": 0.0,
        "unit": "queries/s",
        "error": msg,
    }))


class _SynthTable:
    """Minimal ProteinTable shim over a synthetic corpus buffer (only
    the two members the bench touches)."""

    def __init__(self, seq_buf, offsets):
        self.seq_buf, self.offsets = seq_buf, offsets
        self.n = len(offsets) - 1

    def seq(self, i: int) -> str:
        return (
            self.seq_buf[self.offsets[i] : self.offsets[i + 1]]
            .tobytes().decode("ascii")
        )


def _build_servers(fasta: str):
    """Corpus index + (device, host) servers.

    UKC_QUERY_N switches the corpus to bench_scale's template-mutation
    synthetic set — the serving-AT-SCALE configuration (e.g. 30k
    proteins, ~0.5M-rank index): same build, same host-exactness gate,
    artifact lands as BENCH_queryscale_r{NN}.json."""
    from uniprot_kmer_based_clustering_tpu.io import read_fasta
    from uniprot_kmer_based_clustering_tpu.kmers import (
        build_index,
        encode_kmers,
        pack_bitsets,
    )
    from uniprot_kmer_based_clustering_tpu.similarity import QueryServer

    qn = int(os.environ.get("UKC_QUERY_N", "0"))
    if qn:
        from bench_scale import synth_proteins

        seq_buf, offsets, _classes = synth_proteins(qn)
        table = _SynthTable(seq_buf, offsets)
        codes, koff = encode_kmers(seq_buf, offsets, 5)
    else:
        table = read_fasta(fasta)
        codes, koff = encode_kmers(table.seq_buf, table.offsets, 5)
    idx = build_index(codes, koff, 5)
    bitset = pack_bitsets(
        idx.incidence_protein,
        idx.incidence_rank,
        table.n,
        idx.n_repeated,
        row_multiple=512,
    )
    # UKC_QUERY_TOPK: serving hit-lane capacity override — dense
    # template corpora at 100k scale average ~hundreds of over-gate
    # matches per query, so the default 512 would route most queries
    # through the full-counts overflow redo (exact but a [Q, N] fetch)
    cap = int(os.environ.get("UKC_QUERY_TOPK", "512"))
    srv = QueryServer(idx, bitset, mode="device", topk_cap=cap)
    host = QueryServer(idx, bitset, mode="host")
    return table, bitset, srv, host


def main():
    sys.path.insert(0, _ROOT)
    import bench

    from uniprot_kmer_based_clustering_tpu.utils.accel import (
        card_line,
        enable_persistent_cache,
        require_accelerator,
    )

    require_accelerator()
    enable_persistent_cache()
    with tempfile.TemporaryDirectory(prefix="ukc_query_") as tmp:
        _run(card_line(), bench.corpus_path(tmp))


def _run(card, fasta):
    import jax

    table, bitset, srv, host = _build_servers(fasta)

    # 256 corpus members spread across the file — every answer checked
    # exactly against the independent host CSR walk
    qis = list(range(0, table.n, max(1, table.n // 256)))[:256]
    seqs = [table.seq(i) for i in qis]
    got = srv.query(seqs, threshold=10)
    want = host.query(seqs, threshold=10)
    for qi, g, w in zip(qis, got, want):
        if not np.array_equal(g, w):
            _fail(f"device/host mismatch on corpus query {qi}")
            return

    # golden spot-check: protein 0's self count equals its repeated-k-mer
    # popcount (the serving path reproduces src/graph/mod.rs's alignment
    # gate per row)
    row0 = np.bitwise_count(np.asarray(bitset.words)[qis[0]]).sum()
    self_hit = [c for j, c in got[0] if j == qis[0]]
    if not self_hit or int(self_hit[0]) != int(row0):
        _fail(
            f"self-count mismatch: {self_hit} != {int(row0)} "
            f"for corpus protein {qis[0]}"
        )
        return

    def steady(batch_seqs, reps):
        # two fetch-synced warmups (each query() call ends in a real
        # np.asarray fetch), then best-of-reps
        srv.query(batch_seqs, threshold=10)
        srv.query(batch_seqs, threshold=10)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            srv.query(batch_seqs, threshold=10)
            best = min(best, time.perf_counter() - t0)
        return best

    # batch-size saturation curve (synchronous dispatch). Throughput
    # uses the ACTUAL batch length — seqs[:b] can be shorter than b on
    # small corpora (fewer probe rows than the largest batch size).
    curve = {}
    for b in (1, 16, 64, 256):
        batch = seqs[:b]
        t = steady(batch, reps=4)
        curve[str(b)] = {
            "batch_seconds": round(t, 4),
            "queries_per_s": round(len(batch) / t, 1),
        }
    t1 = curve["1"]["batch_seconds"]
    t64 = curve["64"]["batch_seconds"]

    # pipelined dispatch: DEPTH batches in flight — the device executes
    # batch k+1 while batch k's answer is fetched/post-processed. Parity
    # of every pipelined answer vs the synchronous path is asserted.
    pipeline = {}
    best_qps = max(v["queries_per_s"] for v in curve.values())
    for b, depth in ((64, 8), (256, 4)):
        batch = seqs[:b]
        sync_ans = srv.query(batch, threshold=10)
        # warm the async path once (same compiled kernels, new code path)
        srv.query_wait(srv.query_async(batch, threshold=10))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            handles = [
                srv.query_async(batch, threshold=10) for _ in range(depth)
            ]
            answers = [srv.query_wait(h) for h in handles]
            best = min(best, time.perf_counter() - t0)
        for ans in answers:
            for am, sm in zip(ans, sync_ans):
                if not np.array_equal(am, sm):
                    _fail(f"pipelined/sync mismatch at batch {b}")
                    return
        qps = depth * len(batch) / best
        pipeline[f"{b}x{depth}"] = {
            "batch": len(batch),
            "depth": depth,
            "total_seconds": round(best, 4),
            "queries_per_s": round(qps, 1),
        }
        best_qps = max(best_qps, qps)

    # LATENCY routing (single queries): auto-mode servers route
    # batches ≤ 4 to the host CSR walk (similarity/query.py
    # host_route_max). Measure both paths'
    # batch-1 latency, derive the measured break-even from the device
    # curve, and assert the routed answers are identical.
    one = seqs[:1]
    host.query(one, threshold=10)  # CSR warm (lazy structures built)
    t_host1 = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        host_one = host.query(one, threshold=10)
        t_host1 = min(t_host1, time.perf_counter() - t0)
    srv.set_host_route_max(4)
    try:
        h_r = srv.query_async(one, threshold=10)
        if "counts_host" not in h_r:
            _fail("latency route did not engage at batch 1")
            return
        routed_one = srv.query_wait(h_r)
        if not np.array_equal(routed_one[0], host_one[0]) or (
            not np.array_equal(routed_one[0], got[0])
        ):
            _fail("latency-routed answer != device/host answer")
            return
        t_routed = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            srv.query(one, threshold=10)
            t_routed = min(t_routed, time.perf_counter() - t0)
    finally:
        srv.set_host_route_max(0)
    break_even = None
    for b in sorted(int(x) for x in curve):
        if curve[str(b)]["batch_seconds"] / b < t_host1:
            break_even = b
            break
    route_stats = {
        "latency_route": {
            "single_query_device_ms": round(t1 * 1e3, 1),
            "single_query_hostwalk_ms": round(t_host1 * 1e3, 2),
            "single_query_routed_ms": round(t_routed * 1e3, 2),
            "route_speedup": round(t1 / t_routed, 1),
            "measured_break_even_batch": break_even,
            "policy": (
                "auto-mode servers route batches <= 4 to the host CSR "
                "walk (host_route_max; device kernels above)"
            ),
            "parity": "routed answer == device answer == host answer",
        }
    }

    # stream-backed serving point (mode="stream": host-resident corpus,
    # row blocks re-streamed through the device per batch — the
    # beyond-memory serving capability). Opt-in: each batch re-moves or
    # re-materializes the whole corpus.
    stream_stats = {}
    if os.environ.get("UKC_QUERY_STREAM") == "1":
        from uniprot_kmer_based_clustering_tpu.similarity import (
            QueryServer,
        )

        srv_s = QueryServer(
            srv.index, srv.bitset, mode="stream",
            topk_cap=int(os.environ.get("UKC_QUERY_TOPK", "512")),
        )
        csr = srv_s._stream_src is not None
        b = 256
        batch = seqs[:b]
        t0 = time.perf_counter()
        ans_s = srv_s.query(batch, threshold=10)
        t_cold = time.perf_counter() - t0
        ok = all(
            np.array_equal(a, w) for a, w in zip(ans_s, want[: len(batch)])
        )
        t0 = time.perf_counter()
        srv_s.query(batch, threshold=10)
        t_warm = time.perf_counter() - t0
        corpus_gb = srv.bitset.words.nbytes / 2**30
        stream_stats = {
            "stream_mode": {
                "batch": len(batch),
                "cold_seconds": round(t_cold, 2),
                "warm_seconds": round(t_warm, 2),
                "queries_per_s_warm": round(len(batch) / t_warm, 2),
                "block_source": (
                    "csr-device-materialized" if csr else "host-words"
                ),
                "corpus_gib_per_batch": round(corpus_gb, 2),
                "stream_bs_rows": int(srv_s._stream_bs),
                "parity": (
                    f"host-exact ({len(batch)}/{len(batch)})" if ok
                    else "MISMATCH"
                ),
                "label": (
                    "beyond-memory serving path: corpus blocks "
                    + ("MATERIALIZE on device from the once-uploaded "
                       "incidence lists per batch (no dense corpus "
                       "transfer)" if csr else
                       "re-stream host->device per batch "
                       "(transfer-bound by design)")
                    + "; prefer resident/mesh serving whenever the "
                      "bitset fits"
                ),
            }
        }
        if not ok:
            _fail("stream-mode serving mismatch vs host CSR")
            return

    qn = int(os.environ.get("UKC_QUERY_N", "0"))
    rec = {
        "metric": "query_serving",
        "value": round(best_qps, 1),
        "unit": "queries/s",
        "corpus": f"synthetic-{qn}" if qn else os.path.basename(fasta),
        "corpus_proteins": int(table.n),
        "curve": curve,
        "pipelined": pipeline,
        "max_sustained_qps": round(best_qps, 1),
        "single_query_latency_ms": round(t1 * 1e3, 1),
        "batch64_seconds": round(t64, 4),
        "parity": "host-exact (256/256 sync + every pipelined answer)",
        "device": str(jax.devices()[0]),
        "card": card,
        **route_stats,
        **stream_stats,
    }
    print(json.dumps(rec))
    from uniprot_kmer_based_clustering_tpu.utils.artifact import (
        write_bench_artifact,
    )

    name = "query"
    if qn:
        name = f"queryscale{qn // 1000}k" if qn != 30000 else "queryscale"
    write_bench_artifact(
        name, rec, os.path.dirname(os.path.abspath(__file__)),
    )


if __name__ == "__main__":
    main()
