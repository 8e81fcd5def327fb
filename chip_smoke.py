"""Smoke test of the main path on one NVIDIA GPU, through the user's
entry points, with every result checked exactly.

    python chip_smoke.py               # one card: phases 1-5 below
    python chip_smoke.py --four-cards  # the four-card paths only

One process drives the card(s). The corpus is written from a fixed seed
at the bundled dataset's scale (10,619 proteins, lengths 150-500, 15 AMR
classes; 1,000 proteins share a template with one other protein, the
sparse-pair regime). The reference for every pair list is the native
C++ sparse sweep (``io.native.sparse_sweep``) on the same host index —
an independent implementation of the same counts — and equality is
exact.

Phases (one card):
  1. ``cli run`` with default options and ``--align sw``: pairs.tsv,
     the parity counters in stats.json, clusters.tsv (against host
     union-find over the reference pairs), and Smith-Waterman scores of
     64 sampled pairs (device kernel and blastp_output.tsv against the
     host DP);
  2. ``cli run --k 7`` and ``cli run --weighting blosum62``;
  3. ``cli run --engine stream --stream-source csr --extract onepass``;
  4. ``cli query`` with 8 corpus sequences against
     ``QueryServer(mode="host")``;
  5. the 100k in-core point of bench_scale.py through ``run_pipeline``
     with ``engine="auto"``, gated by ``bench_scale.oracle_gate`` in both
     directions, under the memory budget read from the card.

``--four-cards`` runs ``cli run --devices 4`` with ``--extract two_pass``
and ``--extract fused``, and ``--engine stream --stream-source csr
--extract onepass --devices 4``, each against the reference pair list.

Each phase prints its cold wall seconds (compilation included; not a
benchmark number), the device's ``peak_bytes_in_use`` and the engine the
run resolved to. The last line is one JSON object
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Exits nonzero, printing no such line, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

#: The 10,619-protein corpus: n, templates (protein i copies template
#: i % templates), seed.
SMALL_N, SMALL_TEMPLATES, SEED = 10_619, 9_619, 0
#: The bench_scale.py 100k in-core point (its default templates and
#: mutation rate for this size; a ~9 GiB packed bitset).
BIG_N = 100_000
THRESHOLD = 10
SW_SAMPLES = 64
QUERY_COUNT = 8


def compare_pairs(got, ref, what: str) -> None:
    """Exact equality of two (i, j, score) pair lists; raises with the
    first difference."""
    got = np.asarray(got, np.int64).reshape(-1, 3)
    ref = np.asarray(ref, np.int64).reshape(-1, 3)
    if got.shape == ref.shape and np.array_equal(got, ref):
        return
    if got.shape != ref.shape:
        raise AssertionError(
            f"{what}: {len(got)} pairs, reference has {len(ref)}"
        )
    row = int(np.nonzero((got != ref).any(axis=1))[0][0])
    raise AssertionError(
        f"{what}: pair {row} is {got[row].tolist()}, reference "
        f"{ref[row].tolist()}"
    )


def read_pairs_tsv(path: str) -> np.ndarray:
    """(protein_i, protein_j, score) of a pairs.tsv written by cli run."""
    rows = []
    with open(path) as f:
        next(f)
        for line in f:
            c = line.rstrip("\n").split("\t")
            rows.append((int(c[0]), int(c[1]), int(c[6])))
    return np.asarray(rows, np.int64).reshape(-1, 3)


def _cli(argv) -> str:
    from uniprot_kmer_based_clustering_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    return buf.getvalue()


class _Corpus:
    """The FASTA plus host-side references computed lazily on it."""

    def __init__(self, path: str):
        self.path = path
        self._cache = {}

    def index(self, k: int = 5):
        from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
        from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline

        if k not in self._cache:
            self._cache[k] = run_pipeline(
                self.path, PipelineConfig(k=k, cluster="none"),
                stop_after="pack",
            )
        return self._cache[k]

    def native(self, k: int = 5, weighting: str = "none"):
        """(row_stats, pairs) of the native sparse sweep."""
        from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
        from uniprot_kmer_based_clustering_tpu.io import native
        from uniprot_kmer_based_clustering_tpu.utils.blosum import (
            rank_weights_int8,
        )

        key = ("native", k, weighting)
        if key not in self._cache:
            res = self.index(k)
            idx, bs = res.index, res.bitset
            weights, thr = None, THRESHOLD
            if weighting == "blosum62":
                weights = rank_weights_int8(
                    idx.repeated_codes, k, bs.w_pad * 32
                )
                thr = PipelineConfig(
                    weighting="blosum62"
                ).effective_weighted_threshold(weights)
            out = native.sparse_sweep(
                idx.incidence_protein, idx.incidence_rank, res.table.n,
                idx.n_repeated, res.table.amr_class_ids, thr,
                weights=weights,
            )
            if out is None:
                raise RuntimeError("the native C++ runtime did not build")
            self._cache[key] = out
        return self._cache[key]


def _stats(out_dir: str) -> dict:
    with open(os.path.join(out_dir, "stats.json")) as f:
        return json.load(f)


def phase_default(corpus: _Corpus, tmp: str) -> str:
    from uniprot_kmer_based_clustering_tpu.align.sw_device import (
        sw_scores_device,
    )
    from uniprot_kmer_based_clustering_tpu.align.sw_host import sw_align_host
    from uniprot_kmer_based_clustering_tpu.kmers.encode import (
        residues_to_indices,
    )
    from uniprot_kmer_based_clustering_tpu.models.components import (
        connected_components,
    )
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        PairwiseResult,
    )

    out = os.path.join(tmp, "run_default")
    _cli(["run", corpus.path, "--out", out, "--align", "sw"])
    rs, ref = corpus.native()
    table = corpus.index().table
    compare_pairs(read_pairs_tsv(os.path.join(out, "pairs.tsv")), ref,
                  "default run pairs.tsv")
    if len(ref) == 0:
        raise AssertionError("the corpus produced no pairs")

    stats = _stats(out)
    want = PairwiseResult.from_row_stats(rs, ref).parity_counters()
    got = {k: stats["parity"][k] for k in want}
    if got != want:
        raise AssertionError(f"stats.json parity {got} != native {want}")

    labels = []
    with open(os.path.join(out, "clusters.tsv")) as f:
        next(f)
        labels = [int(line.split("\t")[3]) for line in f]
    if not np.array_equal(labels, connected_components(table.n, ref)):
        raise AssertionError("clusters.tsv != host union-find")

    # Smith-Waterman: 64 sampled pairs, device kernel and the written
    # TSV against the host DP
    bits = {}
    with open(os.path.join(out, "blastp_output.tsv")) as f:
        next(f)
        for line in f:
            c = line.rstrip("\n").split("\t")
            bits[(c[0], c[2])] = c[11]
    pick = np.random.default_rng(SEED).choice(
        len(ref), min(SW_SAMPLES, len(ref)), replace=False
    )
    res = residues_to_indices(table.seq_buf).astype(np.int32)
    off = table.offsets
    seqs = [(res[off[j]:off[j + 1]], res[off[i]:off[i + 1]])
            for i, j, _ in ref[pick]]
    lq = max(len(q) for q, _ in seqs)
    ls = max(len(s) for _, s in seqs)
    q_idx = np.zeros((len(seqs), lq), np.int32)
    s_idx = np.zeros((len(seqs), ls), np.int32)
    for r, (q, s) in enumerate(seqs):
        q_idx[r, :len(q)] = q
        s_idx[r, :len(s)] = s
    q_len = np.array([len(q) for q, _ in seqs])
    s_len = np.array([len(s) for _, s in seqs])
    dev_score = sw_scores_device(q_idx, q_len, s_idx, s_len)[0]
    for r, (i, j, _) in enumerate(ref[pick]):
        host = sw_align_host(*seqs[r])
        if int(dev_score[r]) != host.score:
            raise AssertionError(
                f"device SW score {int(dev_score[r])} != host "
                f"{host.score} on pair ({i},{j})"
            )
        line = bits.get((table.ids[j], table.ids[i]))
        if line != f"{host.bitscore():.1f}":
            raise AssertionError(
                f"blastp_output.tsv bitscore {line} != host "
                f"{host.bitscore():.1f} on pair ({i},{j})"
            )
    return stats["engine"]


def phase_variant(corpus: _Corpus, tmp: str, name: str, flags, k=5,
                  weighting="none") -> str:
    out = os.path.join(tmp, f"run_{name}")
    _cli(["run", corpus.path, "--out", out, *flags])
    compare_pairs(
        read_pairs_tsv(os.path.join(out, "pairs.tsv")),
        corpus.native(k, weighting)[1], f"{name} pairs.tsv",
    )
    return _stats(out)["engine"]


def phase_query(corpus: _Corpus) -> str:
    from uniprot_kmer_based_clustering_tpu.similarity.query import (
        QueryServer,
    )

    res = corpus.index()
    table = res.table
    # proteins that share a template with another one, so every query
    # has hits beyond itself
    picks = [int(i) for i in corpus.native()[1][:QUERY_COUNT, 0]]
    seqs = [table.seq(i) for i in picks]
    argv = ["query", corpus.path]
    for s in seqs:
        argv += ["--seq", s]
    got = {}
    for line in _cli(argv).splitlines()[1:]:
        q, j, _, _, c = line.split("\t")
        got.setdefault(q, []).append((int(j), int(c)))
    ref = QueryServer(res.index, res.bitset, mode="host").query(
        seqs, threshold=THRESHOLD
    )
    for qi, m in enumerate(ref):
        want = [tuple(int(x) for x in row) for row in m]
        if got.get(f"query{qi}", []) != want:
            raise AssertionError(
                f"query{qi}: cli {got.get(f'query{qi}')} != host {want}"
            )
        if len(want) < 2:
            raise AssertionError(f"query{qi} found no homolog")
    return "query: device blocked matmul (QueryServer mode=auto)"


def phase_100k(tmp: str) -> str:
    import bench_scale
    from uniprot_kmer_based_clustering_tpu.config import PipelineConfig
    from uniprot_kmer_based_clustering_tpu.pipeline import run_pipeline
    from uniprot_kmer_based_clustering_tpu.utils.accel import (
        device_memory_budget,
    )

    print(f"  memory budget: {device_memory_budget()} bytes", flush=True)
    path = os.path.join(tmp, "corpus_100k.fasta")
    bench_scale.write_fasta(path, *bench_scale.synth_proteins(BIG_N))
    result = run_pipeline(
        path, PipelineConfig(engine="auto", cluster="none")
    )
    pairs = result.pairwise.pairs
    if len(pairs) != result.pairwise.cross_over or len(pairs) == 0:
        raise AssertionError(
            f"{len(pairs)} pairs, counters say {result.pairwise.cross_over}"
        )
    checked = bench_scale.oracle_gate(
        result.index, result.table.amr_class_ids, pairs, BIG_N, THRESHOLD,
        samples=1024,
    )
    print(f"  100k: {len(pairs)} pairs, {checked} oracle-checked, "
          f"bitset {result.bitset.words.nbytes / 2**30:.2f} GiB",
          flush=True)
    return result.engine


def _peak_bytes(devices) -> int:
    return max(
        int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
        for d in devices
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX sees {devices})",
              file=sys.stderr)
        return 1
    n_cards = 4 if args.four_cards else 1
    if len(devices) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bench_scale
    from uniprot_kmer_based_clustering_tpu.utils.accel import (
        card_line,
        enable_persistent_cache,
    )

    enable_persistent_cache()
    print(card_line(), flush=True)
    print(f"jax {jax.__version__}; compile cache "
          f"{jax.config.jax_compilation_cache_dir}", flush=True)
    used = devices[:n_cards]
    failed = []

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            engine = fn(*a, **kw)
            status = "ok"
        except Exception:  # every phase runs; any failure fails the run
            traceback.print_exc()
            engine, status = "-", "FAILED"
            failed.append(name)
        print(
            f"phase {name}: {status} wall_s={time.perf_counter() - t0:.1f} "
            f"(cold, compile included) peak_bytes_in_use="
            f"{_peak_bytes(used)} engine={engine}",
            flush=True,
        )

    with tempfile.TemporaryDirectory(prefix="ukc_smoke_") as tmp:
        path = os.path.join(tmp, "corpus.fasta")
        bench_scale.write_fasta(path, *bench_scale.synth_proteins(
            SMALL_N, seed=SEED, n_templates=SMALL_TEMPLATES
        ))
        corpus = _Corpus(path)
        if args.four_cards:
            for name, flags in (
                ("4cards-two_pass", ["--extract", "two_pass"]),
                ("4cards-fused", ["--extract", "fused"]),
                ("4cards-stream", ["--engine", "stream", "--stream-source",
                                   "csr", "--extract", "onepass"]),
            ):
                phase(name, phase_variant, corpus, tmp, name,
                      [*flags, "--devices", "4"])
        else:
            phase("1-default+sw", phase_default, corpus, tmp)
            phase("2-k7", phase_variant, corpus, tmp, "k7", ["--k", "7"],
                  k=7)
            phase("2-blosum62", phase_variant, corpus, tmp, "blosum62",
                  ["--weighting", "blosum62"], weighting="blosum62")
            phase("3-stream-csr-onepass", phase_variant, corpus, tmp,
                  "stream", ["--engine", "stream", "--stream-source", "csr",
                             "--extract", "onepass"])
            phase("4-query", phase_query, corpus)
            phase("5-100k-in-core", phase_100k, tmp)

    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
