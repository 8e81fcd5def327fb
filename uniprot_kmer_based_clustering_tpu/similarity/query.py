"""Query serving: shared-k-mer search of new sequences against a built
corpus index.

The reference is a batch binary with no query path — re-clustering the
whole corpus is its only way to relate a new protein to it. Here the
packed corpus bitset is a standing index: encoding Q query sequences,
rank-hashing them into the corpus's repeated-k-mer space, and a blocked
[Q, K]·[K, N] int8 matmul give every query's shared-k-mer counts against
all N corpus proteins at the sweep's full matmul rate — the serving-side
complement of the batch pipeline (queries with k-mers outside the
corpus's repeated set simply don't match on those positions, exactly as
a corpus member wouldn't).

Serving loops should hold a :class:`QueryServer`. On accelerators it
keeps the packed corpus device-resident (uploaded once) and reuses one
compiled kernel per (query-bucket, weighted) shape; the matmul scans
over 128-word blocks of the packed corpus, unpacking each block to int8
on the fly, so device memory stays ∝ N×4096 int8 instead of the full
N×K unpack (8× the packed bitset), and query counts pad to power-of-two
buckets (min 8) to bound the compiled-shape count. Single-device serving
finishes with an on-device threshold/top-k epilogue and fetches only the
hit lanes (the full [Q, N] counts matrix is N/cap times more readback
per query); a
query with more hits than the candidate capacity is re-answered exactly
through the full-counts kernel. On accelerator-free hosts the server
instead walks a rank-CSR of the corpus incidence lists (the Gustavson
structure of the native sweep) — microseconds per query, no device,
bit-identical results.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np

from uniprot_kmer_based_clustering_tpu.kmers.bitset import BitsetMatrix
from uniprot_kmer_based_clustering_tpu.kmers.encode import (
    encode_kmers,
    seqs_to_buffer,
)
from uniprot_kmer_based_clustering_tpu.kmers.index import KmerIndex

_BLOCK_WORDS = 128  # 4096 bit columns unpacked per scan step


def query_ranks(
    index: KmerIndex, seqs: Sequence[str]
) -> List[np.ndarray]:
    """Per-query deduplicated rank-hash ids: encode each sequence's
    k-mers and map them into the corpus's repeated-k-mer rank space
    (non-repeated/unknown k-mers drop out). The single definition of
    "which corpus bit columns does this query touch" — both serving
    paths build on it, so they cannot drift."""
    buf, offsets = seqs_to_buffer(seqs)
    codes, koff = encode_kmers(buf, offsets, index.k)
    out = []
    for qi in range(len(seqs)):
        ranks = index.rank_of(codes[koff[qi] : koff[qi + 1]])
        out.append(np.unique(ranks[ranks >= 0]).astype(np.int64))
    return out


def pack_query_bitsets(
    index: KmerIndex, seqs: Sequence[str], w_pad: int
) -> np.ndarray:
    """uint32 [Q, w_pad] presence rows for query sequences, in the
    corpus's rank-hash bit space (non-repeated k-mers drop out)."""
    words = np.zeros((len(seqs), w_pad), np.uint32)
    for qi, ranks in enumerate(query_ranks(index, seqs)):
        np.bitwise_or.at(
            words[qi], ranks >> 5, np.uint32(1) << (ranks & 31).astype(np.uint32)
        )
    return words


def _blocked_counts(qwords, corpus_blocks, weight_blocks, weighted: bool):
    """Traced blocked query-vs-corpus count matmul (shared by the
    full-counts and top-k jits so the two paths cannot drift)."""
    import jax
    import jax.numpy as jnp

    from uniprot_kmer_based_clustering_tpu.ops.bitmul import (
        unpack_words_to_int8,
    )

    # corpus_blocks: uint32 [nb, N, BLOCK]; qwords: uint32 [Q, w_pad]
    nb, n_rows, bw = corpus_blocks.shape
    q = qwords.shape[0]
    q_blocks = jnp.transpose(qwords.reshape(q, nb, bw), (1, 0, 2))

    def step(acc, xs):
        cb, qb, wb = xs
        a = unpack_words_to_int8(qb)
        b = unpack_words_to_int8(cb, wb if weighted else None)
        acc = acc + jax.lax.dot_general(
            a, b, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return acc, None

    acc0 = jnp.zeros((q, n_rows), jnp.int32)
    acc, _ = jax.lax.scan(
        step, acc0, (corpus_blocks, q_blocks, weight_blocks)
    )
    return acc


@functools.lru_cache(maxsize=4)
def _counts_fn(weighted: bool):
    """Jitted blocked query-vs-corpus count kernel (memoized so repeated
    serving calls reuse the compiled executable — jit caches key on
    function identity)."""
    import jax

    @jax.jit
    def counts(qwords, corpus_blocks, weight_blocks):
        return _blocked_counts(qwords, corpus_blocks, weight_blocks,
                               weighted)

    return counts


@functools.lru_cache(maxsize=8)
def _counts_topk_fn(weighted: bool, cap: int, n: int):
    """Jitted counts + on-device threshold/top-k epilogue.

    The alignment gate keeps only a handful of corpus rows per query,
    so instead of fetching the full int32 [Q, N] counts matrix the
    epilogue masks `counts > threshold` on device and returns the best
    `cap` (value, index) lanes per query plus the EXACT hit count.
    The selected lanes are then CANONICALIZED by a two-key lane sort
    (count desc via overflow-safe bitwise-not keys, index asc) —
    `lax.top_k`'s tie order is NOT stable at every lane width on this
    stack (it matched the host's count-desc/index-asc order at the
    bundled 10.7k-lane scale but broke it at 100,352 lanes, caught by
    bench_query's 100k parity gate 2026-08-21), and the selection is
    unaffected because a query whose hit count exceeds `cap` is
    detected by the caller and re-answered through the full-counts
    kernel — never a silent truncation (when every hit fits, tie order
    cannot change WHICH lanes are selected, only their order).

    Latency shaping (every synchronizing host↔device interaction is a
    round trip): the three results concatenate into ONE int32
    [Q, 2·cap+1] array (vals | idx | nhits) so the caller pays one
    fetch, and `n` is a static per-server constant so the only per-call
    upload besides the query rows is the threshold scalar.
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def counts_topk(qwords, corpus_blocks, weight_blocks, threshold):
        counts = _blocked_counts(qwords, corpus_blocks, weight_blocks,
                                 weighted)
        cols = jax.lax.broadcasted_iota(jnp.int32, counts.shape, 1)
        # padding corpus rows (col ≥ n) are all-zero words (count 0) but
        # a negative threshold would admit them — mask explicitly, same
        # as the full-counts path's [:, :n] slice
        hit = (counts > threshold) & (cols < n)
        nhits = jnp.sum(hit, axis=1, dtype=jnp.int32)
        # non-hit sentinel = INT32_MIN: counts are int32 sums of int8
        # products (|count| ≤ 127·K ≪ 2³¹), so every real hit — including
        # negative-weighted ones under arbitrary user int8 weights with a
        # threshold below -1 — still ranks above the sentinel lanes
        sentinel = jnp.iinfo(jnp.int32).min
        masked = jnp.where(hit, counts, sentinel)
        vals, idx = jax.lax.top_k(masked, cap)
        vals, idx = _canonical_lane_sort(vals, idx)
        return jnp.concatenate(
            [vals, idx.astype(jnp.int32), nhits[:, None]], axis=1
        )

    return counts_topk


def _canonical_lane_sort(vals, idx):
    """Canonicalize top-k lanes to the serving order contract (count
    desc, index asc): two-key `lax.sort` with ``~vals`` as the primary
    key — bitwise NOT is a total, overflow-safe descending map (the
    int32 sentinel INT32_MIN maps to INT32_MAX, so sentinel lanes sort
    LAST; plain negation would overflow on it). Exists because
    `lax.top_k`'s tie order varies with the lane width on this stack."""
    import jax
    import jax.numpy as jnp

    nv, si = jax.lax.sort(
        (jnp.bitwise_not(vals), idx.astype(jnp.int32)), num_keys=2
    )
    return jnp.bitwise_not(nv), si


@functools.lru_cache(maxsize=8)
def _stream_block_topk_fn(weighted: bool, cap: int):
    """Jitted one-ROW-BLOCK serving kernel for stream mode: counts of
    the query batch vs one host-streamed corpus row block, with the
    same on-device threshold/top-k epilogue as :func:`_counts_topk_fn`
    (sentinel, tie order, exact per-(query, block) hit counts packed as
    int32 [Q, 2·cap+1] = vals | local idx | nhits).

    The contraction is chunked over word blocks inside the jit (the
    row block transposes on device) so the unpacked int8 operands never
    materialize whole. ``valid_n`` masks padding rows past the corpus
    end — traced, so every block shares one compiled shape.
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def block_topk(qwords, rows, weight_blocks, threshold, valid_n):
        bs, w = rows.shape
        nbw = w // _BLOCK_WORDS
        rb = jnp.transpose(
            rows.reshape(bs, nbw, _BLOCK_WORDS), (1, 0, 2)
        )
        counts = _blocked_counts(qwords, rb, weight_blocks, weighted)
        cols = jax.lax.broadcasted_iota(jnp.int32, counts.shape, 1)
        hit = (counts > threshold) & (cols < valid_n)
        nhits = jnp.sum(hit, axis=1, dtype=jnp.int32)
        sentinel = jnp.iinfo(jnp.int32).min
        masked = jnp.where(hit, counts, sentinel)
        vals, idx = jax.lax.top_k(masked, cap)
        vals, idx = _canonical_lane_sort(vals, idx)
        return jnp.concatenate(
            [vals, idx.astype(jnp.int32), nhits[:, None]], axis=1
        )

    return block_topk


@functools.lru_cache(maxsize=4)
def _stream_block_counts_fn(weighted: bool):
    """Full [Q, bs] counts for one streamed row block — the exact redo
    path when a (query, block) pair overflows the stream top-k cap."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def block_counts(qwords, rows, weight_blocks):
        bs, w = rows.shape
        nbw = w // _BLOCK_WORDS
        rb = jnp.transpose(
            rows.reshape(bs, nbw, _BLOCK_WORDS), (1, 0, 2)
        )
        return _blocked_counts(qwords, rb, weight_blocks, weighted)

    return block_counts


class QueryServer:
    """A standing corpus index for repeated shared-k-mer queries.

    Three serving modes, identical outputs (pinned in tests):
      * device (accelerators): uploads the packed corpus bitset once,
        pre-blocked for the scan kernel, and answers with blocked int8
        matmuls; with ``mesh`` given, the corpus rows are sharded over
        the mesh and GSPMD partitions the same kernel — the layout for
        corpora beyond one device's memory;
      * host (``mode="auto"`` on the cpu platform, needs the host-built
        incidence lists): a rank-CSR walk — the Gustavson structure of
        the native sweep — with no device involvement at all;
      * stream (``mode="stream"``): the corpus bitset stays in HOST
        memory and row blocks stream through the device per query
        batch — serving for corpora beyond one device's memory without
        a mesh (the serving analogue of the out-of-core sweep engine,
        ops/stream.py). Transfer-bound by design: each batch re-moves
        (or re-materializes) the whole corpus, so batch large and prefer
        the resident/mesh modes whenever the bitset fits.

    `weights` (int8 [w_pad*32], utils.blosum.rank_weights_int8) switches
    scores to BLOSUM-weighted mode, same as the weighted sweep.
    """

    def __init__(
        self,
        index: KmerIndex,
        bitset: BitsetMatrix,
        weights: Optional[np.ndarray] = None,
        mode: str = "auto",
        mesh=None,
        topk_cap: int = 512,
        stream_bs: Optional[int] = None,
        stream_source: str = "auto",
        host_route_max: object = "auto",
    ):
        import jax

        if mode not in ("auto", "host", "device", "stream"):
            raise ValueError(f"unknown mode {mode!r}")
        self.index = index
        self.bitset = bitset
        self.weighted = weights is not None
        self._weights = weights
        self._mesh = mesh
        # LATENCY routing: a batch of ≤ host_route_max queries answers
        # through the host rank-CSR walk even on device/mesh/stream
        # servers (lazily built on first use). A single device query
        # pays several host↔device round trips while the CSR walk
        # answers it in milliseconds; the device path wins once the
        # batch amortizes its round trips. The break-even batch of 4
        # has not been re-measured on the GPU (bench_query records both
        # paths). host_route_max="auto" enables the route
        # for mode="auto" servers only — an EXPLICIT mode="device" /
        # "stream" / mesh server keeps its chosen kernel on every batch
        # (tests and benches rely on that); pass a number to force the
        # route on any non-host server, 0 to disable.
        self._host_route_max = 0
        if index.has_incidences and mode != "host":
            if host_route_max == "auto":
                self._host_route_max = (
                    4 if (mode == "auto" and mesh is None) else 0
                )
            else:
                self._host_route_max = int(host_route_max)
        self._host_csr_built = False
        # single-device serving compacts hits on device and fetches only
        # the best `topk_cap` lanes per query (a fraction of the full
        # counts row's readback); a query with
        # more hits is re-answered exactly through the full-counts
        # kernel — only the overflowed rows, but that pass still costs a
        # second matmul + an [o_pad, N] fetch, so size topk_cap above
        # the expected max hit count for latency-sensitive serving. ≤ 0
        # disables the fast path.
        self._topk_cap = int(topk_cap)
        # set when an add_proteins rollback fails and the serving state
        # (CSR / device blocks) no longer matches index/bitset; queries
        # raise until rebuild_serving() succeeds
        self._needs_rebuild = False
        self._stream_mode = mode == "stream"
        if self._stream_mode:
            if mesh is not None:
                raise ValueError(
                    "mode='stream' is single-device (shard a mesh with "
                    "mesh=... instead)"
                )
            self._host_mode = False
            # rows per streamed block: ~1.5 GB of packed words by
            # default (word-chunked in-jit, so only the packed block
            # plus one unpack chunk is ever device-resident)
            if stream_bs is None:
                stream_bs = max(
                    1024,
                    min(
                        bitset.n_pad,
                        ((3 << 29) // (bitset.w_pad * 4)) // 1024 * 1024,
                    ),
                )
            self._stream_bs = int(stream_bs)
            # block source: "csr" materializes each corpus block on
            # device from the incidence lists (uploaded once) instead
            # of re-uploading the dense corpus per batch (9.2 GiB per
            # batch at 100k proteins). "auto" picks csr whenever the
            # host-built incidences exist.
            if stream_source not in ("auto", "host", "csr"):
                raise ValueError(
                    f"unknown stream_source {stream_source!r}"
                )
            use_csr = stream_source == "csr" or (
                stream_source == "auto" and index.has_incidences
            )
            if use_csr and not index.has_incidences:
                raise ValueError(
                    "stream_source='csr' needs the host-built index "
                    "incidence lists"
                )
            self._stream_src = None
            if use_csr:
                self._build_stream_source()
            import jax.numpy as jnp

            if self.weighted:
                self._weight_blocks = jnp.asarray(
                    np.asarray(weights, np.int8).reshape(
                        bitset.w_pad // _BLOCK_WORDS, _BLOCK_WORDS * 32
                    )
                )
            else:
                self._weight_blocks = jnp.zeros(
                    (bitset.w_pad // _BLOCK_WORDS, 1), jnp.int8
                )
            return
        if mesh is not None:
            # corpus rows sharded over the mesh (GSPMD partitions the
            # same scan kernel; counts come back sharded on the corpus
            # axis) — the serving layout for corpora beyond one device
            if mode == "host":
                raise ValueError("mode='host' is single-process")
            self._host_mode = False
            self._build_device_blocks()
            return
        # accelerator-free hosts skip the device matmul entirely: the
        # host sparse path (rank CSR walk, same structure as the native
        # Gustavson sweep) answers in microseconds per query, while an
        # XLA:CPU matmul against the corpus takes tens of seconds
        if mode == "auto":
            self._host_mode = (
                jax.devices()[0].platform == "cpu"
                and index.has_incidences
            )
        else:
            self._host_mode = mode == "host"
            if self._host_mode and not index.has_incidences:
                raise ValueError(
                    "mode='host' needs the host-built incidence lists"
                )
        if self._host_mode:
            self._build_host_csr()
        else:
            self._build_device_blocks()

    def set_host_route_max(self, n: int) -> None:
        """Adjust the latency-route break-even batch at runtime
        (0 disables routing); needs the host-built incidence lists.
        The CSR rebuilds lazily on the next routed query."""
        if n and not self.index.has_incidences:
            raise ValueError(
                "latency routing needs the host-built index incidence "
                "lists"
            )
        self._host_route_max = int(n)

    def _build_host_csr(self):
        order = np.argsort(self.index.incidence_rank, kind="stable")
        self._rlist = self.index.incidence_protein[order]
        counts = np.bincount(
            self.index.incidence_rank, minlength=self.index.n_repeated
        )
        self._roff = np.zeros(self.index.n_repeated + 1, np.int64)
        np.cumsum(counts, out=self._roff[1:])

    def _build_device_blocks(self):
        import jax
        import jax.numpy as jnp

        bitset, weights = self.bitset, self._weights
        nb = bitset.w_pad // _BLOCK_WORDS
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            # shard rows over EVERY mesh axis (a 2×4 hierarchical mesh
            # splits 8 ways), so the full mesh contributes HBM capacity
            axes = tuple(self._mesh.axis_names)
            d = int(self._mesh.devices.size)
            if bitset.n_pad % d != 0:
                raise ValueError(
                    f"N_pad={bitset.n_pad} must divide over {d} devices"
                )
            # shard rows first (device_put splits the host array), then
            # block on-device — each shard transposes locally
            rows = jax.device_put(
                bitset.words, NamedSharding(self._mesh, P(axes, None))
            )
            reblock = jax.jit(
                lambda w: jnp.transpose(
                    w.reshape(w.shape[0], nb, _BLOCK_WORDS), (1, 0, 2)
                ),
                out_shardings=NamedSharding(
                    self._mesh, P(None, axes, None)
                ),
            )
            self._corpus_blocks = reblock(rows)
        elif bitset.words.nbytes > (3 << 30):
            # large corpora (the 100k/9 GB regime): the on-device
            # transpose would briefly hold TWO copies of the corpus
            # (upload + blocked output ≈ 2 × 9.2 GB) — pre-block on host
            # instead and upload the final layout once, so the device
            # peak is exactly the corpus size (a one-time server build
            # cost).
            host_blocked = np.ascontiguousarray(
                np.asarray(bitset.words)
                .reshape(bitset.n_pad, nb, _BLOCK_WORDS)
                .transpose(1, 0, 2)
            )
            self._corpus_blocks = jax.device_put(host_blocked)
        else:
            self._corpus_blocks = jnp.transpose(
                jnp.asarray(bitset.words).reshape(
                    bitset.n_pad, nb, _BLOCK_WORDS
                ),
                (1, 0, 2),
            )
        if self.weighted:
            self._weight_blocks = jnp.asarray(weights, jnp.int8).reshape(
                nb, _BLOCK_WORDS * 32
            )
        else:
            # unused by the unweighted kernel; a scan input must still
            # have a leading nb axis
            self._weight_blocks = jnp.zeros((nb, 1), jnp.int8)

    def _counts_host(self, seqs: Sequence[str]) -> np.ndarray:
        """int32 [Q, n] shared counts via the rank-CSR walk (no device)."""
        n = self.bitset.n
        counts = np.zeros((len(seqs), n), np.int32)
        w = self._weights
        for qi, ranks in enumerate(query_ranks(self.index, seqs)):
            if ranks.shape[0] == 0:
                continue
            spans = [
                self._rlist[self._roff[r] : self._roff[r + 1]]
                for r in ranks
            ]
            js = np.concatenate(spans)
            if w is None:
                counts[qi] = np.bincount(js, minlength=n)
            else:
                wvals = np.repeat(
                    w[ranks].astype(np.int32),
                    self._roff[ranks + 1] - self._roff[ranks],
                )
                # np.bincount with weights returns float64; the int
                # sums are exact (≪ 2^53) so the cast is lossless
                counts[qi] = np.bincount(
                    js, weights=wvals, minlength=n
                ).astype(np.int32)
        return counts

    def add_proteins(
        self, seqs: Sequence[str], threshold: int = 10
    ) -> np.ndarray:
        """Append new proteins to the standing corpus, in place.

        The reference's incremental analogue is ``Tree::add_protein``
        (src/tree.rs:524-536). Extends the rank space for genuinely-new
        repeated k-mers (including docfreq promotions of standing unique
        k-mers), appends bitset rows for the new sequences WITHOUT
        re-encoding the standing corpus (kmers.append — append(A+B) ≡
        rebuild(A∪B), pinned in tests), and rebuilds the serving state
        (host CSR, or device blocks — the corpus re-uploads once; size
        appends in batches, not one protein at a time, on accelerators).

        Returns the new-vs-all pairs over the alignment gate as an int64
        ``[P, 3]`` array of (i, j, shared count), i < j, global row ids
        (new rows start at the pre-append ``bitset.n``), sorted by
        (i, j) — the same shape as the batch sweep's pair rows.

        Weighted servers can't self-update: rank-aligned weights are
        derived from the OLD rank space and silently misweight after a
        rank shift — rebuild the server with recomputed weights instead.
        """
        if self.weighted:
            raise ValueError(
                "add_proteins on a weighted server: rank-aligned weights "
                "become stale when the rank space grows — recompute "
                "weights for the appended index and build a new server"
            )
        from uniprot_kmer_based_clustering_tpu.kmers.append import (
            append_to_index,
        )

        n_old = self.bitset.n
        new_index, new_bitset = append_to_index(
            self.index, self.bitset, seqs
        )

        _rebuild = self.rebuild_serving  # clears _needs_rebuild on success

        # commit the append ONLY if the serving rebuild succeeds: a
        # failure there (device OOM uploading the enlarged corpus, mesh
        # row-shape mismatch) must not leave the server half-updated —
        # queries would encode against the NEW rank space while the
        # device still serves the OLD corpus blocks. On failure, restore
        # the pre-append state (strictly smaller — the rebuild that was
        # working before) and re-raise the original error.
        old_index, old_bitset = self.index, self.bitset
        self.index, self.bitset = new_index, new_bitset
        try:
            _rebuild()
        except BaseException as append_err:
            self.index, self.bitset = old_index, old_bitset
            try:
                _rebuild()
            except Exception as restore_err:
                # the restore itself failed: index/bitset now point at
                # the old corpus while the serving blocks/CSR may be
                # partially torn down — queries would crash or answer
                # from stale state with no indication. Mark the server
                # dead (every query raises until a rebuild succeeds)
                # and surface both errors chained.
                self._needs_rebuild = True
                import warnings

                warnings.warn(
                    "add_proteins rollback failed: serving state is "
                    f"inconsistent and queries are disabled ({restore_err!r});"
                    " call rebuild_serving() once the cause is fixed",
                    RuntimeWarning,
                )
                # the bare raise below re-raises append_err — attach
                # the restore failure to IT so both errors surface in
                # the traceback (mutating restore_err would chain an
                # exception nobody raises). add_note is 3.11+; older
                # interpreters keep the warning as the only record.
                if hasattr(append_err, "add_note"):
                    append_err.add_note(
                        f"rollback to the pre-append serving state ALSO "
                        f"failed ({restore_err!r}); server flagged "
                        f"needs_rebuild"
                    )
            raise

        # new-vs-all report, vectorized (a per-match Python loop costs
        # minutes at dense-homology scale on this throttled host): each
        # query row's matches -> (min, max, count) rows; np.unique
        # dedups the doubly-reported new-new pairs (equal counts) and
        # returns (i, j, c)-lexicographic order — the batch sweep's.
        parts = []
        for qi, m in enumerate(self.query(seqs, threshold=threshold)):
            m = np.asarray(m, np.int64).reshape(-1, 2)
            gi = n_old + qi
            m = m[m[:, 0] != gi]  # drop the self match
            if not len(m):
                continue
            parts.append(
                np.stack(
                    [
                        np.minimum(m[:, 0], gi),
                        np.maximum(m[:, 0], gi),
                        m[:, 1],
                    ],
                    axis=1,
                )
            )
        if not parts:
            return np.zeros((0, 3), np.int64)
        return np.unique(np.concatenate(parts), axis=0)

    def rebuild_serving(self):
        """Rebuild the serving state (host CSR or device blocks) from
        the current index/bitset; clears the inconsistency flag set by
        a failed :meth:`add_proteins` rollback. Stream mode rebuilds
        its CSR block source (host-words streaming holds no state —
        blocks re-stream from bitset.words per batch)."""
        if self._stream_mode:
            if self._stream_src is not None:
                self._build_stream_source()
        elif self._host_mode:
            self._build_host_csr()
        else:
            self._build_device_blocks()
        # the latency route's CSR is derived from the (possibly grown)
        # index — invalidate so the next routed query rebuilds it
        self._host_csr_built = False
        self._needs_rebuild = False

    def _build_stream_source(self):
        """(Re)build the CSR block source from the CURRENT index/bitset
        — one definition of the source geometry shared by __init__ and
        rebuild_serving so the two cannot drift."""
        from uniprot_kmer_based_clustering_tpu.ops.stream import (
            CSRBlockSource,
        )

        self._stream_src = CSRBlockSource(
            self.index.incidence_protein, self.index.incidence_rank,
            self.bitset.n_pad, self.bitset.w_pad,
        )
        self._stream_src.prepare(
            self._stream_bs,
            -(-self.bitset.n_pad // self._stream_bs) * self._stream_bs,
        )

    def _stream_block(self, row0: int):
        """One [stream_bs, W] corpus block on device: materialized from
        the CSR source when available, else uploaded from the host
        matrix (ragged tail zero-padded)."""
        import jax

        bs = self._stream_bs
        if self._stream_src is not None:
            return self._stream_src.put(row0 // bs)
        words = np.asarray(self.bitset.words)
        rows = words[row0 : row0 + bs]
        if rows.shape[0] < bs:
            rows = np.concatenate([
                rows,
                np.zeros((bs - rows.shape[0], words.shape[1]),
                         np.uint32),
            ])
        return jax.device_put(rows)

    def query_async(self, seqs: Sequence[str], threshold: int = 10):
        """Dispatch a batch WITHOUT any synchronizing fetch.

        Returns an opaque handle for :meth:`query_wait`. Several handles
        may be in flight at once — the device executes them back to back
        while earlier answers are being fetched/post-processed, hiding
        the per-batch host↔device round trip behind compute: the
        pipelined serving
        loop is

            handles = [srv.query_async(b) for b in batches]   # enqueue
            answers = [srv.query_wait(h) for h in handles]    # drain

        Host mode has no device to overlap with; the handle carries the
        eagerly computed counts.
        """
        if self._needs_rebuild:
            raise RuntimeError(
                "serving state is inconsistent after a failed "
                "add_proteins rollback; call rebuild_serving()"
            )
        nq = len(seqs)
        if nq == 0:
            return {"nq": 0, "threshold": threshold}
        if self._host_mode or (
            nq <= self._host_route_max and self.index.has_incidences
        ):
            # host mode proper, or the latency route: batches below the
            # device break-even answer via the rank-CSR walk (identical
            # results — both paths count the same rank intersections)
            if not self._host_mode and not self._host_csr_built:
                self._build_host_csr()
                self._host_csr_built = True
            return {
                "nq": nq,
                "threshold": threshold,
                "counts_host": self._counts_host(seqs),
            }
        import jax  # noqa: F401  (device path; jit fns imported lazily)
        import jax.numpy as jnp

        qwords = pack_query_bitsets(self.index, seqs, self.bitset.w_pad)
        q_pad = max(8, 1 << (nq - 1).bit_length())
        qp = np.zeros((q_pad, self.bitset.w_pad), np.uint32)
        qp[:nq] = qwords
        qp_j = jnp.asarray(qp)
        if self._stream_mode:
            # stream the corpus row blocks through the device; every
            # block's packed (vals|idx|nhits) stays on device until
            # query_wait's single batched fetch. The device executes
            # blocks in launch order, overlapping block b+1's upload
            # with block b's matmul.
            bs = self._stream_bs
            n_pad = self.bitset.n_pad
            # stream mode always answers through the per-block top-k
            # (there is no resident full-counts alternative); the cap
            # only bounds the per-(query, block) readback — misses are
            # redone exactly per block
            cap = max(1, min(
                self._topk_cap if self._topk_cap > 0 else 512, bs
            ))
            fn = _stream_block_topk_fn(self.weighted, cap)
            blocks = []
            # backpressure: every queued execution pins its input
            # block's HBM until it runs — with no bound, a beyond-HBM
            # corpus would accumulate in-flight blocks past device
            # memory (the exact condition this mode exists for).
            # Size-gated: corpora whose queued blocks stay within a
            # few GB dispatch fully async (no synchronizing fetch,
            # the query_async contract); past that, the (small)
            # output of the block `max_inflight` steps back is
            # retired per dispatch — the fetched ndarray is kept so
            # query_wait doesn't refetch it.
            block_bytes = bs * self.bitset.w_pad * 4
            max_inflight = max(2, int((4 << 30) // max(1, block_bytes)))
            for row0 in range(0, n_pad, bs):
                out = fn(
                    qp_j, self._stream_block(row0), self._weight_blocks,
                    jnp.int32(threshold),
                    jnp.int32(max(0, min(bs, self.bitset.n - row0))),
                )
                blocks.append([row0, out])
                if len(blocks) > max_inflight:
                    ent = blocks[-1 - max_inflight]
                    ent[1] = jax.device_get(ent[1])
            return {
                "nq": nq,
                "threshold": threshold,
                "cap": cap,
                "qwords": qwords,
                "stream_blocks": blocks,
            }
        cap = min(self._topk_cap, self.bitset.n_pad)
        # the fast path exists to shrink readback: it fetches
        # [q_pad, 2·cap+1] vs the full path's [q_pad, n_pad] — once
        # cap grows past that break-even it is strictly slower than
        # just fetching the counts, so skip the epilogue entirely
        if 2 * cap + 1 >= self.bitset.n_pad:
            cap = 0
        if self._mesh is None and cap > 0:
            # hit-compacted fast path: the gate keeps only a few
            # corpus rows per query, so fetch [q_pad, cap] candidate
            # lanes + exact hit counts in ONE device_get instead of
            # the full [q_pad, N] counts matrix (~10× less readback
            # at the bundled scale). Fetch keeps the q_pad padding
            # rows: slicing to nq on host-side device arrays would
            # compile one program per distinct nq. Mesh serving stays
            # on the full-counts kernel —
            # top_k over the row-sharded counts axis would make
            # GSPMD all-gather the full matrix anyway.
            return {
                "nq": nq,
                "threshold": threshold,
                "cap": cap,
                "qwords": qwords,
                "packed_dev": _counts_topk_fn(
                    self.weighted, cap, self.bitset.n
                )(
                    qp_j,
                    self._corpus_blocks,
                    self._weight_blocks,
                    jnp.int32(threshold),
                ),
            }
        return {
            "nq": nq,
            "threshold": threshold,
            "counts_dev": _counts_fn(self.weighted)(
                qp_j, self._corpus_blocks, self._weight_blocks
            ),
        }

    def query_wait(
        self, handle, top: Optional[int] = None
    ) -> List[np.ndarray]:
        """Fetch + finalize a :meth:`query_async` handle (one readback)."""
        nq = handle["nq"]
        if nq == 0:
            return []
        threshold = handle["threshold"]
        if "stream_blocks" in handle:
            import jax

            cap = handle["cap"]
            # one batched fetch retires every block of the batch
            packed = jax.device_get(
                [out for _row0, out in handle["stream_blocks"]]
            )
            per_q = [[] for _ in range(nq)]
            for (row0, _out), arr in zip(handle["stream_blocks"], packed):
                vals = arr[:, :cap]
                idx = arr[:, cap : 2 * cap]
                nhits = arr[:, 2 * cap]
                over = np.nonzero(nhits[:nq] > cap)[0]
                full = None
                if over.shape[0]:
                    # capacity miss in this block: exact redo — rebuild
                    # the block once (CSR-materialized or re-uploaded)
                    # and fetch full counts for ONLY the overflowed
                    # query rows (padded to their own pow2 bucket, the
                    # device-mode redo's idiom — fetching the whole
                    # batch would move [q_pad, bs] int32 to the host
                    # per block)
                    import jax.numpy as jnp

                    o_pad = max(
                        8, 1 << (int(over.shape[0]) - 1).bit_length()
                    )
                    op = np.zeros(
                        (o_pad, self.bitset.w_pad), np.uint32
                    )
                    op[: over.shape[0]] = handle["qwords"][over]
                    full = np.asarray(
                        _stream_block_counts_fn(self.weighted)(
                            jnp.asarray(op), self._stream_block(row0),
                            self._weight_blocks,
                        )
                    )
                over_row = {int(q): k for k, q in enumerate(over)}
                valid = max(0, min(self._stream_bs, self.bitset.n - row0))
                for qi in range(nq):
                    nh = int(nhits[qi])
                    if nh == 0:
                        continue
                    if nh > cap:
                        row = full[over_row[qi], :valid]
                        hits = np.nonzero(row > threshold)[0]
                        per_q[qi].append(
                            (row0 + hits.astype(np.int64),
                             row[hits].astype(np.int64))
                        )
                    else:
                        per_q[qi].append(
                            (row0 + idx[qi, :nh].astype(np.int64),
                             vals[qi, :nh].astype(np.int64))
                        )
            out = []
            for qi in range(nq):
                if not per_q[qi]:
                    out.append(np.zeros((0, 2), np.int64))
                    continue
                gidx = np.concatenate([g for g, _v in per_q[qi]])
                gval = np.concatenate([v for _g, v in per_q[qi]])
                order = np.lexsort((gidx, -gval))
                m = np.stack([gidx[order], gval[order]], axis=1)
                out.append(m[:top] if top is not None else m)
            return out
        if "packed_dev" in handle:
            import jax
            import jax.numpy as jnp

            cap = handle["cap"]
            qwords = handle["qwords"]
            packed = jax.device_get(handle["packed_dev"])
            vals, idx, nhits = (
                packed[:, :cap],
                packed[:, cap : 2 * cap],
                packed[:, 2 * cap],
            )
            over = np.nonzero(nhits[:nq] > cap)[0]
            if over.shape[0]:
                # some queries overflowed the candidate capacity —
                # exactness first: re-answer ONLY those rows through
                # the full-counts kernel, padded to their own
                # power-of-two bucket, and keep the top-k answers
                # already in hand for everyone else (one promiscuous
                # query must not re-run and re-fetch the whole batch)
                o_pad = max(8, 1 << (int(over.shape[0]) - 1).bit_length())
                op = np.zeros((o_pad, self.bitset.w_pad), np.uint32)
                op[: over.shape[0]] = qwords[over]
                full = np.asarray(
                    _counts_fn(self.weighted)(
                        jnp.asarray(op),
                        self._corpus_blocks,
                        self._weight_blocks,
                    )
                )[: over.shape[0], : self.bitset.n]
            over_row = {int(q): k for k, q in enumerate(over)}
            out = []
            for qi in range(nq):
                if qi in over_row:
                    row = full[over_row[qi]]
                    hits = np.nonzero(row > threshold)[0]
                    c = row[hits].astype(np.int64)
                    order = np.lexsort((hits, -c))
                    m = np.stack([hits[order], c[order]], axis=1)
                else:
                    nh = int(nhits[qi])
                    m = np.stack(
                        [
                            idx[qi, :nh].astype(np.int64),
                            vals[qi, :nh].astype(np.int64),
                        ],
                        axis=1,
                    )
                out.append(m[:top] if top is not None else m)
            return out
        if "counts_dev" in handle:
            counts = np.asarray(handle["counts_dev"])[
                :nq, : self.bitset.n
            ]
        else:
            counts = handle["counts_host"]

        out: List[np.ndarray] = []
        for qi in range(nq):
            hits = np.nonzero(counts[qi] > threshold)[0]
            c = counts[qi, hits].astype(np.int64)
            order = np.lexsort((hits, -c))
            m = np.stack([hits[order], c[order]], axis=1)
            out.append(m[:top] if top is not None else m)
        return out

    def query(
        self,
        seqs: Sequence[str],
        threshold: int = 10,
        top: Optional[int] = None,
    ) -> List[np.ndarray]:
        """Shared-k-mer counts of each query sequence vs the corpus.

        Returns one int64 ``[M_q, 2]`` array per query — (corpus protein
        index, shared count), sorted by count descending then index —
        reporting corpus proteins with count **>** threshold (the
        pipeline's alignment gate), optionally only the best `top`.

        Synchronous: dispatch + fetch in one call. Pipelined serving
        loops use :meth:`query_async` / :meth:`query_wait` to keep
        several batches in flight.
        """
        return self.query_wait(
            self.query_async(seqs, threshold=threshold), top=top
        )


def query_shared_kmers(
    index: KmerIndex,
    bitset: BitsetMatrix,
    seqs: Sequence[str],
    threshold: int = 10,
    weights: Optional[np.ndarray] = None,
    top: Optional[int] = None,
) -> List[np.ndarray]:
    """One-shot convenience wrapper: build a QueryServer and query it.

    Serving loops should construct the :class:`QueryServer` once instead
    (keeps the corpus device-resident / the CSR built across calls);
    this wrapper redoes that setup every call.
    """
    return QueryServer(index, bitset, weights=weights).query(
        seqs, threshold=threshold, top=top
    )
