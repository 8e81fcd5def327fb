"""Out-of-core streaming matmul sweep: corpora larger than one device's memory.

Every in-core engine keeps the packed ``[N_pad, W]`` uint32 bitset matrix
resident on the device (DESIGN.md known-limits: ~10 GB at a 100k synthetic
run — the single-chip ceiling). This engine keeps the packed matrix in
HOST memory and streams row *blocks* through the device:

* a **stationary group** of ``g`` row blocks is uploaded once and stays
  resident;
* every moving block ``j`` is uploaded once per group and swept against
  all stationary blocks ``i ≤ j`` of the group — the upper-triangle
  block-pair schedule of ``ops.bitmul._scan_sweep``, with the operands
  now explicit device arrays instead of in-HBM slices;
* statistics accumulate **on device** in donated ``[N_pad, 8]`` /
  ``[nb, nb, 2]`` buffers (one host fetch for the whole sweep); a tiny
  per-step probe scalar bounds the dispatch queue to ``inflight`` steps
  so host→device transfers never pile up unboundedly.

Host↔device traffic ≈ ``matrix_bytes · nbk / (2·g)`` for the moving
blocks plus one pass of stationaries — the same blocking trade-off as an
out-of-core matmul. Results are bit-identical to every in-core engine
(the core invariant; tests/test_stream.py pins pair-list equality).

This is the single-chip analogue of the mesh row sharding in
``parallel/sharded.py`` (which divides the residency by the device
count): a 1-chip user with a corpus beyond HBM streams; a pod user
shards. The reference has no counterpart — its whole 258M-edge graph
lives in a 512 GB RAM envelope (run.sh).

Remaining scale ceiling: the ``block_hits [nb, nb, 2]`` accumulator is
device-resident and grows quadratically in the corpus size — ~8 bytes
per block² (3 GB at 10M rows with block=512). The budgeting below
accounts for it, but past ~20M rows it alone outgrows HBM; a host-side
per-group fetch-and-reset would lift that (not implemented — far beyond
any AMR corpus).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

#: Phase breakdown of the most recent :func:`sweep_mxu_stream` call —
#: wall seconds in host→device uploads (synchronous buffer handoff),
#: step dispatch (async), in-flight drains (the blocking waits), and the
#: final accumulator fetch, plus the resolved blocking parameters.
#: Written unconditionally (a handful of perf_counter calls); consumed
#: by bench_engines to explain warm-vs-cold behavior with measured
#: numbers instead of guesses.
last_trace: dict = {}

#: Same, for the most recent :func:`extract_pairs_stream` call:
#: ``stack_s`` is the host-side batch assembly (this host writes RAM at
#: ~85 MB/s — stacking two [batch, tile, W] operand copies is real
#: time), ``dispatch_s`` the upload+kernel dispatch, ``drain_s`` the
#: blocking in-flight waits, ``finalize_s`` the device sort + fetch.
last_extract_trace: dict = {}

from uniprot_kmer_based_clustering_tpu.ops.bitmul import (
    TOPK_CAP,
    _counts_window_pair,
    accumulate_pair_block,
    bucket_pow2,
    compact_positions,
    pair_block_stats,
    topk_subtile_candidates,
)
from uniprot_kmer_based_clustering_tpu.utils.accel import device_memory_budget


@functools.partial(jax.jit, static_argnames=("bs", "w"))
def _materialize_block(rows_a, ranks_a, valid_a, b, *, bs: int, w: int):
    """[bs, w] packed words for block ``b`` from the staged per-block
    incidence arrays ([nbk, m] each). Module-level (NOT a per-instance
    closure — jax's jit cache keys on function identity) and ``b`` is
    traced, so ONE compiled program serves every block of every
    same-geometry source."""
    rows_b = jax.lax.dynamic_index_in_dim(rows_a, b, 0, keepdims=False)
    ranks_b = jax.lax.dynamic_index_in_dim(ranks_a, b, 0, keepdims=False)
    valid_b = jax.lax.dynamic_index_in_dim(valid_a, b, 0, keepdims=False)
    # padding lanes go to out-of-bounds slots (dropped). Two ranks of
    # one row in the same 32-bit word share a flat index, so the
    # scatter-add must not claim unique indices (a GPU scatter may drop
    # its atomics under that promise and lose bits).
    lane = jnp.arange(rows_b.shape[0], dtype=jnp.int32)
    flat = jnp.where(valid_b, rows_b * w + (ranks_b >> 5), bs * w + lane)
    bit = jnp.where(
        valid_b,
        jnp.uint32(1) << (ranks_b & 31).astype(jnp.uint32),
        jnp.uint32(0),
    )
    words = jnp.zeros(bs * w, jnp.uint32).at[flat].add(bit, mode="drop")
    return words.reshape(bs, w)


def split_incidence_blocks(p: np.ndarray, r: np.ndarray, bs: int,
                           nbk: int):
    """Split protein-sorted incidence lists into per-``bs``-row-block
    arrays padded to the max block's count — the staging layout every
    CSR materializer consumes (single-chip :class:`CSRBlockSource` and
    the mesh composition in ``parallel/stream_mesh.py`` share this ONE
    splitter so their blocks cannot drift). Returns
    ``(rows, ranks, valid)``, each ``[nbk, m]`` with ``m`` rounded up
    to 8 lanes; ``rows`` are block-local."""
    offs = np.searchsorted(p, np.arange(nbk + 1) * bs)
    per = np.diff(offs)
    m = int(per.max()) if nbk else 0
    m = max(8, -(-m // 8) * 8)
    rows = np.zeros((nbk, m), np.int32)
    ranks = np.zeros((nbk, m), np.int32)
    valid = np.zeros((nbk, m), bool)
    for b in range(nbk):
        lo, hi = offs[b], offs[b + 1]
        k = hi - lo
        rows[b, :k] = p[lo:hi] - b * bs
        ranks[b, :k] = r[lo:hi]
        valid[b, :k] = True
    return rows, ranks, valid


class CSRBlockSource:
    """On-device materialization of packed row blocks from the sparse
    incidence lists — the device-side block source for the stream engine.

    The packed bitset at beyond-memory scale is ~0.02% dense: the 19 GiB
    7-mer/100k matrix carries ~33M set bits, i.e. a ~270 MB CSR. The
    host-words block source re-streams the DENSE matrix (~49 GiB of
    mostly zeros per pass), while this source uploads the incidence
    lists ONCE and rebuilds each ``[bs, W]`` block on device with the
    flat single-bit scatter-add (``kmers/index_device.py``'s idiom —
    every (row, rank) is unique, so add == or; two ranks of one row in
    the same word share a flat index, so the add is not declared
    unique). The per-block flat index space ``bs·W`` always fits int32
    regardless of corpus size (unlike the whole-matrix device build).

    Which source is faster on a PCIe-attached GPU has not been measured;
    this one is required when the host cannot hold the dense matrix at
    all (it is never materialized anywhere).

    Bit-identical blocks by construction (pinned against
    ``pack_bitsets`` slices in tests/test_stream.py).
    """

    def __init__(self, incidence_protein, incidence_rank, n_rows: int,
                 w_words: int):
        p = np.asarray(incidence_protein, np.int32)
        r = np.asarray(incidence_rank, np.int32)
        if p.shape[0] and np.any(np.diff(p) < 0):
            order = np.argsort(p, kind="stable")
            p, r = p[order], r[order]
        self._p, self._r = p, r
        self.n_rows = int(n_rows)
        self.w_words = int(w_words)
        self._bs = None
        # device HBM the staged per-block arrays will occupy for the
        # whole pass (rows+ranks int32 + valid bool, padded to the max
        # block's count — charge 2x for skew); the stream entry points
        # subtract this from their budget before blocking
        self.staging_estimate = 18 * max(1, p.shape[0])

    def prepare(self, bs: int, n_pad: Optional[int] = None) -> None:
        """Split the incidences per bs-row block (padded to the max
        block's count so every block materializes through ONE compiled
        shape) and stage them on device. ``n_pad`` extends coverage
        with all-zero blocks (sweep-side row padding)."""
        nbk = -(-(n_pad or self.n_rows) // bs)
        if self._bs == bs and getattr(self, "_nbk", 0) >= nbk:
            return
        self._bs = bs
        self._nbk = nbk
        rows, ranks, valid = split_incidence_blocks(
            self._p, self._r, bs, nbk
        )
        self._rows = jax.device_put(rows)
        self._ranks = jax.device_put(ranks)
        self._valid = jax.device_put(valid)
        self.staging_estimate = rows.nbytes + ranks.nbytes + valid.nbytes

    def put(self, b: int):
        """Materialize block ``b`` on device ([bs, W] uint32)."""
        return _materialize_block(
            self._rows, self._ranks, self._valid, jnp.int32(b),
            bs=self._bs, w=self.w_words,
        )


@dataclasses.dataclass
class StreamCandidates:
    """Survivor candidates drained from a fused streaming sweep.

    ``pairs`` (int32 [M, 3]) are complete for every tile whose exact hit
    count is ≤ ``k``; ``include_same`` records the candidate mask the
    sweep used (the extract side asserts consistency, mirroring the
    in-core ``FusedCandidates`` contract)."""

    pairs: np.ndarray
    k: int
    include_same: bool


@functools.partial(
    jax.jit,
    static_argnames=(
        "n", "threshold", "block", "w_thresh", "word_chunk",
        "fused_k", "fused_same",
    ),
    donate_argnames=("row_stats", "block_hits"),
)
def _stream_step(
    row_stats,   # int32 [N_pad, 8]   (donated accumulator)
    block_hits,  # int32 [nb, nb, 2]  (donated accumulator)
    wa,          # uint32 [bs, W] stationary block
    wb,          # uint32 [bs, W] moving block
    ca,          # int32 [bs]
    cb,          # int32 [bs]
    weights,     # int8 [W*32]
    i0,          # int32 scalar (traced) — global row offset of wa
    j0,          # int32 scalar (traced) — global row offset of wb
    *,
    n: int,
    threshold: int,
    block: int,
    w_thresh: int,
    word_chunk: int = 0,
    fused_k: int = 0,
    fused_same: bool = False,
):
    """One block-pair: counts matmul + stats, accumulated in place.

    The epilogue and merge are the SAME code as ``_scan_sweep``'s body
    (:func:`pair_block_stats` / :func:`accumulate_pair_block` in
    ops/bitmul.py) so the engines cannot drift. ``probe`` (int32 scalar,
    NOT donated) forces step completion when fetched — the in-flight
    window bound.

    With ``fused_k`` > 0 the step also returns its per-sub-tile top-k
    survivor candidates (``ys`` — the ``_scan_sweep`` fused-extraction
    idiom): the host drains them inside the in-flight window, so the
    dense-homology out-of-core regime never re-uploads the matrix for a
    second extraction pass. A sub-tile whose exact hit count exceeds
    ``fused_k`` is incomplete and is redone by the two-pass extractor.
    """
    counts = _counts_window_pair(wa, wb, weights, word_chunk=word_chunk)
    rs, bh, over_c, over_s = pair_block_stats(
        counts, ca, cb, i0, j0,
        n=n, threshold=threshold, block=block, w_thresh=w_thresh,
    )
    probe = counts[0, 0] + rs[0, 0]
    ys = None
    if fused_k:
        em = (over_c | over_s) if fused_same else over_c
        bi, bj, bc = topk_subtile_candidates(
            em.astype(jnp.int32), counts, i0, j0, tile=block, k=fused_k
        )
        # ONE stacked array per step: the host drain fetches a single
        # array instead of three (each fetched output pays its own
        # device→host round trip, and the drain runs every step)
        ys = jnp.stack([bi, bj, bc])
    row_stats, block_hits = accumulate_pair_block(
        row_stats, block_hits, rs, bh, i0, j0, block=block
    )
    return row_stats, block_hits, probe, ys


def _pad_rows(words: np.ndarray, classes: np.ndarray, multiple: int):
    """Zero-pad host rows (class −1) so the block schedule divides evenly.

    Padding rows have empty bitsets and invalid classes; the ``gj < n``
    mask already excludes them from every statistic, so extra padding is
    free correctness-wise (same contract as kmers.bitset.pack_bitsets)."""
    n_pad = words.shape[0]
    target = -(-n_pad // multiple) * multiple
    if target == n_pad:
        return words, classes
    words = np.concatenate(
        [words, np.zeros((target - n_pad, words.shape[1]), words.dtype)]
    )
    classes = np.concatenate(
        [classes, np.full(target - n_pad, -1, classes.dtype)]
    )
    return words, classes


def auto_stream_block(n_pad: int, w_words: int, block: int,
                      hbm_budget_bytes: int) -> int:
    """Stream-block row count: large blocks amortize dispatch and keep
    the matmul contraction long, but one block must fit comfortably many
    times over (stationary group + in-flight moving blocks + the int32
    counts square). Capped so the [bs, bs] counts block stays ≤ 1/16 of
    the budget, one packed [bs, W] block ≤ 1/8 (room for a stationary
    group AND the in-flight window), and bs ≤ 4096 (beyond which the
    counts square dominates)."""
    bs = block
    while (
        bs * 2 <= 4096
        and bs * 2 <= n_pad
        and (bs * 2) * (bs * 2) * 4 <= hbm_budget_bytes // 16
        and (bs * 2) * w_words * 4 <= hbm_budget_bytes // 8
    ):
        bs *= 2
    # round UP to a block multiple of n_pad only via padding (caller pads)
    return max(block, bs)


def sweep_mxu_stream(
    words_host: np.ndarray,
    classes: np.ndarray,
    n: int,
    threshold: int,
    *,
    bs: Optional[int] = None,
    block: int = 512,
    weights: Optional[np.ndarray] = None,
    w_thresh: int = 1,
    word_chunk: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = None,
    inflight: int = 4,
    fused_k: int = 0,
    fused_same: bool = False,
    max_group: Optional[int] = None,
    block_source: Optional[CSRBlockSource] = None,
):
    """Full upper-triangle sweep with the packed matrix in HOST memory.

    ``max_group`` caps the stationary-group size (g) below the budget's
    choice — the test seam for the multi-group re-streaming schedule,
    which real budgets only force at beyond-HBM scale (the 1<<28 budget
    floor makes toy matrices single-group otherwise).

    ``block_source`` (a :class:`CSRBlockSource`) materializes row
    blocks ON DEVICE from the sparse incidence lists instead of
    streaming them from ``words_host`` (which may then be None).

    Args mirror :func:`ops.bitmul.sweep_mxu` (``bs`` plays ``strip``'s
    role: rows per streamed block). Returns the engine-agnostic
    ``(row_stats int64 [N_pad', 8], tile_hits int32 [nT, 2],
    (ti, tj, block))`` triple — note ``N_pad'`` may exceed
    ``words_host.shape[0]`` (rows padded to a ``bs`` multiple; padding
    rows carry zero stats).

    With ``fused_k`` > 0 a 4th element is returned: int32 ``[M, 3]``
    candidate survivors, drained from each step's per-sub-tile top-k
    inside the in-flight window (so candidate buffers never accumulate
    on device). Candidates of a sub-tile whose exact hit count exceeds
    ``fused_k`` are truncated — :func:`extract_pairs_stream_fused`
    detects those from the tile hits and redoes them exactly.
    ``fused_same`` widens the candidate mask to same-class survivors.
    """
    if hbm_budget_bytes is None:
        hbm_budget_bytes = device_memory_budget()
    if block_source is not None:
        rows0, w_words = block_source.n_rows, block_source.w_words
    else:
        words_host = np.ascontiguousarray(words_host)
        rows0, w_words = words_host.shape
    classes = np.asarray(classes, np.int32)
    if classes.shape[0] < rows0:
        classes = np.concatenate(
            [classes, np.full(rows0 - classes.shape[0], -1, np.int32)]
        )
    if bs is None:
        bs = auto_stream_block(rows0, w_words, block, hbm_budget_bytes)
    assert bs % block == 0, "stream block must be a multiple of the tile"
    if block_source is not None:
        n_pad = -(-rows0 // bs) * bs
        if classes.shape[0] < n_pad:
            classes = np.concatenate(
                [classes,
                 np.full(n_pad - classes.shape[0], -1, np.int32)]
            )
        block_source.prepare(bs, n_pad)
    else:
        words_host, classes = _pad_rows(words_host, classes, bs)
        n_pad = words_host.shape[0]
    nb = n_pad // block
    nbk = n_pad // bs

    if fused_k:
        # capacity beyond a sub-tile's area is meaningless (top_k would
        # reject it); extract_pairs_stream_fused applies the SAME clamp
        # so the keep/redo split stays consistent
        fused_k = min(fused_k, block * block)
    block_bytes = bs * w_words * 4
    # device-resident fixed cost the blocking must leave room for: the
    # two accumulators (row_stats [n_pad,8] + block_hits [nb,nb,2] —
    # the latter grows QUADRATICALLY in corpus size), the in-flight
    # window of moving blocks + their counts squares + their fused
    # candidate buffers, and the class blocks
    nsub = (bs // block) ** 2
    fixed = (
        n_pad * 8 * 4
        + nb * nb * 2 * 4
        + (inflight + 1) * (
            block_bytes + bs * bs * 4 + nsub * fused_k * 12
        )
        + n_pad * 4
        + (block_source.staging_estimate
           if block_source is not None else 0)
    )
    avail = max(block_bytes, hbm_budget_bytes - fixed)

    if word_chunk is None:
        # bound the unpacked int8 transients (8× the packed block each)
        word_chunk = 0
        if 2 * bs * w_words * 32 > avail // 2:
            target = max(128, avail // 2 // (2 * bs * 32))
            base = w_words // 128
            best = 1
            for d in range(1, base + 1):
                if base % d == 0 and d * 128 <= target:
                    best = d
            word_chunk = best * 128

    # stationary group size: how many [bs, W] blocks stay resident
    resident_budget = max(block_bytes, avail // 2)
    g = int(min(nbk, max(1, resident_budget // block_bytes)))
    if max_group:
        g = max(1, min(g, int(max_group)))

    wts = jnp.asarray(
        weights if weights is not None else np.ones(w_words * 32, np.int8),
        jnp.int8,
    )
    row_stats = jnp.zeros((n_pad, 8), jnp.int32)
    block_hits = jnp.zeros((nb, nb, 2), jnp.int32)
    cls_dev = [
        jax.device_put(classes[b * bs : (b + 1) * bs]) for b in range(nbk)
    ]

    pending = []  # per-step (probe, ys) awaiting completion
    cand_parts = []  # host-filtered fused survivor candidates
    trace = {
        "upload_s": 0.0, "dispatch_s": 0.0, "drain_s": 0.0,
        "fetch_s": 0.0, "steps": 0, "uploads": 0,
        "bs": int(bs), "g": int(g), "nbk": int(nbk),
        "word_chunk": int(word_chunk),
    }

    def _drain(limit):
        # completing step t-inflight bounds live moving-block buffers
        # (uploads dispatch asynchronously; nothing else backpressures
        # the queue). In fused mode the candidate fetch doubles as the
        # probe and the buffers leave the device inside the window.
        # Probe-only chunks retire on ONE fetch of their NEWEST probe:
        # a single device executes steps in launch order, so step t's
        # output being readable implies every earlier step completed —
        # each skipped probe saves a device→host round trip.
        t0 = time.perf_counter()
        if len(pending) > limit:
            chunk = pending[: len(pending) - limit]
            del pending[: len(pending) - limit]
            for _probe, ys in chunk:
                if ys is None:
                    continue
                arr = jax.device_get(ys)  # one fetch: [3,nsub,k] stack
                bi, bj, bc = arr[0], arr[1], arr[2]
                m = bc >= 0
                if m.any():
                    cand_parts.append(
                        np.stack(
                            [bi[m], bj[m], bc[m]], axis=1
                        ).astype(np.int32)
                    )
            if chunk[-1][1] is None:
                # the newest entry is probe-only, so no ys fetch above
                # covers it — sync its probe so the whole chunk is truly
                # retired (fused_k is constant per sweep today, making
                # the mixed case unreachable, but don't rely on that)
                jax.device_get(chunk[-1][0])
        trace["drain_s"] += time.perf_counter() - t0

    def _put(lo_block):
        t0 = time.perf_counter()
        if block_source is not None:
            out = block_source.put(lo_block)
        else:
            out = jax.device_put(
                words_host[lo_block * bs : (lo_block + 1) * bs]
            )
        trace["upload_s"] += time.perf_counter() - t0
        trace["uploads"] += 1
        return out

    for s0 in range(0, nbk, g):
        g_here = min(g, nbk - s0)
        stationary = [_put(s0 + t) for t in range(g_here)]
        for jb in range(s0, nbk):
            if jb < s0 + g_here:
                wb = stationary[jb - s0]
            else:
                wb = _put(jb)
            for t in range(g_here):
                ib = s0 + t
                if ib > jb:
                    continue
                t0 = time.perf_counter()
                row_stats, block_hits, probe, ys = _stream_step(
                    row_stats, block_hits, stationary[t], wb,
                    cls_dev[ib], cls_dev[jb], wts,
                    jnp.int32(ib * bs), jnp.int32(jb * bs),
                    n=n, threshold=threshold, block=block,
                    w_thresh=w_thresh, word_chunk=word_chunk,
                    fused_k=fused_k, fused_same=fused_same,
                )
                trace["dispatch_s"] += time.perf_counter() - t0
                trace["steps"] += 1
                pending.append((probe, ys))
                _drain(inflight)
    _drain(0)

    t0 = time.perf_counter()
    rs, bh = jax.device_get((row_stats, block_hits))
    trace["fetch_s"] += time.perf_counter() - t0
    global last_trace
    last_trace = trace
    from uniprot_kmer_based_clustering_tpu.ops.popcount import (
        upper_triangle_tiles,
    )

    ti, tj = upper_triangle_tiles(n_pad, block)
    base = (rs.astype(np.int64), bh[ti, tj], (ti, tj, block))
    if not fused_k:
        return base
    cands = StreamCandidates(
        pairs=(
            np.concatenate(cand_parts, axis=0)
            if cand_parts
            else np.zeros((0, 3), np.int32)
        ),
        k=fused_k,
        include_same=fused_same,
    )
    return base + (cands,)


def sort_compact_append(gbi, gbj, gbc, cursor, keep, gi, gj, counts):
    """Append one window's survivors to the global pair buffers via
    SORT-based compaction.

    Instead of the cumsum+scatter idiom (`compact_positions` +
    ``.at[pos].set``), sort the flattened window by the keep flag
    (survivors first; order
    WITHIN a window is irrelevant — every consumer re-sorts globally by
    (i, j)), sentinel the tail, and write the whole window at ``cursor``
    with one contiguous ``dynamic_update_slice``. The next append
    starts at ``cursor + kept``, overwriting this append's sentinel
    tail, so the final buffer is [real pairs][sentinels] exactly.

    Buffers MUST be allocated with ≥ window extra rows past the usable
    capacity (``_new_pair_buffers(vcap + window)``): the slice would
    otherwise CLAMP near the end and corrupt valid rows in runs that do
    not overflow. In overflow runs the cursor walks past the buffer and
    the slice clamps harmlessly — those buffers are discarded (the
    caller decides overflow from the sweep's own exact int64 total).

    Returns (gbi, gbj, gbc, cursor + kept).
    """
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _IMAX,
    )

    k = keep.ravel()
    key = jnp.where(k, jnp.int32(0), jnp.int32(1))
    _, gi_s, gj_s, c_s = jax.lax.sort(
        (key, gi.ravel(), gj.ravel(), counts.ravel()), num_keys=1
    )
    kept = jnp.sum(k.astype(jnp.int32))
    live = jnp.arange(k.shape[0], dtype=jnp.int32) < kept
    gbi = jax.lax.dynamic_update_slice(
        gbi, jnp.where(live, gi_s, _IMAX), (cursor,)
    )
    gbj = jax.lax.dynamic_update_slice(
        gbj, jnp.where(live, gj_s, _IMAX), (cursor,)
    )
    gbc = jax.lax.dynamic_update_slice(
        gbc, jnp.where(live, c_s, -1), (cursor,)
    )
    return gbi, gbj, gbc, cursor + kept


@functools.partial(
    jax.jit,
    static_argnames=(
        "n", "threshold", "block", "w_thresh", "word_chunk",
        "cross_amr_only",
    ),
    donate_argnames=("row_stats", "block_hits", "gbi", "gbj", "gbc"),
)
def _stream_step_compact(
    row_stats, block_hits,           # donated stat accumulators
    gbi, gbj, gbc, cursor,           # donated global pair buffers
    wa, wb, ca, cb, weights, i0, j0,
    *,
    n: int,
    threshold: int,
    block: int,
    w_thresh: int,
    word_chunk: int,
    cross_amr_only: bool,
):
    """One block-pair of the ONE-PASS engine: counts matmul + stats +
    survivor compaction into the global pair buffers, all in place.

    The survivor mask is ``pair_block_stats``'s own over-threshold mask
    (the quantity the stats count), so the compacted cursor equals the
    sweep's exact pair total whenever capacity suffices — the
    capacity-miss detector. No per-step top_k and no per-step data
    fetch: the cursor scalar is the only probe. Compaction is the
    sort-based append (:func:`sort_compact_append`); the caller
    allocates the buffers with a window of slack rows."""
    return _step_compact_body(
        (row_stats, block_hits, gbi, gbj, gbc, cursor),
        wa, wb, ca, cb, weights, i0, j0,
        n=n, threshold=threshold, block=block, w_thresh=w_thresh,
        word_chunk=word_chunk, cross_amr_only=cross_amr_only,
    )


def _step_compact_body(
    state, wa, wb, ca, cb, weights, i0, j0,
    *, n, threshold, block, w_thresh, word_chunk, cross_amr_only,
):
    """The ONE-PASS step math on plain values — THE single
    implementation shared by the per-step program
    (:func:`_stream_step_compact`) and the scan-chunked program
    (:func:`_stream_scan_chunk`), so the two dispatch modes cannot
    drift. Returns the updated 6-tuple state."""
    row_stats, block_hits, gbi, gbj, gbc, cursor = state
    counts = _counts_window_pair(wa, wb, weights, word_chunk=word_chunk)
    rs, bh, over_c, over_s = pair_block_stats(
        counts, ca, cb, i0, j0,
        n=n, threshold=threshold, block=block, w_thresh=w_thresh,
    )
    em = over_c if cross_amr_only else (over_c | over_s)
    bs = wa.shape[0]
    gi = i0 + jax.lax.broadcasted_iota(jnp.int32, (bs, bs), 0)
    gj = j0 + jax.lax.broadcasted_iota(jnp.int32, (bs, bs), 1)
    gbi, gbj, gbc, cursor = sort_compact_append(
        gbi, gbj, gbc, cursor, em, gi, gj, counts
    )
    row_stats, block_hits = accumulate_pair_block(
        row_stats, block_hits, rs, bh, i0, j0, block=block
    )
    return row_stats, block_hits, gbi, gbj, gbc, cursor


@functools.partial(
    jax.jit,
    static_argnames=(
        "bs", "w", "g", "n", "threshold", "block", "w_thresh",
        "word_chunk", "cross_amr_only",
    ),
    donate_argnames=("row_stats", "block_hits", "gbi", "gbj", "gbc"),
)
def _stream_scan_chunk(
    row_stats, block_hits, gbi, gbj, gbc, cursor,
    stat_stack,   # uint32 [g, bs, W] materialized stationary group
    rows_a, ranks_a, valid_a,   # staged CSR incidence [nbk, m]
    classes_pad,  # int32 [n_pad]
    weights,      # int8 [W*32]
    jb_arr,       # int32 [C] moving-block index per outer entry
    tc_arr,       # int32 [C] active stationary partners (0 = skip entry)
    s0,           # int32 scalar — group's first stationary block
    gh,           # int32 scalar — real group size (≤ g; stack tail unused)
    *,
    bs: int, w: int, g: int, n: int, threshold: int, block: int,
    w_thresh: int, word_chunk: int, cross_amr_only: bool,
):
    """A CHUNK of the one-pass sweep — C moving blocks × ≤g stationary
    partners — as ONE compiled program (``lax.scan`` outer over moving
    blocks, inner over the stationary group, ``lax.cond`` skipping
    inactive entries so the triangular ramp pays no matmuls).

    Exists to cut per-step launch cost: each ``_stream_step_compact``
    launch re-marshals the call (donated ~GB-scale pair buffers
    included). Chunking turns 4,851 launches into ~40 while keeping the
    same per-chunk cursor probe for the in-flight window — the same
    schedule with strictly fewer launches.

    Moving blocks materialize from the CSR staging inside the scan
    (one per outer entry); a moving block that belongs to the resident
    stationary group is taken from the stack instead (the step-loop's
    reuse, via ``cond``). Step order (jb outer, t inner) matches the
    step loop exactly, so even the pre-sort buffer contents are
    identical — bit-identity is by construction, pinned in
    tests/test_stream.py.
    """
    return _scan_chunk_body(
        (row_stats, block_hits, gbi, gbj, gbc, cursor),
        stat_stack, rows_a, ranks_a, valid_a, classes_pad, weights,
        jb_arr, tc_arr, s0, gh,
        bs=bs, w=w, g=g, n=n, threshold=threshold, block=block,
        w_thresh=w_thresh, word_chunk=word_chunk,
        cross_amr_only=cross_amr_only,
    )


def _scan_chunk_body(
    state, stat_stack, rows_a, ranks_a, valid_a, classes_pad, weights,
    jb_arr, tc_arr, s0, gh,
    *, bs, w, g, n, threshold, block, w_thresh, word_chunk,
    cross_amr_only,
):
    """The scan-chunk math on plain values — THE single implementation
    shared by the single-chip program (:func:`_stream_scan_chunk`) and
    the mesh composition (``parallel/stream_mesh.py`` shard_maps this
    per device with a replicated stack), so the two engines cannot
    drift. ``stat_stack`` may hold MORE than ``g`` entries (the mesh
    build pads to a device-count multiple); entries at index ≥ ``gh``
    are never read (``tc`` gating)."""
    def outer(state, x):
        jb, tc = x

        def do_outer(state):
            wb = jax.lax.cond(
                jb - s0 < gh,
                lambda: jax.lax.dynamic_index_in_dim(
                    stat_stack, jnp.clip(jb - s0, 0, g - 1), 0,
                    keepdims=False,
                ),
                lambda: _materialize_block(
                    rows_a, ranks_a, valid_a, jb, bs=bs, w=w
                ),
            )
            cb = jax.lax.dynamic_slice(classes_pad, (jb * bs,), (bs,))
            j0 = jb * bs

            def inner(state2, t):
                def do_inner(state2):
                    wa = jax.lax.dynamic_index_in_dim(
                        stat_stack, t, 0, keepdims=False
                    )
                    i0 = (s0 + t) * bs
                    ca = jax.lax.dynamic_slice(
                        classes_pad, (i0,), (bs,)
                    )
                    return _step_compact_body(
                        state2, wa, wb, ca, cb, weights, i0, j0,
                        n=n, threshold=threshold, block=block,
                        w_thresh=w_thresh, word_chunk=word_chunk,
                        cross_amr_only=cross_amr_only,
                    )

                return jax.lax.cond(
                    t < tc, do_inner, lambda s: s, state2
                ), None

            state, _ = jax.lax.scan(
                inner, state, jnp.arange(g, dtype=jnp.int32)
            )
            return state

        return jax.lax.cond(tc > 0, do_outer, lambda s: s, state), None

    state, _ = jax.lax.scan(outer, state, (jb_arr, tc_arr))
    return state


@functools.partial(jax.jit, static_argnames=("bs", "w", "g"))
def _materialize_stack(rows_a, ranks_a, valid_a, s0, *, bs, w, g):
    """[g, bs, w] stationary-group stack materialized in ONE program
    (g scatter builds under ``lax.scan``); indices past the staging's
    last block clamp to it — those rows are never read (``tc`` gating).

    Cost note: the final PARTIAL group (g_here < g) still materializes
    all g stack entries — the g − g_here clamped duplicates are built
    and never read. Accepted: static shapes keep this one compiled
    program for every group, and the waste is bounded by one group's
    scatter builds on the last group only (a g_here-masked variant
    would compile a second shape for marginal savings)."""
    nbk = rows_a.shape[0]

    def body(_, t):
        b = jnp.minimum(s0 + t, nbk - 1)
        return None, _materialize_block(
            rows_a, ranks_a, valid_a, b, bs=bs, w=w
        )

    _, stack = jax.lax.scan(
        body, None, jnp.arange(g, dtype=jnp.int32)
    )
    return stack


def sweep_extract_stream(
    words_host: np.ndarray,
    classes: np.ndarray,
    n: int,
    threshold: int,
    *,
    bs: Optional[int] = None,
    block: int = 512,
    weights: Optional[np.ndarray] = None,
    w_thresh: int = 1,
    word_chunk: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = None,
    inflight: int = 4,
    cross_amr_only: bool = True,
    cap: Optional[int] = None,
    max_group: Optional[int] = None,
    block_source: Optional[CSRBlockSource] = None,
    pair_format: str = "arr3",
    dispatch: str = "auto",
    scan_chunk: int = 8,
    checkpoint_store=None,
    checkpoint_key: Optional[str] = None,
    fail_after_groups: Optional[int] = None,
):
    """ONE-PASS out-of-core sweep **and** exact pair extraction.

    With ``block_source`` (a :class:`CSRBlockSource`), row blocks are
    materialized ON DEVICE from the sparse incidence lists instead of
    streamed from ``words_host`` (which may then be None — the dense
    matrix is never built anywhere): the transfer-bound regime's fix
    when host→device bandwidth is the bottleneck.

    The fused streaming mode (``sweep_mxu_stream(fused_k=...)``) drains
    per-sub-tile top-k candidates to the host every step — correct, but
    its capacity must be guessed per corpus, and the drain volume is
    ``nsub·k·12`` bytes per step to the host.
    This engine instead compacts each step's survivors into DEVICE
    global pair buffers with the grouped-extraction scatter idiom:
    statistics and the pair list come out of one streamed pass, the
    host fetches one device-sorted array at the end, and the per-step
    probe is a 4-byte cursor (drained in chunks — single-device launch
    order lets one fetch retire many steps).

    ``cap`` bounds the pair buffers (default: an eighth of the HBM
    budget). Capacity is verified exactly — the compacted cursor must
    equal the sweep's own over-threshold total; on a miss the pair list
    is redone by :func:`extract_pairs_stream_grouped` with the exact
    tile hits (one more pass), so the result is identical in every
    regime.

    ``pair_format="packed"`` fetches the pair list in the packed int64
    layout (``similarity.pairwise.unpack_pairs`` decodes; 8 B/pair
    instead of 12 — worth ~1/3 of the dominant readback at beyond-HBM
    scale) when row indices and counts fit the pack; otherwise the
    [M, 3] fallback is returned and callers distinguish by ``ndim``.

    ``dispatch``: "steps" launches one program per block pair (the only
    choice when blocks stream from host RAM — uploads must interleave);
    "scan" (the "auto" default with a CSR block source) runs
    ``scan_chunk`` moving blocks × the whole stationary group per
    launch (:func:`_stream_scan_chunk`) — ~100× fewer launches, which
    this environment's session-varying per-launch cost made the
    difference between 69 s and 477 s of identical device work
    (BENCH_scale7mer100k traces). Bit-identical to "steps" (same body,
    same step order).

    Returns ``(row_stats int64 [N_pad', 8], tile_hits int32 [nT, 2],
    (ti, tj, block), pairs int32 [M, 3] — or packed int64 [M])``.

    **Group-boundary checkpointing** (``checkpoint_store`` — a
    ``utils.checkpoint.CheckpointStore`` — plus ``checkpoint_key``): at
    every completed stationary group the stats accumulators
    (row_stats ~3 MB + block_hits ~300 KB at the 19 GiB design point)
    and the completed-group list persist; a re-run with the same
    store/key and geometry SKIPS completed groups. The multi-GB pair
    buffers are deliberately NOT snapshotted — fetching multi-GB
    buffers at every boundary would dwarf the stats snapshot — because
    the completed
    groups' pairs are exactly recoverable from the checkpointed tile
    hits: on resume the run compacts only the remaining groups' pairs
    and recovers the prior groups' through
    :func:`extract_pairs_stream_grouped` restricted to their tiles
    (one partial extra pass — paid only when a preemption actually
    happened). Bit-identical final output either way (pinned in
    tests/test_stream.py kill/resume). A geometry mismatch (different
    bs/g/threshold/...) ignores the snapshot; a completed run removes
    it. ``fail_after_groups`` is the fault-injection seam: raise after
    that many groups complete this run (SURVEY §5's fault-injection
    row).
    """
    if hbm_budget_bytes is None:
        hbm_budget_bytes = device_memory_budget()
    import os as _os
    if block_source is not None:
        rows0, w_words = block_source.n_rows, block_source.w_words
    else:
        words_host = np.ascontiguousarray(words_host)
        rows0, w_words = words_host.shape
    classes = np.asarray(classes, np.int32)
    if classes.shape[0] < rows0:
        classes = np.concatenate(
            [classes, np.full(rows0 - classes.shape[0], -1, np.int32)]
        )

    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _fetch_sorted_pairs,
        _new_pair_buffers,
        _vcap_bucket,
    )

    if cap is None:
        # an eighth of the budget, never more than the pair space itself
        cap = max(1, min(
            int(hbm_budget_bytes // 8 // 12), n * (n - 1) // 2
        ))
        vcap = _vcap_bucket(int(cap))
    else:
        # explicit caps are honored near-exactly (128-row granularity) —
        # the capacity-miss path is part of the contract and must be
        # reachable below the default bucket floor
        vcap = max(128, -(-int(cap) // 128) * 128)
    # charge the buffers AND the sort-append slack window (the actual
    # bs² when the caller fixed bs; auto_stream_block's 4096 cap
    # otherwise) before sizing the blocks
    slack = int(bs) ** 2 if bs else 4096 * 4096
    src_bytes = (
        block_source.staging_estimate if block_source is not None else 0
    )
    budget = max(
        1 << 28, hbm_budget_bytes - 3 * (vcap + slack) * 4 - src_bytes
    )
    if bs is None:
        bs = auto_stream_block(rows0, w_words, block, budget)
    assert bs % block == 0, "stream block must be a multiple of the tile"
    if block_source is not None:
        n_pad = -(-rows0 // bs) * bs
        if classes.shape[0] < n_pad:
            classes = np.concatenate(
                [classes,
                 np.full(n_pad - classes.shape[0], -1, np.int32)]
            )
        block_source.prepare(bs, n_pad)
    else:
        words_host, classes = _pad_rows(words_host, classes, bs)
        n_pad = words_host.shape[0]
    nb = n_pad // block
    nbk = n_pad // bs

    block_bytes = bs * w_words * 4
    # the drain window is 2·inflight steps (chunked probe retirement) —
    # charge the worst case of one distinct moving block per step
    fixed = (
        n_pad * 8 * 4
        + nb * nb * 2 * 4
        + (2 * inflight + 1) * (block_bytes + 4 * bs * bs * 4)
        + n_pad * 4
    )
    avail = max(block_bytes, budget - fixed)
    resident_budget = max(block_bytes, avail // 2)
    g = int(min(nbk, max(1, resident_budget // block_bytes)))
    if max_group:
        g = max(1, min(g, int(max_group)))

    if word_chunk is None:
        word_chunk = 0
        if 2 * bs * w_words * 32 > avail // 2:
            target = max(128, avail // 2 // (2 * bs * 32))
            base = w_words // 128
            best = 1
            for d in range(1, base + 1):
                if base % d == 0 and d * 128 <= target:
                    best = d
            word_chunk = best * 128

    wts = jnp.asarray(
        weights if weights is not None else np.ones(w_words * 32, np.int8),
        jnp.int8,
    )
    # checkpoint restore: geometry-validated stats accumulators + the
    # completed-group set (see the docstring's checkpointing contract)
    import zlib as _zlib

    # crc of the weight VALUES (not just the weighted flag): resuming
    # with different weights would silently merge stale accumulators
    w_crc = (
        _zlib.crc32(np.ascontiguousarray(weights, np.int8).tobytes())
        if weights is not None else 0
    )
    ckpt_geo = np.array(
        [bs, g, n, n_pad, threshold, block, w_thresh, word_chunk,
         int(bool(cross_amr_only)), w_crc],
        np.int64,
    )
    ckpt_on = checkpoint_store is not None and bool(checkpoint_key)
    prior_groups: set = set()
    restored = None
    if ckpt_on:
        snap = checkpoint_store.load(checkpoint_key)
        if snap is not None and np.array_equal(
            snap.get("geometry"), ckpt_geo
        ):
            prior_groups = {int(x) for x in snap["groups_done"]}
            restored = (snap["row_stats"], snap["block_hits"])
    if restored is not None:
        row_stats = jnp.asarray(restored[0])
        block_hits = jnp.asarray(restored[1])
    else:
        row_stats = jnp.zeros((n_pad, 8), jnp.int32)
        block_hits = jnp.zeros((nb, nb, 2), jnp.int32)
    done_groups = set(prior_groups)
    groups_this_run = 0

    def _group_boundary(state, s0):
        """Post-group checkpoint: settle the queue, fetch the (small)
        stats accumulators, persist, and fire the fault-injection seam."""
        nonlocal groups_this_run
        if not ckpt_on:
            return
        # the boundary drain is pipeline work the pass owes anyway (its
        # time is accounted in drain_s); ckpt_s times ONLY the snapshot
        # itself — the ~4 MB stats fetch + the compressed write
        _drain(0)
        t0 = time.perf_counter()
        rs_c, bh_c = jax.device_get((state[0], state[1]))
        done_groups.add(s0)
        checkpoint_store.save(
            checkpoint_key,
            geometry=ckpt_geo,
            groups_done=np.array(sorted(done_groups), np.int64),
            row_stats=rs_c,
            block_hits=bh_c,
        )
        trace["ckpt_s"] = trace.get("ckpt_s", 0.0) + (
            time.perf_counter() - t0
        )
        groups_this_run += 1
        if (
            fail_after_groups is not None
            and groups_this_run >= fail_after_groups
        ):
            raise RuntimeError(
                f"stream checkpoint fault injection: killed after "
                f"{groups_this_run} group(s)"
            )

    # + one [bs, bs] window of slack rows: the sort-based append writes
    # whole windows at the cursor and must never clamp in a valid run
    buffers = _new_pair_buffers(vcap + bs * bs)
    state = (row_stats, block_hits) + buffers

    if dispatch == "auto":
        dispatch = "scan" if block_source is not None else "steps"
    if dispatch == "scan" and block_source is None:
        raise ValueError(
            "dispatch='scan' requires a CSR block_source (host-words "
            "blocks must upload between launches)"
        )

    pending = []  # cursor probes
    trace = {
        "upload_s": 0.0, "dispatch_s": 0.0, "drain_s": 0.0,
        "fetch_s": 0.0, "steps": 0, "uploads": 0,
        "bs": int(bs), "g": int(g), "nbk": int(nbk),
        "word_chunk": int(word_chunk), "vcap": int(vcap),
        "dispatch": dispatch, "launches": 0,
        "overflow": False,
    }

    def _drain(limit):
        # one fetch of the newest popped cursor retires the chunk
        t0 = time.perf_counter()
        if len(pending) > limit:
            newest = pending[len(pending) - limit - 1]
            del pending[: len(pending) - limit]
            jax.device_get(newest)
        trace["drain_s"] += time.perf_counter() - t0

    def _put(lo_block):
        t0 = time.perf_counter()
        if block_source is not None:
            out = block_source.put(lo_block)
        else:
            out = jax.device_put(
                words_host[lo_block * bs : (lo_block + 1) * bs]
            )
        trace["upload_s"] += time.perf_counter() - t0
        trace["uploads"] += 1
        return out

    if dispatch == "scan":
        cls_pad_dev = jax.device_put(classes[:n_pad])
        stack = None
        for s0 in range(0, nbk, g):
            if s0 in prior_groups:
                continue  # checkpoint resume: group already swept
            g_here = min(g, nbk - s0)
            if stack is not None:
                # release the previous group's stack BEFORE building
                # the next one — two [g, bs, W] stacks coexisting would
                # bust the budget at beyond-HBM scale; drain first so
                # no in-flight chunk still reads it
                stack = None
                _drain(0)
            t0 = time.perf_counter()
            stack = _materialize_stack(
                block_source._rows, block_source._ranks,
                block_source._valid, jnp.int32(s0),
                bs=bs, w=w_words, g=g,
            )
            trace["upload_s"] += time.perf_counter() - t0
            # device materializations this group: the stack + every
            # moving block past the resident group (in-group moving
            # blocks reuse the stack) — keeps the artifact's
            # "volume materialized" accounting equal to the step loop's
            trace["uploads"] += g_here + max(0, nbk - (s0 + g_here))
            jbs = np.arange(s0, nbk, dtype=np.int32)
            tcs = np.minimum(g_here, jbs - s0 + 1).astype(np.int32)
            for c0 in range(0, len(jbs), scan_chunk):
                jb_c = jbs[c0 : c0 + scan_chunk]
                tc_c = tcs[c0 : c0 + scan_chunk]
                if len(jb_c) < scan_chunk:  # pad: tc=0 entries skip
                    pad = scan_chunk - len(jb_c)
                    jb_c = np.concatenate(
                        [jb_c, np.zeros(pad, np.int32)]
                    )
                    tc_c = np.concatenate(
                        [tc_c, np.zeros(pad, np.int32)]
                    )
                t0 = time.perf_counter()
                state = _stream_scan_chunk(
                    *state, stack,
                    block_source._rows, block_source._ranks,
                    block_source._valid, cls_pad_dev, wts,
                    jnp.asarray(jb_c), jnp.asarray(tc_c),
                    jnp.int32(s0), jnp.int32(g_here),
                    bs=bs, w=w_words, g=g, n=n, threshold=threshold,
                    block=block, w_thresh=w_thresh,
                    word_chunk=word_chunk,
                    cross_amr_only=cross_amr_only,
                )
                trace["dispatch_s"] += time.perf_counter() - t0
                trace["steps"] += int(tc_c.sum())
                trace["launches"] += 1
                pending.append(state[5])
                if len(pending) > 2 * inflight:
                    _drain(inflight)
            _group_boundary(state, s0)
    else:
        cls_dev = [
            jax.device_put(classes[b * bs : (b + 1) * bs])
            for b in range(nbk)
        ]
        for s0 in range(0, nbk, g):
            if s0 in prior_groups:
                continue  # checkpoint resume: group already swept
            g_here = min(g, nbk - s0)
            stationary = [_put(s0 + t) for t in range(g_here)]
            for jb in range(s0, nbk):
                if jb < s0 + g_here:
                    wb = stationary[jb - s0]
                else:
                    wb = _put(jb)
                for t in range(g_here):
                    ib = s0 + t
                    if ib > jb:
                        continue
                    t0 = time.perf_counter()
                    state = _stream_step_compact(
                        *state,
                        stationary[t], wb, cls_dev[ib], cls_dev[jb], wts,
                        jnp.int32(ib * bs), jnp.int32(jb * bs),
                        n=n, threshold=threshold, block=block,
                        w_thresh=w_thresh, word_chunk=word_chunk,
                        cross_amr_only=cross_amr_only,
                    )
                    trace["dispatch_s"] += time.perf_counter() - t0
                    trace["steps"] += 1
                    trace["launches"] += 1
                    pending.append(state[5])
                    if len(pending) > 2 * inflight:
                        _drain(inflight)
            _group_boundary(state, s0)
    _drain(0)

    row_stats, block_hits, gbi, gbj, gbc, cursor = state
    t0 = time.perf_counter()
    rs, bh, count = jax.device_get((row_stats, block_hits, cursor))
    trace["fetch_s"] += time.perf_counter() - t0
    from uniprot_kmer_based_clustering_tpu.ops.popcount import (
        upper_triangle_tiles,
    )

    ti, tj = upper_triangle_tiles(n_pad, block)
    tile_hits = bh[ti, tj]
    tiles = (ti, tj, block)
    total = int(tile_hits[:, 0].astype(np.int64).sum())
    hits_vec = tile_hits[:, 0].astype(np.int64)
    if not cross_amr_only:
        total += int(tile_hits[:, 1].astype(np.int64).sum())
        hits_vec = hits_vec + tile_hits[:, 1]

    # checkpoint resume: this run's cursor compacted only the groups
    # swept NOW — prior groups' survivors (known exactly from the
    # restored tile hits) are recovered by the grouped extractor below
    prior_mask = None
    total_prior = 0
    if prior_groups:
        nsb = bs // block
        owner = ((ti // nsb) // g) * g
        prior_mask = np.isin(
            owner, np.fromiter(prior_groups, np.int64, len(prior_groups))
        )
        total_prior = int(hits_vec[prior_mask].sum())
        trace["groups_skipped"] = len(prior_groups)
    total_now = total - total_prior

    if total_now > vcap:
        # capacity miss: `total` is the sweep's own exact int64 survivor
        # count (tile_hits summed on host), so deciding overflow from it
        # — not from the int32 cursor, which wraps past 2^31 survivors —
        # is exact at any scale. Redo the pair list with the exact tile
        # hits (one more pass); truncation impossible.
        trace["overflow"] = True
        # forward the sweep's own blocking so a CSR source reuses its
        # prepared per-block split and the already-compiled step shapes
        # (a fresh auto-sized bs would re-split, re-upload, and compile
        # a second shape family)
        pairs = extract_pairs_stream_grouped(
            None if block_source is not None else words_host,
            classes, tile_hits, tiles, n=n,
            threshold=threshold, cross_amr_only=cross_amr_only,
            weights=weights, hbm_budget_bytes=hbm_budget_bytes,
            inflight=inflight, block_source=block_source,
            bs=bs, word_chunk=word_chunk, max_group=max_group,
            pair_format=pair_format,
        )
    else:
        # total_now ≤ vcap < 2^31 here, so the int32 cursor cannot have
        # wrapped — a mismatch is a genuine compaction bug, not overflow
        if int(count) != total_now:
            raise AssertionError(
                f"one-pass compacted {int(count)} pairs, sweep stats "
                f"promised {total_now}"
            )
        # device-sort, slice the occupied prefix ON DEVICE (sentinels
        # sort to the tail), fetch only `total_now` rows — vcap may be
        # far larger than the survivor count
        t0 = time.perf_counter()
        pairs = _fetch_sorted_pairs(gbi, gbj, gbc, total_now,
                                    pair_format, n_pad)
        trace["fetch_s"] += time.perf_counter() - t0
        trace["pair_format"] = "packed" if pairs.ndim == 1 else "arr3"
        if total_prior:
            # resume merge: recover the checkpointed groups' pairs from
            # their exact tile hits (one partial grouped pass over only
            # those block pairs) and canonicalize the union. Paid only
            # on an actual resume — the unpreempted path never runs it.
            masked = np.zeros_like(tile_hits)
            masked[prior_mask] = tile_hits[prior_mask]
            prior_pairs = extract_pairs_stream_grouped(
                None if block_source is not None else words_host,
                classes, masked, tiles, n=n,
                threshold=threshold, cross_amr_only=cross_amr_only,
                weights=weights, hbm_budget_bytes=hbm_budget_bytes,
                inflight=inflight, block_source=block_source,
                bs=bs, word_chunk=word_chunk, max_group=max_group,
                pair_format=pair_format,
            )
            if pairs.ndim == 1 and prior_pairs.ndim == 1:
                # packed values sort exactly like (i, j) — one np.sort
                pairs = np.sort(np.concatenate([pairs, prior_pairs]))
            else:
                from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (  # noqa: E501
                    pairs_as_array,
                )

                a = np.concatenate(
                    [pairs_as_array(pairs), pairs_as_array(prior_pairs)]
                )
                pairs = a[np.lexsort((a[:, 1], a[:, 0]))]
    if ckpt_on:
        # completed: a stale snapshot must not hijack the next run
        p = checkpoint_store.path(checkpoint_key)
        if p and _os.path.exists(p):
            _os.remove(p)
    global last_onepass_trace
    last_onepass_trace = trace
    return rs.astype(np.int64), tile_hits, tiles, pairs


def extract_pairs_stream_fused(
    words_host: np.ndarray,
    classes: np.ndarray,
    tile_hits: np.ndarray,
    tiles,
    cands: "StreamCandidates",
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights: Optional[np.ndarray] = None,
    redo: str = "auto",
) -> np.ndarray:
    """Fused-mode pair recovery for the streaming engine.

    ``cands`` holds the sweep's drained per-sub-tile top-k survivors —
    complete for every tile whose exact hit count (from ``tile_hits``)
    is ≤ ``cands.k``; denser tiles were truncated by the top-k and are
    redone exactly by the two-pass extractor (a masked
    :func:`extract_pairs_stream` call — only those tiles' row windows
    re-upload). Bit-identical to two-pass in every regime; in the
    dense-homology out-of-core regime this avoids re-streaming the
    whole matrix for extraction (the second full host→device pass).
    """
    assert cands.include_same == (not cross_amr_only), (
        "candidate mask/class-filter mismatch: the sweep's fused_same "
        "must equal (not cross_amr_only)"
    )
    k = cands.k
    cpairs = cands.pairs
    ti, tj, tile = tiles
    h = tile_hits[:, 0].astype(np.int64)
    if not cross_amr_only:
        h = h + tile_hits[:, 1]
    keep = h <= k  # tiles whose candidates are complete

    parts = []
    if cpairs.shape[0]:
        # map each candidate to its tile and keep only complete tiles
        nb = int(max(ti.max(), tj.max())) + 1 if len(ti) else 1
        keep_m = np.zeros((nb, nb), bool)
        keep_m[ti[keep], tj[keep]] = True
        ci = (cpairs[:, 0] // tile).astype(np.int64)
        cj = (cpairs[:, 1] // tile).astype(np.int64)
        sel = keep_m[ci, cj]
        parts.append(cpairs[sel])
        expected = int(h[keep].sum())
        if int(sel.sum()) != expected:
            raise AssertionError(
                f"fused stream compaction found {int(sel.sum())} "
                f"survivors, sweep stats promised {expected}"
            )

    if not keep.all():
        masked = np.zeros_like(tile_hits)
        masked[~keep] = tile_hits[~keep]
        # redo path by upload volume (the shared _prefer_grouped
        # crossover): widespread truncation makes per-tile windows the
        # transfer-quadratic path — switch to the sweep-schedule redo.
        use_grouped = redo == "grouped" or (
            redo == "auto"
            and _prefer_grouped(int((~keep).sum()), tile, words_host)
        )
        redo_fn = (
            extract_pairs_stream_grouped if use_grouped
            else extract_pairs_stream
        )
        parts.append(
            redo_fn(
                words_host, classes, masked, tiles, n=n,
                threshold=threshold, cross_amr_only=cross_amr_only,
                weights=weights,
            )
        )

    if not parts:
        return np.zeros((0, 3), dtype=np.int32)
    pairs = np.concatenate(parts, axis=0)
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    return pairs[order]


@functools.lru_cache(maxsize=16)
def _window_stacker(dcap: int):
    """Jitted on-device stack of ``dcap`` row windows (keyed on the
    bucketed window count; a trivial concat program)."""
    return jax.jit(lambda *ws: jnp.stack(ws))


@functools.partial(
    jax.jit,
    static_argnames=("tile", "weighted", "cross_amr_only", "k"),
)
def _extract_stream_topk(
    gbi, gbj, gbc, cursor,  # global pair buffers (pairwise idiom)
    wstack,    # uint32 [D, tile, W] DISTINCT row windows of this batch
    cstack,    # int32 [D, tile] their class rows
    ia,        # int32 [B] window index of each tile's i side
    ja,        # int32 [B] window index of each tile's j side
    weights,   # int8 [W*32]
    gi0s,      # int32 [B] global row offsets
    gj0s,      # int32 [B] global col offsets
    valid_t,   # bool [B]
    n,
    threshold,
    *,
    tile: int,
    weighted: bool,
    cross_amr_only: bool,
    k: int,
):
    """Recompute a batch of hit tiles from a stack of DISTINCT row
    windows, compact survivors per tile with ``lax.top_k`` (the
    extract_pairs idiom, with the row windows shipped from host instead
    of sliced from a resident matrix), and append them to the global
    buffers. Tiles address their operands through (ia, ja) window
    indices — a row window shared by many hit tiles is copied/uploaded
    once per batch, not once per tile (this host writes RAM at
    ~85 MB/s: duplicating both operands per tile cost 22-26 s of pure
    numpy assembly per bundled-scale extract, the measured dominant
    term of the streaming engine's warm pass). Returns updated
    (gbi, gbj, gbc, cursor)."""
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _accumulate_topk,
    )

    def step(carry, idx):
        counts = _counts_window_pair(
            wstack[ia[idx]], wstack[ja[idx]],
            weights if weighted else None,
        )
        gi0 = gi0s[idx]
        gj0 = gj0s[idx]
        gi = gi0 + jax.lax.broadcasted_iota(jnp.int32, (tile, tile), 0)
        gj = gj0 + jax.lax.broadcasted_iota(jnp.int32, (tile, tile), 1)
        mask = (counts > threshold) & (gi < gj) & (gj < n) & valid_t[idx]
        if cross_amr_only:
            mask &= cstack[ia[idx]][:, None] != cstack[ja[idx]][None, :]
        bi, bj, bc = topk_subtile_candidates(
            mask.astype(jnp.int32), counts, gi0, gj0, tile=tile, k=k
        )
        return carry, (bi[0], bj[0], bc[0])  # one tile == one sub-tile

    _, (bi, bj, bc) = jax.lax.scan(step, 0, jnp.arange(ia.shape[0]))
    return _accumulate_topk(gbi, gbj, gbc, cursor, bi, bj, bc)


@functools.partial(
    jax.jit,
    static_argnames=("tile", "weighted", "cross_amr_only"),
)
def _extract_stream_scatter(
    gbi, gbj, gbc, cursor,
    wstack, cstack, ia, ja, weights, gi0s, gj0s, valid_t, n, threshold,
    *, tile: int, weighted: bool, cross_amr_only: bool,
):
    """Ultra-dense-tile variant: cumsum+scatter compaction into the
    global buffers (the in-core ``_extract_batch`` idiom — top_k at k
    near the tile area is the slow path, pairwise.py TOPK_CAP).
    Same distinct-window operand addressing as the top-k variant.
    Returns updated (gbi, gbj, gbc, cursor)."""
    vcap = gbi.shape[0]

    def step(carry, idx):
        cursor, bi, bj, bc = carry
        counts = _counts_window_pair(
            wstack[ia[idx]], wstack[ja[idx]],
            weights if weighted else None,
        )
        gi0 = gi0s[idx]
        gj0 = gj0s[idx]
        gi = gi0 + jax.lax.broadcasted_iota(jnp.int32, (tile, tile), 0)
        gj = gj0 + jax.lax.broadcasted_iota(jnp.int32, (tile, tile), 1)
        mask = (counts > threshold) & (gi < gj) & (gj < n) & valid_t[idx]
        if cross_amr_only:
            mask &= cstack[ia[idx]][:, None] != cstack[ja[idx]][None, :]
        pos, kept = compact_positions(mask.ravel(), vcap, cursor)
        opts = dict(mode="drop", unique_indices=True)
        bi = bi.at[pos].set(gi.ravel(), **opts)
        bj = bj.at[pos].set(gj.ravel(), **opts)
        bc = bc.at[pos].set(counts.ravel(), **opts)
        return (cursor + kept, bi, bj, bc), None

    (cursor, gbi, gbj, gbc), _ = jax.lax.scan(
        step, (cursor, gbi, gbj, gbc), jnp.arange(ia.shape[0])
    )
    return gbi, gbj, gbc, cursor


#: Phase breakdown of the most recent :func:`extract_pairs_stream_grouped`
#: call — upload seconds/count, dispatch, drains, finalize, the resolved
#: blocking (bs, g) and the skip ratio (block pairs visited / total).
last_grouped_trace: dict = {}

#: Same, for :func:`sweep_extract_stream` (the one-pass engine): adds
#: ``overflow`` (the capacity-miss redo flag) and ``vcap``.
last_onepass_trace: dict = {}


def _prefer_grouped(n_hit_tiles: int, tile: int,
                    words_host: np.ndarray) -> bool:
    """The ONE pass-2 crossover predicate (shared by
    :func:`extract_pairs_stream_auto` and the fused overflow redo so
    the two entry points cannot diverge): the per-tile window path
    re-uploads ≤ ``2·tile·W·4`` bytes per hit tile (shared windows make
    it less); prefer the grouped sweep-schedule pass — roughly one more
    budgeted matrix pass — once that upper bound exceeds a full pass."""
    window_est = 2 * n_hit_tiles * tile * words_host.shape[1] * 4
    return window_est > words_host.nbytes


@functools.partial(
    jax.jit,
    static_argnames=(
        "n", "threshold", "block", "word_chunk", "weighted",
        "cross_amr_only",
    ),
    donate_argnames=("gbi", "gbj", "gbc"),
)
def _extract_block_pair(
    gbi, gbj, gbc, cursor,   # global pair buffers (pairwise idiom)
    wa,        # uint32 [bs, W] stationary block
    wb,        # uint32 [bs, W] moving block
    ca,        # int32 [bs]
    cb,        # int32 [bs]
    weights,   # int8 [W*32]
    i0,        # int32 scalar — global row offset of wa
    j0,        # int32 scalar — global row offset of wb
    sub_mask,  # bool [bs//block, bs//block] — sub-tiles wanted
    *,
    n: int,
    threshold: int,
    block: int,
    word_chunk: int,
    weighted: bool,
    cross_amr_only: bool,
):
    """One block-pair extraction step for the grouped streaming pass.

    Recomputes the full [bs, bs] counts window (the sweep's own operand
    shape — NOT per-tile windows), masks survivors, and compacts them
    into the donated global buffers with the sort-based append
    (:func:`sort_compact_append`; the caller over-allocates by one
    window). ``sub_mask`` restricts output to wanted sub-tiles (all-hit
    tiles for a full extraction; only truncated tiles when redoing a
    fused sweep's overflow). Returns updated (gbi, gbj, gbc, cursor).

    ``weights`` is always an array (ones when unweighted) — the chunked
    operand path slices it unconditionally, so the topk/scatter
    extractors' ``None``-when-unweighted idiom would crash here (it
    did: the first hardware run of the engines-gate row hit
    ``NoneType.ndim`` in ``dynamic_slice_in_dim``). Identical counts:
    the ones-scale is an int8 identity. ``weighted`` stays a static
    arg so weighted/unweighted compile distinct programs like every
    other extractor."""
    del weighted  # (kept static for cache-key parity with the callers)
    counts = _counts_window_pair(
        wa, wb, weights, word_chunk=word_chunk
    )
    bs = wa.shape[0]
    gi = i0 + jax.lax.broadcasted_iota(jnp.int32, (bs, bs), 0)
    gj = j0 + jax.lax.broadcasted_iota(jnp.int32, (bs, bs), 1)
    mask = (counts > threshold) & (gi < gj) & (gj < n)
    if cross_amr_only:
        mask &= ca[:, None] != cb[None, :]
    mask &= jnp.repeat(
        jnp.repeat(sub_mask, block, axis=0), block, axis=1
    )
    return sort_compact_append(
        gbi, gbj, gbc, cursor, mask, gi, gj, counts
    )


def extract_pairs_stream_grouped(
    words_host: np.ndarray,
    classes: np.ndarray,
    tile_hits: np.ndarray,
    tiles,
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights: Optional[np.ndarray] = None,
    bs: Optional[int] = None,
    hbm_budget_bytes: Optional[int] = None,
    inflight: int = 4,
    word_chunk: Optional[int] = None,
    max_group: Optional[int] = None,
    block_source: Optional[CSRBlockSource] = None,
    pair_format: str = "arr3",
) -> np.ndarray:
    """Pass-2 exact pair recovery with the SWEEP's residency schedule.

    :func:`extract_pairs_stream` re-uploads two ``[tile, W]`` row
    windows per hit-tile batch — transfer-optimal when hits are sparse,
    but transfer-QUADRATIC when essentially every tile hits (the
    dense-homology regime: a 100k synthetic extraction would stream
    ~1 TB of windows). This variant reuses the stationary-group /
    moving-block schedule of :func:`sweep_mxu_stream`: one more pass
    over the matrix, bounded by the same HBM budget, each block pair
    recomputed at the sweep's own operand shape and compacted on device
    into the global pair buffers (one final device-sorted fetch).
    Block pairs containing no hit tile are skipped host-side — moving
    blocks nobody needs are never uploaded — so the sparse regime
    degrades gracefully too (though the per-tile window path remains
    cheaper there; :func:`extract_pairs_stream_fused` picks per redo
    volume).

    Bit-identical to every other extraction path (tests/test_stream.py
    pins equality against the in-core extractor and the window path).
    """
    if hbm_budget_bytes is None:
        hbm_budget_bytes = device_memory_budget()
    ti, tj, tile = tiles
    if block_source is not None:
        rows0, w_words0 = block_source.n_rows, block_source.w_words
    else:
        words_host = np.ascontiguousarray(words_host)
        rows0, w_words0 = words_host.shape
    classes = np.asarray(classes, np.int32)
    if classes.shape[0] < rows0:
        classes = np.concatenate(
            [classes, np.full(rows0 - classes.shape[0], -1, np.int32)]
        )
    hits_per_tile = tile_hits[:, 0].astype(np.int64)
    want = tile_hits[:, 0] > 0
    if not cross_amr_only:
        want |= tile_hits[:, 1] > 0
        hits_per_tile = hits_per_tile + tile_hits[:, 1]
    if not want.any():
        return np.zeros((0, 3), dtype=np.int32)
    total = int(hits_per_tile[want].sum())

    w_words = w_words0
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _finalize_pairs,
        _new_pair_buffers,
        _vcap_bucket,
    )

    vcap = _vcap_bucket(total)
    # the global pair buffers (+ the sort-append slack window) are
    # resident for the whole pass — charge them (and the [bs, bs]
    # counts/index transients, in the in-flight accounting below)
    # against the caller's budget before blocking
    slack = int(bs) ** 2 if bs else 4096 * 4096
    src_bytes = (
        block_source.staging_estimate if block_source is not None else 0
    )
    budget = max(
        1 << 28, hbm_budget_bytes - 3 * (vcap + slack) * 4 - src_bytes
    )
    if bs is None:
        bs = auto_stream_block(rows0, w_words, tile, budget)
    assert bs % tile == 0, "grouped block must be a multiple of the tile"
    # the sweep's tile enumeration may cover rows beyond the caller's
    # matrix (sweep-side padding to its own block multiple): pad to the
    # tile coverage first, then to this pass's block multiple
    cover = (int(max(ti.max(), tj.max())) + 1) * tile
    if block_source is not None:
        n_pad = -(-max(cover, rows0) // bs) * bs
        if classes.shape[0] < n_pad:
            classes = np.concatenate(
                [classes,
                 np.full(n_pad - classes.shape[0], -1, np.int32)]
            )
        block_source.prepare(bs, n_pad)
    else:
        if cover > words_host.shape[0]:
            words_host, classes = _pad_rows(words_host, classes, cover)
        words_host, classes = _pad_rows(words_host, classes, bs)
        n_pad = words_host.shape[0]
    nbk = n_pad // bs
    nsb = bs // tile

    # which bs-block pairs contain a wanted tile (host-side skip map) +
    # the per-pair sub-tile mask
    nb = n_pad // tile
    want_m = np.zeros((nb, nb), bool)
    want_m[ti[want], tj[want]] = True
    need = want_m.reshape(nbk, nsb, nbk, nsb).any(axis=(1, 3))

    block_bytes = bs * w_words * 4
    fixed = (
        (inflight + 1) * (block_bytes + 4 * bs * bs * 4) + n_pad * 4
    )
    avail = max(block_bytes, budget - fixed)
    resident_budget = max(block_bytes, avail // 2)
    g = int(min(nbk, max(1, resident_budget // block_bytes)))
    if max_group:
        g = max(1, min(g, int(max_group)))

    if word_chunk is None:
        word_chunk = 0
        if 2 * bs * w_words * 32 > avail // 2:
            target = max(128, avail // 2 // (2 * bs * 32))
            base = w_words // 128
            best = 1
            for d in range(1, base + 1):
                if base % d == 0 and d * 128 <= target:
                    best = d
            word_chunk = best * 128

    weighted = weights is not None
    wts = jnp.asarray(
        weights if weighted else np.ones(w_words * 32, np.int8),
        jnp.int8,
    )
    cls_dev = [
        jax.device_put(classes[b * bs : (b + 1) * bs]) for b in range(nbk)
    ]
    # + one [bs, bs] window of slack rows for the sort-based append
    buffers = _new_pair_buffers(vcap + bs * bs)
    pending = []  # cursor probes — the in-flight window bound
    trace = {
        "upload_s": 0.0, "dispatch_s": 0.0, "drain_s": 0.0,
        "finalize_s": 0.0, "steps": 0, "uploads": 0,
        "bs": int(bs), "g": int(g), "nbk": int(nbk),
        "word_chunk": int(word_chunk),
        "block_pairs_total": int(nbk * (nbk + 1) // 2),
    }

    def _drain(limit):
        # one fetch of the NEWEST popped cursor retires the chunk
        # (single-device launch order — the sweep drain's idiom)
        t0 = time.perf_counter()
        if len(pending) > limit:
            newest = pending[len(pending) - limit - 1]
            del pending[: len(pending) - limit]
            jax.device_get(newest)
        trace["drain_s"] += time.perf_counter() - t0

    def _put(lo_block):
        t0 = time.perf_counter()
        if block_source is not None:
            out = block_source.put(lo_block)
        else:
            out = jax.device_put(
                words_host[lo_block * bs : (lo_block + 1) * bs]
            )
        trace["upload_s"] += time.perf_counter() - t0
        trace["uploads"] += 1
        return out

    for s0 in range(0, nbk, g):
        g_here = min(g, nbk - s0)
        rows = range(s0, s0 + g_here)
        stationary = {}
        for jb in range(s0, nbk):
            steps = [
                ib for ib in rows
                if ib <= jb and need[ib, jb]
            ]
            if not steps:
                continue
            if jb < s0 + g_here:
                if jb not in stationary:
                    stationary[jb] = _put(jb)
                wb = stationary[jb]
            else:
                wb = _put(jb)
            for ib in steps:
                if ib not in stationary:
                    stationary[ib] = _put(ib)
                sub = jnp.asarray(
                    want_m[
                        ib * nsb : (ib + 1) * nsb,
                        jb * nsb : (jb + 1) * nsb,
                    ]
                )
                t0 = time.perf_counter()
                buffers = _extract_block_pair(
                    *buffers,
                    stationary[ib], wb, cls_dev[ib], cls_dev[jb], wts,
                    jnp.int32(ib * bs), jnp.int32(jb * bs), sub,
                    n=n, threshold=threshold, block=tile,
                    word_chunk=word_chunk, weighted=weighted,
                    cross_amr_only=cross_amr_only,
                )
                trace["dispatch_s"] += time.perf_counter() - t0
                trace["steps"] += 1
                pending.append(buffers[3])
                _drain(inflight)
    _drain(0)
    t0 = time.perf_counter()
    out = _finalize_pairs(buffers, total, pair_format, n_pad)
    trace["finalize_s"] += time.perf_counter() - t0
    global last_grouped_trace
    last_grouped_trace = trace
    return out


def extract_pairs_stream_auto(
    words_host: np.ndarray,
    classes: np.ndarray,
    tile_hits: np.ndarray,
    tiles,
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Volume-based dispatch between the two out-of-core extractors:
    per-tile windows (:func:`extract_pairs_stream`) when hits are sparse
    — upload bound ≈ 2·tile·W·4 per hit tile — and the grouped
    sweep-schedule pass (:func:`extract_pairs_stream_grouped`) when that
    estimate exceeds one full pass over the matrix (the dense-homology
    regime where per-tile windows go transfer-quadratic)."""
    ti, tj, tile = tiles
    want = tile_hits[:, 0] > 0
    if not cross_amr_only:
        want = want | (tile_hits[:, 1] > 0)
    fn = (
        extract_pairs_stream_grouped
        if _prefer_grouped(int(want.sum()), tile, words_host)
        else extract_pairs_stream
    )
    return fn(
        words_host, classes, tile_hits, tiles, n=n, threshold=threshold,
        cross_amr_only=cross_amr_only, weights=weights,
    )


def extract_pairs_stream(
    words_host: np.ndarray,
    classes: np.ndarray,
    tile_hits: np.ndarray,
    tiles,
    n: int,
    threshold: int,
    cross_amr_only: bool = True,
    weights: Optional[np.ndarray] = None,
    batch_budget_bytes: int = 512 << 20,
    inflight: int = 2,
) -> np.ndarray:
    """Pass-2 exact pair recovery for the streaming engine.

    Only the row windows of tiles that reported hits are (re)uploaded —
    ``2 · tile · W · 4`` bytes per hit tile, stacked into batches bounded
    by ``batch_budget_bytes``; at most ``inflight``+1 batches are in
    flight at once (the dispatch queue has no other backpressure).
    Tiles denser than ``TOPK_CAP`` hits take the cumsum+scatter buffer
    instead of ``top_k`` (the in-core extractor's density crossover).
    Weighted mode note: ``_counts_window_pair`` scales its SECOND
    operand at unpack time (the ``ja``-side window) — either operand is
    equivalent (the weight is a per-column scale of the product).
    """
    ti, tj, tile = tiles
    words_host = np.ascontiguousarray(words_host)
    classes = np.asarray(classes, np.int32)
    if classes.shape[0] < words_host.shape[0]:
        classes = np.concatenate(
            [
                classes,
                np.full(words_host.shape[0] - classes.shape[0], -1, np.int32),
            ]
        )
    if len(ti):
        # the sweep's tile enumeration may cover rows beyond the caller's
        # matrix (sweep-side padding to a stream-block multiple)
        n_pad = max(
            (int(max(ti.max(), tj.max())) + 1) * tile, words_host.shape[0]
        )
        words_host, classes = _pad_rows(words_host, classes, n_pad)

    hits_per_tile = tile_hits[:, 0].astype(np.int64)
    want = tile_hits[:, 0] > 0
    if not cross_amr_only:
        want |= tile_hits[:, 1] > 0
        hits_per_tile = hits_per_tile + tile_hits[:, 1]
    hit_tiles = np.nonzero(want)[0]
    if len(hit_tiles) == 0:
        return np.zeros((0, 3), dtype=np.int32)

    weighted = weights is not None
    wts = jnp.asarray(
        weights if weighted else np.ones(words_host.shape[1] * 32, np.int8),
        jnp.int8,
    )
    w_words = words_host.shape[1]
    # the budget bounds the DISTINCT-window stack (worst case 2 windows
    # per tile; typically far fewer — hit tiles share block rows)
    batch = int(
        max(1, min(64, batch_budget_bytes // (2 * tile * w_words * 4)))
    )

    def _stack(gsel):
        """Assemble one batch: distinct row windows once, per-tile
        (ia, ja) window indices — and NO host-side window copies at
        all. Each distinct window ships as a ``device_put`` of the
        contiguous ``words_host`` row slice (a view — zero host RAM
        writes) and the [D, tile, W] operand stack is built ON DEVICE.
        The former per-tile wa/wb numpy duplication wrote ~1 GB per
        bundled extract; this host REWRITES resident pages at a
        measured 10-30 MB/s (cgroup reclaim throttling — slower still
        as process RSS grows), which made that assembly the dominant
        term of the streaming engine's warm pass (22-31 s) and the
        cause of its warm>cold inversion."""
        blocks = sorted(
            {int(ti[t]) for t in gsel} | {int(tj[t]) for t in gsel}
        )
        widx = {b: s for s, b in enumerate(blocks)}
        # pad the window-stack axis to a power-of-two bucket (min 8) so
        # varying distinct-window counts reuse a few compiled shapes;
        # padding entries repeat window 0 (device alias, no traffic)
        dcap = bucket_pow2(max(len(blocks), 1), 8, 2 * batch)
        wins = [
            jax.device_put(words_host[b * tile : (b + 1) * tile])
            for b in blocks
        ]
        wins.extend(wins[0] for _ in range(dcap - len(wins)))
        wstack = _window_stacker(dcap)(*wins)
        cstack = np.full((dcap, tile), -1, np.int32)
        for b, s in widx.items():
            cstack[s] = classes[b * tile : (b + 1) * tile]
        ia = np.zeros(batch, np.int32)
        ja = np.zeros(batch, np.int32)
        gi0s = np.zeros(batch, np.int32)
        gj0s = np.zeros(batch, np.int32)
        valid_t = np.zeros(batch, bool)
        for t, tsel in enumerate(gsel):
            ia[t] = widx[int(ti[tsel])]
            ja[t] = widx[int(tj[tsel])]
            gi0s[t] = int(ti[tsel]) * tile
            gj0s[t] = int(tj[tsel]) * tile
            valid_t[t] = True
        return (
            wstack, jnp.asarray(cstack),
            jnp.asarray(ia), jnp.asarray(ja), wts,
            jnp.asarray(gi0s), jnp.asarray(gj0s), jnp.asarray(valid_t),
            jnp.int32(n), jnp.int32(threshold),
        )

    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _finalize_pairs,
        _new_pair_buffers,
        _vcap_bucket,
    )

    total = int(hits_per_tile[hit_tiles].sum())
    buffers = _new_pair_buffers(_vcap_bucket(total))
    pending = []  # per-batch cursor probes — bounded in-flight window
    trace = {
        "stack_s": 0.0, "dispatch_s": 0.0, "drain_s": 0.0,
        "finalize_s": 0.0, "batches": 0,
        "hit_tiles": int(len(hit_tiles)), "batch": int(batch),
    }

    def _drain(limit):
        # each pending batch holds two [batch, tile, W] operand stacks on
        # device; without this bound the dispatch loop would enqueue
        # every batch's uploads at once (the sweep's probe-window
        # rationale — nothing else backpressures the queue). Survivors
        # accumulate in the on-device global buffers (the pairwise
        # finalize fetches them ONCE, device-sorted — the former
        # per-batch numpy drain cost 70-90 s at 18.6M pairs on this
        # ~85 MB/s-write host), so the probe is just the batch cursor.
        t0 = time.perf_counter()
        while len(pending) > limit:
            jax.device_get(pending.pop(0))
        trace["drain_s"] += time.perf_counter() - t0

    hcounts = hits_per_tile[hit_tiles]
    sparse = hit_tiles[hcounts <= TOPK_CAP]
    dense = hit_tiles[hcounts > TOPK_CAP]
    # sort by hit count so each batch's k bucket fits its tiles tightly
    sparse = sparse[np.argsort(-hits_per_tile[sparse])]

    def _stack_timed(gsel):
        t0 = time.perf_counter()
        out = _stack(gsel)
        trace["stack_s"] += time.perf_counter() - t0
        trace["batches"] += 1
        return out

    for lo in range(0, len(sparse), batch):
        gsel = sparse[lo : lo + batch]
        k = bucket_pow2(hits_per_tile[gsel].max(), 512, tile * tile)
        ops = _stack_timed(gsel)
        t0 = time.perf_counter()
        buffers = _extract_stream_topk(
            *buffers,
            *ops,
            tile=tile, weighted=weighted,
            cross_amr_only=cross_amr_only, k=k,
        )
        trace["dispatch_s"] += time.perf_counter() - t0
        pending.append(buffers[3])
        _drain(inflight)

    if len(dense):
        # ultra-dense tiles (threshold-0 full dumps): the scatter path
        for lo in range(0, len(dense), batch):
            g = dense[lo : lo + batch]
            ops = _stack_timed(np.asarray(g))
            t0 = time.perf_counter()
            buffers = _extract_stream_scatter(
                *buffers,
                *ops,
                tile=tile, weighted=weighted,
                cross_amr_only=cross_amr_only,
            )
            trace["dispatch_s"] += time.perf_counter() - t0
            pending.append(buffers[3])
            _drain(inflight)

    _drain(0)
    t0 = time.perf_counter()
    out = _finalize_pairs(buffers, total)
    trace["finalize_s"] += time.perf_counter() - t0
    global last_extract_trace
    last_extract_trace = trace
    return out
