"""Sharded OUT-OF-CORE sweep: the stream engine composed with a mesh.

The last cell of the {in-core, out-of-core} × {1 device, mesh}
capability matrix. Every mesh engine in ``parallel/sharded.py`` keeps
each device's full dense row shard resident in HBM, and the stream
engine (``ops/stream.py``) is single-device — so a corpus beyond
*aggregate* mesh HBM had no path. This module runs the stream engine's
stationary-group / moving-block schedule on every device of a mesh at
once, over disjoint block-pair sets:

* the **CSR incidence staging** (~0.02% of the dense volume at the
  beyond-HBM design points — the 19 GiB 7-mer/100k matrix is a ~270 MB
  CSR) is **replicated** over the mesh; the dense matrix never exists
  anywhere, so the corpus bound is per-device HBM for the *staging*,
  not for the matrix — beyond-aggregate-HBM corpora work by
  construction;
* each stationary group's stack is built **cooperatively**: every
  device scatter-materializes ``g/D`` blocks and one ``all_gather``
  (ICI) replicates the ``[g, bs, W]`` stack;
* the group's moving-block list is split into **per-device contiguous
  segments balanced by step weight** (the triangular ramp means block
  ``jb`` costs ``min(g, jb−s0+1)`` steps); each device runs the
  single-chip scan-chunk program (``ops.stream._scan_chunk_body`` —
  the SAME body, so the engines cannot drift) over its own segment via
  ``shard_map``, accumulating into per-device donated stats and pair
  buffers;
* the only other communication is the end-of-sweep merge: row stats
  reduce with the canonical lane rule (lanes %4==3 by max, others by
  sum — ``ops.bitmul.merge_row_stats_at``'s contract), block hits sum,
  and the per-device pair buffers are masked + globally sorted by
  (i, j) in one device program.

Why work partitioning instead of the ring?  The rings rotate *data*
because each device can only hold its own shard; here every device can
materialize ANY block from the replicated sparse staging, so the
communication-optimal schedule is embarrassingly parallel block-pair
partitioning — zero steady-state collectives (the stack all_gather is
``g·bs·W·4`` bytes per group over ICI) versus a ppermute per ring step.
Integer sums/maxes are associative and commutative, so ANY
deterministic partition yields bit-identical statistics, and the final
canonical (i, j) sort makes the pair list partition-invariant —
bit-identity for every device count is by construction (pinned in
tests/test_stream_mesh.py for D ∈ {1, 2, 4, 8}).

Known limit (shared with the single-chip engine, DESIGN.md): the
replicated staging must fit per-device HBM alongside the working set —
at ~18 B/incidence that binds only past ~10⁹ set bits (≈ 30× the 19 GiB
design point). Past that, shard the staging by row range and ring-rotate
materialized blocks (not implemented — no supported corpus approaches
it).

The reference has no counterpart at any scale: its whole 258M-edge
multigraph lives in one 512 GB RAM envelope (run.sh:6-12); its declared
7-mer scaling axis (src/tree.rs:96-105) is what this module serves.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from uniprot_kmer_based_clustering_tpu.ops.stream import (
    CSRBlockSource,
    _materialize_block,
    _scan_chunk_body,
    auto_stream_block,
    split_incidence_blocks,
)
from uniprot_kmer_based_clustering_tpu.utils.accel import device_memory_budget

try:  # jax >= 0.6 exports shard_map at the top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


#: Phase breakdown of the most recent :func:`sweep_extract_stream_mesh`
#: call — the single-chip engine's trace fields plus the mesh shape and
#: the per-device step balance of the partition.
last_mesh_trace: dict = {}


def _segment_bounds(weights: np.ndarray, d: int) -> np.ndarray:
    """Split a weighted sequence into ``d`` contiguous segments of
    near-equal total weight (the moving-block partition of one
    stationary group). Returns ``d+1`` monotone cut indices; segments
    may be empty when there are fewer items than devices."""
    cum = np.concatenate([[0], np.cumsum(weights, dtype=np.int64)])
    targets = cum[-1] * np.arange(1, d, dtype=np.int64) // d
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cuts, [len(weights)]])
    return np.maximum.accumulate(bounds)


@functools.lru_cache(maxsize=64)
def _make_stack_builder(mesh: Mesh, axis: str, bs: int, w: int, gpd: int):
    """Cooperative stationary-stack build: device ``k`` materializes
    blocks ``s0 + k·gpd .. s0 + (k+1)·gpd`` from the replicated CSR
    staging, one ``all_gather`` replicates the ``[gpd·D, bs, w]`` stack.
    Indices past the staging clamp to its last block — those entries are
    never read (``tc``/``gh`` gating, the single-chip stack's idiom)."""

    def body(rows_a, ranks_a, valid_a, s0):
        dev = jax.lax.axis_index(axis)
        nbk = rows_a.shape[0]

        def one(_, t):
            b = jnp.minimum(s0 + dev * gpd + t, nbk - 1)
            return None, _materialize_block(
                rows_a, ranks_a, valid_a, b, bs=bs, w=w
            )

        _, sub = jax.lax.scan(
            one, None, jnp.arange(gpd, dtype=jnp.int32)
        )
        return jax.lax.all_gather(sub, axis, axis=0, tiled=True)

    return jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(P(None, None), P(None, None), P(None, None), P()),
            out_specs=P(None, None, None),
            # the all_gather output IS replicated, but the vma checker
            # cannot statically infer it on this jax version
            check_vma=False,
        )
    )


@functools.lru_cache(maxsize=64)
def _make_mesh_chunk(
    mesh: Mesh, axis: str, bs: int, w: int, g: int, n: int,
    threshold: int, block: int, w_thresh: int, word_chunk: int,
    cross_amr_only: bool,
):
    """One round of the mesh sweep as ONE program: every device runs
    the scan-chunk body over ITS ``[C]`` moving-block list against the
    shared (replicated) stationary stack, updating its own donated
    accumulators/pair buffers. The extra replicated ``probe`` output
    (psum of the local cursors) is the in-flight window's one fetched
    scalar — addressable on every process, so the drain works
    multi-host too."""

    def body(row_stats, block_hits, gbi, gbj, gbc, cursor,
             stack, rows_a, ranks_a, valid_a, classes_pad, weights,
             jb_arr, tc_arr, s0, gh):
        state = (
            row_stats[0], block_hits[0], gbi[0], gbj[0], gbc[0],
            cursor[0],
        )
        state = _scan_chunk_body(
            state, stack, rows_a, ranks_a, valid_a, classes_pad,
            weights, jb_arr[0], tc_arr[0], s0, gh,
            bs=bs, w=w, g=g, n=n, threshold=threshold, block=block,
            w_thresh=w_thresh, word_chunk=word_chunk,
            cross_amr_only=cross_amr_only,
        )
        probe = jax.lax.psum(state[5], axis)
        return tuple(x[None] for x in state) + (probe,)

    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(axis, None, None), P(axis, None, None, None),
            P(axis, None), P(axis, None), P(axis, None), P(axis),
            P(None, None, None),
            P(None, None), P(None, None), P(None, None),
            P(None), P(None),
            P(axis, None), P(axis, None), P(), P(),
        ),
        out_specs=(
            P(axis, None, None), P(axis, None, None, None),
            P(axis, None), P(axis, None), P(axis, None), P(axis),
            P(),
        ),
    )
    return jax.jit(sharded, donate_argnums=(0, 1, 2, 3, 4))


@functools.lru_cache(maxsize=None)
def _make_state_init(mesh: Mesh, axis: str, d: int, n_pad: int, nb: int,
                     vcap_l: int):
    """Device-side state allocation (host-materializing multi-GB
    sentinel buffers and uploading them would add a needless
    host→device transfer at the beyond-memory design points)."""
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _IMAX,
    )

    def init():
        return (
            jnp.zeros((d, n_pad, 8), jnp.int32),
            jnp.zeros((d, nb, nb, 2), jnp.int32),
            jnp.full((d, vcap_l), _IMAX, jnp.int32),
            jnp.full((d, vcap_l), _IMAX, jnp.int32),
            jnp.full((d, vcap_l), -1, jnp.int32),
            jnp.zeros((d,), jnp.int32),
        )

    sh = lambda *spec: NamedSharding(mesh, P(*spec))  # noqa: E731
    return jax.jit(
        init,
        out_shardings=(
            sh(axis, None, None), sh(axis, None, None, None),
            sh(axis, None), sh(axis, None), sh(axis, None), sh(axis),
        ),
    )


@functools.lru_cache(maxsize=None)
def _make_merge_stats(mesh: Mesh):
    """Cross-device stats merge with the canonical lane rule (lanes
    %4==3 by max, others by sum — merge_row_stats_at's contract); block
    hits and cursors ride along replicated so one fetch serves every
    process."""

    def fin(row_stats, block_hits, cursor):
        lanes8 = jnp.arange(8)[None, :]
        rs = jnp.where(
            lanes8 % 4 == 3,
            row_stats.max(axis=0),
            row_stats.sum(axis=0),
        )
        return rs, block_hits.sum(axis=0), cursor

    sh = lambda *spec: NamedSharding(mesh, P(*spec))  # noqa: E731
    return jax.jit(
        fin,
        out_shardings=(sh(None, None), sh(None, None, None), sh(None)),
    )


@functools.lru_cache(maxsize=None)
def _make_finalize(mesh: Mesh, packed: bool):
    """Global pair finalize: mask each device's unoccupied tail to the
    shared sentinels, flatten the ``[D, V]`` buffers, and sort
    canonically by (i, j) — the single-chip finalize's convention
    (``similarity.pairwise._sort_pairs`` / the packed int64 sort), with
    the output replicated so the host fetch is addressable anywhere."""
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _IMAX,
        _pack_sort_pairs_x64,
        _sort_pairs,
    )

    def _mask_flat(gbi, gbj, gbc, cursor):
        live = (
            jnp.arange(gbi.shape[1], dtype=jnp.int32)[None, :]
            < cursor[:, None]
        )
        return (
            jnp.where(live, gbi, _IMAX).reshape(-1),
            jnp.where(live, gbj, _IMAX).reshape(-1),
            jnp.where(live, gbc, -1).reshape(-1),
        )

    sh = lambda *spec: NamedSharding(mesh, P(*spec))  # noqa: E731
    if packed:
        def fin(gbi, gbj, gbc, cursor):
            bi, bj, bc = _mask_flat(gbi, gbj, gbc, cursor)
            return _pack_sort_pairs_x64(bi, bj, bc)

        return jax.jit(fin, out_shardings=(sh(None), sh()))

    def fin(gbi, gbj, gbc, cursor):
        return _sort_pairs(*_mask_flat(gbi, gbj, gbc, cursor))

    return jax.jit(fin, out_shardings=sh(None, None))


def sweep_extract_stream_mesh(
    mesh: Mesh,
    classes: np.ndarray,
    n: int,
    threshold: int,
    *,
    block_source: CSRBlockSource,
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
    scan_chunk: int = 8,
    pair_format: str = "arr3",
    checkpoint_store=None,
    checkpoint_key: Optional[str] = None,
    fail_after_groups: Optional[int] = None,
):
    """ONE-PASS out-of-core sweep **and** exact pair extraction over a
    device mesh — the sharded :func:`ops.stream.sweep_extract_stream`.

    ``hbm_budget_bytes`` is PER DEVICE (the cap every blocking decision
    respects); ``cap`` bounds each device's pair buffer (the test seam
    for the capacity-miss redo — on a miss the pair list is redone by
    the single-device grouped extractor from the exact tile hits, so
    the result is identical in every regime). ``block_source`` supplies
    the host incidence lists; its single-device staging is NOT used —
    the per-block split is re-staged replicated over the mesh.

    Returns the engine-agnostic ``(row_stats int64 [N_pad', 8],
    tile_hits int32 [nT, 2], (ti, tj, block), pairs)`` with ``pairs``
    int32 [M, 3] — or packed int64 [M] when
    ``pair_format="packed"`` fits (callers distinguish by ``ndim``).
    Bit-identical to the single-chip stream engines for every device
    count.

    **Group-boundary checkpointing** (``checkpoint_store`` +
    ``checkpoint_key``): the single-chip engine's contract
    (ops.stream.sweep_extract_stream docstring), mesh-adapted — at
    every completed group the CUMULATIVE merged stats (replicated
    merge + one ~4 MB fetch) and completed-group list persist; a
    resumed run keeps the restored stats on the HOST (the per-device
    accumulators stay zero-initialized — integer lane merges compose,
    so prior + this-run merge exactly at the end), skips completed
    groups, and recovers their pairs from the checkpointed tile hits
    via the single-device grouped extractor. Snapshots are
    geometry-compatible with the single-chip engine's (identical
    layout and semantics), so a pass may even resume across engines.
    ``fail_after_groups`` is the fault-injection seam.
    """
    if hbm_budget_bytes is None:
        hbm_budget_bytes = device_memory_budget()
    assert len(mesh.axis_names) == 1, (
        "stream-mesh composition runs on a flat mesh (one axis); "
        f"got {mesh.axis_names}"
    )
    axis = mesh.axis_names[0]
    d = int(mesh.devices.size)
    rows0, w_words = block_source.n_rows, block_source.w_words
    classes = np.asarray(classes, np.int32)
    if classes.shape[0] < rows0:
        classes = np.concatenate(
            [classes, np.full(rows0 - classes.shape[0], -1, np.int32)]
        )

    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _vcap_bucket,
    )

    if cap is None:
        cap_dev = max(1, min(
            int(hbm_budget_bytes // 8 // 12), n * (n - 1) // 2
        ))
        vcap = _vcap_bucket(cap_dev)
    else:
        # explicit per-device caps honored near-exactly (128-row
        # granularity) — the capacity-miss path must be reachable
        vcap = max(128, -(-int(cap) // 128) * 128)
    slack = int(bs) ** 2 if bs else 4096 * 4096
    src_bytes = 18 * max(1, block_source._p.shape[0])
    budget = max(
        1 << 28, hbm_budget_bytes - 3 * (vcap + slack) * 4 - src_bytes
    )
    if bs is None:
        bs = auto_stream_block(rows0, w_words, block, budget)
    assert bs % block == 0, "stream block must be a multiple of the tile"
    n_pad = -(-rows0 // bs) * bs
    if classes.shape[0] < n_pad:
        classes = np.concatenate(
            [classes, np.full(n_pad - classes.shape[0], -1, np.int32)]
        )
    nb = n_pad // block
    nbk = n_pad // bs

    block_bytes = bs * w_words * 4
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
    if g > d:
        # round DOWN to a device-count multiple so the cooperative
        # stack holds exactly g blocks — a gpd·D > g stack would pin up
        # to D−1 un-budgeted blocks of replicated HBM (~2 GB at the
        # 19 GiB design point's block size with D=8)
        g = (g // d) * d
    gpd = -(-g // d)  # blocks built per device; stack holds gpd·D ≥ g
    # inherent floor of the cooperative build: every device contributes
    # ≥1 block, so the replicated stack holds ≥ D blocks even when the
    # budget affords fewer — per-device HBM must fit D stream blocks
    # (shrink bs if that binds; it never does at the supported scales)

    if word_chunk is None:
        word_chunk = 0
        if 2 * bs * w_words * 32 > avail // 2:
            target = max(128, avail // 2 // (2 * bs * 32))
            base = w_words // 128
            best = 1
            for dd in range(1, base + 1):
                if base % dd == 0 and dd * 128 <= target:
                    best = dd
            word_chunk = best * 128

    # replicated staging: the per-block split (the single splitter the
    # single-chip CSRBlockSource uses) + classes + weights, all P(None)
    rep2 = NamedSharding(mesh, P(None, None))
    rep1 = NamedSharding(mesh, P(None))
    t0 = time.perf_counter()
    rows_h, ranks_h, valid_h = split_incidence_blocks(
        block_source._p, block_source._r, bs, nbk
    )
    rows_a = jax.device_put(rows_h, rep2)
    ranks_a = jax.device_put(ranks_h, rep2)
    valid_a = jax.device_put(valid_h, rep2)
    classes_dev = jax.device_put(classes[:n_pad], rep1)
    wts = jax.device_put(
        np.asarray(
            weights if weights is not None
            else np.ones(w_words * 32, np.int8),
            np.int8,
        ),
        rep1,
    )
    stage_s = time.perf_counter() - t0

    # checkpoint restore (single-chip-compatible snapshot layout; see
    # ops.stream.sweep_extract_stream): cumulative stats stay on the
    # HOST — the zero per-device accumulators merge with them exactly
    # at the end (integer lane merges compose)
    import os as _os
    import zlib as _zlib

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
    prior_rs = None
    prior_bh = None
    if ckpt_on:
        snap = checkpoint_store.load(checkpoint_key)
        if snap is not None and np.array_equal(
            snap.get("geometry"), ckpt_geo
        ):
            prior_groups = {int(x) for x in snap["groups_done"]}
            prior_rs = snap["row_stats"]
            prior_bh = snap["block_hits"]
    done_groups = set(prior_groups)
    groups_this_run = 0

    def _merge_host(rs_a, bh_a, rs_b, bh_b):
        """Host-side lane-rule merge (merge_row_stats_at's contract)."""
        lanes8 = np.arange(8)[None, :]
        rs = np.where(
            lanes8 % 4 == 3, np.maximum(rs_a, rs_b), rs_a + rs_b
        ).astype(np.int32)
        return rs, bh_a + bh_b

    vcap_l = vcap + bs * bs  # + one sort-append slack window per device
    state = _make_state_init(mesh, axis, d, n_pad, nb, vcap_l)()
    chunk_fn = _make_mesh_chunk(
        mesh, axis, bs, w_words, g, n, threshold, block, w_thresh,
        word_chunk, cross_amr_only,
    )
    stack_builder = _make_stack_builder(mesh, axis, bs, w_words, gpd)
    jb_sh = NamedSharding(mesh, P(axis, None))

    pending = []
    trace = {
        "stage_s": stage_s, "dispatch_s": 0.0, "drain_s": 0.0,
        "fetch_s": 0.0, "steps": 0, "uploads": 0, "launches": 0,
        "bs": int(bs), "g": int(g), "nbk": int(nbk), "d": d,
        "word_chunk": int(word_chunk), "vcap": int(vcap),
        "overflow": False, "scan_chunk": int(scan_chunk),
    }

    def _drain(limit):
        t0 = time.perf_counter()
        if len(pending) > limit:
            newest = pending[len(pending) - limit - 1]
            del pending[: len(pending) - limit]
            jax.device_get(newest)
        trace["drain_s"] += time.perf_counter() - t0

    def _group_boundary(s0):
        """Post-group checkpoint: settle the queue, merge + fetch the
        (small) cumulative stats, persist, fire the fault seam."""
        nonlocal groups_this_run
        if not ckpt_on:
            return
        _drain(0)
        t0 = time.perf_counter()
        rs_c, bh_c, _ = jax.device_get(
            _make_merge_stats(mesh)(state[0], state[1], state[5])
        )
        if prior_rs is not None:
            rs_c, bh_c = _merge_host(prior_rs, prior_bh, rs_c, bh_c)
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
                f"stream-mesh checkpoint fault injection: killed after "
                f"{groups_this_run} group(s)"
            )

    # host schedule: per group, per-device contiguous moving-block
    # segments balanced by step weight; saved for the post-hoc
    # per-device expected-count check
    group_bounds: dict = {}
    dev_steps = np.zeros(d, np.int64)  # partition balance diagnostic
    stack = None
    for s0 in range(0, nbk, g):
        if s0 in prior_groups:
            continue  # checkpoint resume: group already swept
        g_here = min(g, nbk - s0)
        if stack is not None:
            # release the previous group's stack BEFORE building the
            # next (two stacks coexisting would bust the budget);
            # drain first so no in-flight chunk still reads it
            stack = None
            _drain(0)
        t0 = time.perf_counter()
        stack = stack_builder(
            rows_a, ranks_a, valid_a, jnp.int32(s0)
        )
        trace["dispatch_s"] += time.perf_counter() - t0
        trace["uploads"] += gpd * d
        trace["launches"] += 1

        jbs = np.arange(s0, nbk, dtype=np.int32)
        wsched = np.minimum(g_here, jbs - s0 + 1).astype(np.int64)
        bounds = _segment_bounds(wsched, d)
        group_bounds[s0] = (bounds, jbs)
        seg_chunks = []
        for k in range(d):
            seg = jbs[bounds[k] : bounds[k + 1]]
            dev_steps[k] += wsched[bounds[k] : bounds[k + 1]].sum()
            seg_chunks.append(
                [seg[i : i + scan_chunk]
                 for i in range(0, len(seg), scan_chunk)]
            )
        rounds = max((len(c) for c in seg_chunks), default=0)
        for r in range(rounds):
            jb_mat = np.zeros((d, scan_chunk), np.int32)
            tc_mat = np.zeros((d, scan_chunk), np.int32)
            for k in range(d):
                if r < len(seg_chunks[k]):
                    seg = seg_chunks[k][r]
                    jb_mat[k, : len(seg)] = seg
                    tc_mat[k, : len(seg)] = np.minimum(
                        g_here, seg - s0 + 1
                    )
            t0 = time.perf_counter()
            out = chunk_fn(
                *state, stack,
                rows_a, ranks_a, valid_a, classes_dev, wts,
                jax.device_put(jb_mat, jb_sh),
                jax.device_put(tc_mat, jb_sh),
                jnp.int32(s0), jnp.int32(g_here),
            )
            state, probe = out[:6], out[6]
            trace["dispatch_s"] += time.perf_counter() - t0
            trace["steps"] += int(tc_mat.sum())
            # in-scan moving-block materializations (blocks outside the
            # resident group), for the uploads accounting
            trace["uploads"] += int(
                ((jb_mat - s0 >= g_here) & (tc_mat > 0)).sum()
            )
            trace["launches"] += 1
            pending.append(probe)
            if len(pending) > 2 * inflight:
                _drain(inflight)
        _group_boundary(s0)
    _drain(0)
    trace["balance"] = (
        float(dev_steps.min() / max(1, dev_steps.max()))
        if trace["steps"] else 1.0
    )

    row_stats, block_hits, gbi, gbj, gbc, cursor = state
    t0 = time.perf_counter()
    rs_m, bh_m, cur_m = _make_merge_stats(mesh)(
        row_stats, block_hits, cursor
    )
    rs, bh, cursors = jax.device_get((rs_m, bh_m, cur_m))
    trace["fetch_s"] += time.perf_counter() - t0
    if prior_rs is not None:
        # checkpoint resume: fold the restored cumulative stats in
        # (this run's accumulators covered only the remaining groups)
        rs, bh = _merge_host(prior_rs, prior_bh, rs, bh)

    from uniprot_kmer_based_clustering_tpu.ops.popcount import (
        upper_triangle_tiles,
    )

    ti, tj = upper_triangle_tiles(n_pad, block)
    tile_hits = bh[ti, tj]
    tiles = (ti, tj, block)
    hits = tile_hits[:, 0].astype(np.int64)
    if not cross_amr_only:
        hits = hits + tile_hits[:, 1]
    total = int(hits.sum())

    # per-device expected survivor counts from the sweep's own exact
    # tile hits mapped through the partition (tile → bs-block pair →
    # owning group → segment owner) — exact at any scale, like the
    # single-chip engine's int64 overflow decision. Tiles owned by
    # checkpoint-restored groups were not compacted this run; their
    # survivors are recovered by the grouped extractor below.
    nsb = bs // block
    ib_arr = ti // nsb
    jb_arr = tj // nsb
    expected = np.zeros(d, np.int64)
    total_prior = 0
    prior_mask = np.zeros(len(ti), bool)
    sel = hits > 0
    for t in np.nonzero(sel)[0]:
        ib, jb = int(ib_arr[t]), int(jb_arr[t])
        s0 = (ib // g) * g
        if s0 in prior_groups:
            total_prior += int(hits[t])
            prior_mask[t] = True
            continue
        bounds, jbs = group_bounds[s0]
        # jbs = arange(s0, nbk): the index of jb is jb - s0; its owner
        # is the segment [bounds[k], bounds[k+1]) containing it (empty
        # segments repeat a bound — side="right" skips them)
        owner = int(np.searchsorted(bounds, jb - s0, side="right")) - 1
        expected[min(owner, d - 1)] += int(hits[t])
    assert expected.sum() + total_prior == total
    if prior_groups:
        trace["groups_skipped"] = len(prior_groups)

    if (expected > vcap).any():
        # capacity miss: redo the pair list with the exact tile hits
        # through the single-device grouped extractor (one more pass)
        trace["overflow"] = True
        from uniprot_kmer_based_clustering_tpu.ops.stream import (
            extract_pairs_stream_grouped,
        )

        pairs = extract_pairs_stream_grouped(
            None, classes, tile_hits, tiles, n=n,
            threshold=threshold, cross_amr_only=cross_amr_only,
            weights=weights, hbm_budget_bytes=hbm_budget_bytes,
            inflight=inflight, block_source=block_source,
            bs=bs, word_chunk=word_chunk, max_group=max_group,
            pair_format=pair_format,
        )
    else:
        if not np.array_equal(cursors.astype(np.int64), expected):
            raise AssertionError(
                f"stream-mesh compacted {cursors.tolist()} pairs per "
                f"device, sweep stats promised {expected.tolist()}"
            )
        t0 = time.perf_counter()
        pairs = _fetch_mesh_pairs(
            mesh, gbi, gbj, gbc, cur_m, total - total_prior,
            pair_format, n_pad,
        )
        trace["fetch_s"] += time.perf_counter() - t0
        trace["pair_format"] = "packed" if pairs.ndim == 1 else "arr3"
        if total_prior:
            # resume merge: recover the checkpointed groups' pairs from
            # their exact tile hits (the single-chip engine's idiom) and
            # canonicalize the union
            from uniprot_kmer_based_clustering_tpu.ops.stream import (
                extract_pairs_stream_grouped,
            )

            masked = np.zeros_like(tile_hits)
            masked[prior_mask] = tile_hits[prior_mask]
            prior_pairs = extract_pairs_stream_grouped(
                None, classes, masked, tiles, n=n,
                threshold=threshold, cross_amr_only=cross_amr_only,
                weights=weights, hbm_budget_bytes=hbm_budget_bytes,
                inflight=inflight, block_source=block_source,
                bs=bs, word_chunk=word_chunk, max_group=max_group,
                pair_format=pair_format,
            )
            if pairs.ndim == 1 and prior_pairs.ndim == 1:
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
        p = checkpoint_store.path(checkpoint_key)
        if p and _os.path.exists(p):
            _os.remove(p)
    global last_mesh_trace
    last_mesh_trace = trace
    return rs.astype(np.int64), tile_hits, tiles, pairs


def _fetch_mesh_pairs(mesh, gbi, gbj, gbc, cursor, total: int,
                      pair_format: str, n_rows: int) -> np.ndarray:
    """Sort + prefix-slice + fetch the canonical pair list from the
    per-device buffers (the mesh analogue of
    ``similarity.pairwise._fetch_sorted_pairs``): packed int64 when the
    ranges fit — the count-range check rides the same fetch as a
    trailing lane — else the [M, 3] int32 fallback."""
    from uniprot_kmer_based_clustering_tpu.similarity.pairwise import (
        _PACK_COUNT_LIMIT,
        _PACK_ROW_LIMIT,
    )

    if pair_format == "packed" and n_rows < _PACK_ROW_LIMIT:
        with jax.enable_x64(True):
            sorted_p, mx = _make_finalize(mesh, True)(
                gbi, gbj, gbc, cursor
            )
            arr = jax.device_get(
                jnp.concatenate([sorted_p[:total], mx[None]])
            )
        if int(arr[total]) < _PACK_COUNT_LIMIT:
            return arr[:total]
    sorted_dev = _make_finalize(mesh, False)(gbi, gbj, gbc, cursor)
    if sorted_dev.shape[0] - total > (1 << 20):
        sorted_dev = sorted_dev[:total]
    return np.asarray(jax.device_get(sorted_dev)[:total])
