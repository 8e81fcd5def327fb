"""Batched agglomerative clustering as int8 matmuls — a data-parallel
reformulation of the reference's tree semantics (SURVEY.md §7.4).

The reference's ``src/tree.rs`` inserts proteins one at a time and
greedily merges the two children whose **c-bitarray intersections**
(the AND of all members' k-mer bitsets) overlap the most
(``Node::balance``, src/tree.rs:179-240) — an inherently sequential,
insertion-order-dependent procedure (revived exactly in
``models/tree.py``). This module keeps the same similarity notion —
shared k-mers between cluster intersection signatures — but reorganizes
the control flow for the device:

  * every cluster keeps a packed **intersection signature** (the
    c-bitarray) as one row of a ``[N_pad, W]`` uint32 matrix;
  * each round computes ALL pairwise signature intersection counts in
    one int8 binary matmul (the same machinery as the pair sweep);
  * every **mutual-argmax** pair with count ≥ min_shared merges (the
    batched analogue of balance()'s argmax merge; ties break to the
    lowest index, so the result is deterministic and insertion-order
    free);
  * merged signatures are the AND of the two parents; rounds repeat
    until no pair clears the gate — O(log N) rounds on clustered data
    instead of N sequential insertions.

Returns both a flat partition and the dendrogram (one merge edge per
round entry), i.e. the hierarchical structure the reference's tree
encodes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from uniprot_kmer_based_clustering_tpu.ops.bitmul import unpack_words_to_int8
from uniprot_kmer_based_clustering_tpu.utils.accel import device_memory_budget


@functools.partial(jax.jit, static_argnames=())
def _round_argmax(sigs, active):
    """Per-row best mutual-merge candidate over active signature rows.

    Returns (best_j int32 [N], best_count int32 [N]) with inactive rows
    and the diagonal masked out. One [N, K]·[N, K]ᵀ int8 matmul.
    """
    a = unpack_words_to_int8(sigs)
    counts = jax.lax.dot_general(
        a, a, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32
    )
    npad = counts.shape[0]
    iota = jnp.arange(npad, dtype=jnp.int32)
    # iota compare fuses to zero memory; jnp.eye would pin an [N², 1B]
    # buffer in HBM (~912 MB at the 30k scale)
    ok = (
        active[None, :] & active[:, None] & (iota[:, None] != iota[None, :])
    )
    counts = jnp.where(ok, counts, -1)
    best_j = jnp.argmax(counts, axis=1).astype(jnp.int32)
    best_c = jnp.take_along_axis(counts, best_j[:, None], axis=1)[:, 0]
    return best_j, best_c


@functools.partial(jax.jit, static_argnames=("strip", "word_chunk"))
def _round_argmax_strip(sigs, active, i0, ones_w, *, strip, word_chunk):
    """One row STRIP of the round's argmax — the beyond-bundled-scale
    path. The one-matmul :func:`_round_argmax` unpacks the whole
    ``[N_pad, K]`` int8 operand (27 GB at the 30k/909k-bit design
    point — 11× the bundled dataset, far past HBM); this computes the
    same counts for ``strip`` rows at a time with the sweep's own
    chunked popcount matmul (``ops.bitmul._counts_window_pair``), so
    transients stay bounded by ``strip`` and ``word_chunk``. Identical
    counts (integer matmul sums) ⇒ identical argmax and tie behavior —
    the strip mode's merge sequence is pinned equal to the one-shot
    mode in tests/test_agglomerative.py."""
    from uniprot_kmer_based_clustering_tpu.ops.bitmul import (
        _counts_window_pair,
    )

    sl = jax.lax.dynamic_slice(sigs, (i0, 0), (strip, sigs.shape[1]))
    asl = jax.lax.dynamic_slice(active, (i0,), (strip,))
    counts = _counts_window_pair(sl, sigs, ones_w, word_chunk=word_chunk)
    npad = sigs.shape[0]
    iota = jnp.arange(npad, dtype=jnp.int32)
    gi = i0 + jnp.arange(strip, dtype=jnp.int32)
    ok = active[None, :] & asl[:, None] & (gi[:, None] != iota[None, :])
    counts = jnp.where(ok, counts, -1)
    best_j = jnp.argmax(counts, axis=1).astype(jnp.int32)
    best_c = jnp.take_along_axis(counts, best_j[:, None], axis=1)[:, 0]
    return best_j, best_c


@jax.jit
def _concat_pairs(bjs, bcs):
    """Stack per-strip argmax outputs into one fetch (each fetched
    array pays its own device→host round trip)."""
    return jnp.concatenate(bjs), jnp.concatenate(bcs)


def _round_argmax_any(sigs, active_dev, plan):
    """Round argmax through whichever path ``plan`` selected (see
    :func:`_argmax_plan`): the one-shot matmul, or strip dispatch with
    one concatenated fetch."""
    if plan is None:
        return jax.device_get(_round_argmax(sigs, active_dev))
    strip, word_chunk, ones_w = plan
    n_pad = sigs.shape[0]
    bjs, bcs, ics = [], [], []
    for i0 in range(0, n_pad, strip):
        # the final strip re-covers the tail from n_pad - strip so the
        # kernel's slice never clamps out of step with its gi iota
        # (duplicate rows are overwritten with identical values below)
        ic = min(i0, max(0, n_pad - strip))
        ics.append(ic)
        bj, bc = _round_argmax_strip(
            sigs, active_dev, jnp.int32(ic), ones_w,
            strip=strip, word_chunk=word_chunk,
        )
        bjs.append(bj)
        bcs.append(bc)
    bj_cat, bc_cat = jax.device_get(_concat_pairs(bjs, bcs))
    bj = np.empty(n_pad, np.int32)
    bc = np.empty(n_pad, np.int32)
    for k, ic in enumerate(ics):
        bj[ic : ic + strip] = bj_cat[k * strip : (k + 1) * strip]
        bc[ic : ic + strip] = bc_cat[k * strip : (k + 1) * strip]
    return bj, bc


def _argmax_plan(n_pad: int, w: int, hbm_budget_bytes: int):
    """None (one-shot matmul fits) or (strip, word_chunk, ones) for the
    strip path. The one-shot round materializes the [N_pad, K] int8
    unpack plus the [N_pad, N_pad] counts; past ~half the budget, strip
    so the per-launch transients (strip·K unpack chunk + strip·N_pad
    counts) stay a small budget fraction."""
    if n_pad * w * 32 + n_pad * n_pad * 4 <= hbm_budget_bytes // 2:
        return None
    strip = min(512, n_pad)
    while (
        strip * 2 * n_pad * 4 <= hbm_budget_bytes // 8
        and strip * 2 < n_pad
    ):
        strip *= 2
    word_chunk = 0
    if 2 * n_pad * w * 32 > hbm_budget_bytes // 2:
        target = max(128, hbm_budget_bytes // 2 // (2 * n_pad * 32))
        base = w // 128
        best = 1
        for d in range(1, base + 1):
            if base % d == 0 and d * 128 <= target:
                best = d
        word_chunk = best * 128
    return strip, word_chunk, jnp.ones(w * 32, jnp.int8)


@jax.jit
def _merge_signatures(sigs, partner, is_winner, is_loser):
    """winners absorb their partner (AND), losers zero out.

    Full-width [N_pad] operands — the merge count varies every round, so
    shaped winner/loser index vectors would force one remote compile per
    distinct count; masked full-width updates compile once.
    """
    merged = sigs & sigs[partner]
    sigs = jnp.where(is_winner[:, None], merged, sigs)
    return jnp.where(is_loser[:, None], jnp.uint32(0), sigs)


@dataclass
class AgglomerativeResult:
    labels: np.ndarray        # [n] cluster label (minimum member index)
    merges: np.ndarray        # [M, 3] (winner, loser, shared_count) in order
    rounds: int


def agglomerative_cluster(
    bitset, n: int, min_shared: int = 1, max_rounds: int = 10_000,
    hbm_budget_bytes: Optional[int] = None,
) -> AgglomerativeResult:
    """Cluster `n` proteins by iterative mutual-argmax signature merges.

    `bitset`: a BitsetMatrix (or any object with ``.words`` uint32
    [N_pad, W]). `min_shared`: minimum shared k-mers between the two
    cluster intersection signatures for a merge (the analogue of
    balance()'s "shares any k-mer" gate at 1). Past bundled scale the
    per-round argmax runs in row strips with chunked unpack
    (:func:`_argmax_plan` — the one-shot matmul's int8 operand is
    27 GB at the 30k/909k-bit design point), merge sequence identical.
    """
    if hbm_budget_bytes is None:
        hbm_budget_bytes = device_memory_budget()
    words = np.asarray(bitset.words)
    n_pad, w = words.shape
    plan = _argmax_plan(n_pad, w, hbm_budget_bytes)
    sigs = jnp.asarray(words)
    active_np = np.zeros(n_pad, bool)
    active_np[:n] = True
    parent = np.arange(n_pad, dtype=np.int64)  # union-find for labels

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    merges: List[Tuple[int, int, int]] = []
    rounds = 0
    while rounds < max_rounds:
        rounds += 1
        best_j, best_c = _round_argmax_any(
            sigs, jnp.asarray(active_np), plan
        )
        # mutual argmax pairs over the gate; i < j canonical; ties are
        # deterministic (argmax returns the first maximum)
        i_idx = np.arange(n_pad)
        mutual = (
            active_np
            & (best_c >= min_shared)
            & (best_j[best_j] == i_idx)
            & (i_idx < best_j)
        )
        winners = i_idx[mutual]
        losers = best_j[mutual]
        if winners.size == 0:
            break
        partner = np.arange(n_pad, dtype=np.int32)
        partner[winners] = losers
        is_winner = np.zeros(n_pad, bool)
        is_winner[winners] = True
        is_loser = np.zeros(n_pad, bool)
        is_loser[losers] = True
        sigs = _merge_signatures(
            sigs, jnp.asarray(partner), jnp.asarray(is_winner),
            jnp.asarray(is_loser),
        )
        for w, l, c in zip(winners, losers, best_c[winners]):
            merges.append((int(w), int(l), int(c)))
            parent[find(int(l))] = find(int(w))
        active_np[losers] = False

    labels = np.full(n, -1, np.int32)
    roots: dict = {}
    for i in range(n):
        r = find(i)
        if r not in roots:
            roots[r] = i  # first member = minimum index (ascending scan)
        labels[i] = roots[r]
    return AgglomerativeResult(
        labels=labels,
        merges=np.asarray(merges, np.int64).reshape(-1, 3),
        rounds=rounds,
    )


def agglomerative_cluster_device(
    bitset, n: int, min_shared: int = 1, max_rounds: int = 10_000
) -> AgglomerativeResult:
    """Fully device-resident agglomerative clustering (one jit, zero
    per-round host traffic). Identical output to
    :func:`agglomerative_cluster` — asserted in tests.

    Winner = the lower index of each mutual pair, so a cluster's
    representative is always its minimum member (every merge's winner is
    the smaller of two cluster minima) — labels resolve by on-device
    pointer jumping, no host union-find.
    """
    words = np.asarray(bitset.words)
    n_pad = words.shape[0]
    active = np.zeros(n_pad, bool)
    active[:n] = True
    parent, merges, mcount, rounds = _agglomerate_device_gated(
        jnp.asarray(words), jnp.asarray(active), min_shared, max_rounds
    )
    parent, merges, mcount, rounds = jax.device_get(
        (parent, merges, mcount, rounds)
    )
    labels = parent[:n].astype(np.int32)
    return AgglomerativeResult(
        labels=labels,
        merges=merges[: int(mcount)].astype(np.int64),
        rounds=int(rounds),
    )


@functools.partial(jax.jit, static_argnames=("min_shared", "max_rounds"))
def _agglomerate_device_gated(sigs, active0, min_shared: int, max_rounds: int):
    """min_shared-gated variant (separate jit so the gate is static)."""
    npad = sigs.shape[0]
    iota = jnp.arange(npad, dtype=jnp.int32)

    def cond(state):
        return state[5] & (state[6] < max_rounds)

    def body(state):
        sigs, active, parent, merges, mcount, _, r = state
        a = unpack_words_to_int8(sigs)
        counts = jax.lax.dot_general(
            a, a, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        ok = (
            active[None, :]
            & active[:, None]
            & (iota[:, None] != iota[None, :])
        )
        counts = jnp.where(ok, counts, -1)
        best_j = jnp.argmax(counts, axis=1).astype(jnp.int32)
        best_c = jnp.take_along_axis(counts, best_j[:, None], axis=1)[:, 0]
        m = (
            active
            & (best_c >= min_shared)
            & (best_j[best_j] == iota)
            & (iota < best_j)
        )
        merged = sigs & sigs[best_j]
        sigs = jnp.where(m[:, None], merged, sigs)
        loser_idx = jnp.where(m, best_j, npad)
        active = active.at[loser_idx].set(False, mode="drop")
        parent = parent.at[loser_idx].set(iota, mode="drop")
        pos = jnp.where(m, mcount + jnp.cumsum(m.astype(jnp.int32)) - 1, npad)
        rows = jnp.stack([iota, best_j, best_c], axis=1).astype(jnp.int32)
        merges = merges.at[pos].set(rows, mode="drop")
        nmerge = jnp.sum(m.astype(jnp.int32))
        return (
            sigs, active, parent, merges, mcount + nmerge,
            nmerge > 0, r + 1,
        )

    state = (sigs, active0, iota, jnp.zeros((npad, 3), jnp.int32),
             jnp.int32(0), jnp.bool_(True), jnp.int32(0))
    sigs, active, parent, merges, mcount, _, rounds = jax.lax.while_loop(
        cond, body, state
    )

    def pj_body(s):
        p, _ = s
        p2 = p[p]
        return p2, jnp.any(p2 != p)

    parent, _ = jax.lax.while_loop(
        lambda s: s[1], pj_body, (parent, jnp.bool_(True))
    )
    return parent, merges, mcount, rounds
