"""Batched Smith-Waterman scoring on the device (Gotoh affine gaps, BLOSUM62).

The reference shells out to diamond per pair — one subprocess pair per
edge per thread (src/graph/mod.rs:266-293, P9 in SURVEY.md §2.3, which
names a device alignment kernel as the stretch goal of a device-native
equivalent). Here the whole pair batch aligns in ONE device program:

  * pairs are padded into [B, Lq] / [B, Ls] residue-index matrices;
  * one ``lax.scan`` walks query rows; each step is vector work on
    [B, Ls] lanes (elementwise adds/maxes/selects, no matmul);
  * the horizontal-gap recurrence E[j] = max(E[j-1]−1, H'[j-1]−open) —
    sequential along the row — is linearized to a single ``cummax``:
    E[j] = cummax(H'[k] + k) − open − (j−1), so every DP cell costs
    O(1) vector ops and the row stays data-parallel;
  * the kernel returns max score + END coordinates per pair. START
    coordinates come from a second pass over the reversed sequences
    (the classic two-pass trick: the reverse alignment's end is the
    forward alignment's start), so no [Lq, Ls] matrices ever
    materialize — HBM per pair is O(Ls), and a million-pair batch is
    just more rows.

Exact-DP parity with :func:`align.sw_host.sw_align_host` is asserted in
tests/test_sw.py; the host oracle does traceback only for pairs that
reach the output.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from uniprot_kmer_based_clustering_tpu.align.sw_host import (
    GAP_EXTEND,
    GAP_OPEN,
)
from uniprot_kmer_based_clustering_tpu.utils.blosum import blosum62_matrix

_NEG = jnp.int32(-(10**6))


@functools.partial(jax.jit, static_argnames=())
def _sw_scan(q_idx, q_len, s_idx, s_len, matrix):
    """(scores [B], q_end [B], s_end [B]) — 1-based inclusive ends."""
    b, lq = q_idx.shape
    ls = s_idx.shape[1]
    jcol = jnp.arange(ls, dtype=jnp.int32)
    s_valid = jcol[None, :] < s_len[:, None]

    def step(carry, xs):
        h_prev, f_prev, best, best_i, best_j = carry
        qi, i = xs  # qi: [B] residue at row i (0-based)
        sub = matrix[qi[:, None], s_idx]  # [B, Ls]
        sub = jnp.where(
            s_valid & (i < q_len)[:, None], sub, _NEG
        )
        f_cur = jnp.maximum(h_prev - GAP_OPEN, f_prev - GAP_EXTEND)
        diag = jnp.pad(h_prev[:, :-1], ((0, 0), (1, 0))) + sub
        h_nf = jnp.maximum(0, jnp.maximum(diag, f_cur))
        # E[j] = cummax_k<j (H'[k] + k) − open − (j − 1)
        run = jax.lax.cummax(h_nf + jcol[None, :], axis=1)
        e = (
            jnp.pad(run[:, :-1], ((0, 0), (1, 0)), constant_values=_NEG)
            - GAP_OPEN
            - jnp.maximum(jcol[None, :] - 1, 0)
        )
        h = jnp.maximum(h_nf, e)
        # zero out padding so F/E never propagate out of the valid
        # [q_len, s_len] region (rows/columns past the boundary would
        # otherwise inherit positive gap states)
        valid = s_valid & (i < q_len)[:, None]
        h = jnp.where(valid, h, 0)
        f_cur = jnp.where(valid, f_cur, _NEG)
        row_best = jnp.max(h, axis=1)
        row_arg = jnp.argmax(h, axis=1).astype(jnp.int32)
        better = row_best > best
        best = jnp.where(better, row_best, best)
        best_i = jnp.where(better, i + 1, best_i)  # 1-based
        best_j = jnp.where(better, row_arg + 1, best_j)
        return (h, f_cur, best, best_i, best_j), None

    h0 = jnp.zeros((b, ls), jnp.int32)
    f0 = jnp.full((b, ls), _NEG, jnp.int32)
    z = jnp.zeros((b,), jnp.int32)
    xs = (q_idx.T.astype(jnp.int32), jnp.arange(lq, dtype=jnp.int32))
    (h, f, best, best_i, best_j), _ = jax.lax.scan(
        step, (h0, f0, z, z, z), xs
    )
    return best, best_i, best_j


def sw_scores_device(
    q_idx: np.ndarray,
    q_len: np.ndarray,
    s_idx: np.ndarray,
    s_len: np.ndarray,
):
    """Batched local-alignment scores + 1-based end coordinates.

    q_idx [B, Lq] / s_idx [B, Ls]: residue indices (0..20), padded
    arbitrarily past q_len/s_len (padding is masked).
    """
    matrix = jnp.asarray(blosum62_matrix(), jnp.int32)
    best, qi, sj = _sw_scan(
        jnp.asarray(q_idx),
        jnp.asarray(q_len, jnp.int32),
        jnp.asarray(s_idx),
        jnp.asarray(s_len, jnp.int32),
        matrix,
    )
    return jax.device_get((best, qi, sj))


def sw_ends_and_starts_device(q_idx, q_len, s_idx, s_len):
    """(score, q_start, q_end, s_start, s_end), all [B], 1-based.

    Two passes: forward gives ends; the same kernel over the reversed
    sequences gives starts (start = len + 1 − reverse_end). Caveat:
    with multiple co-optimal alignments the two passes may pick ends of
    different ones (scores still agree, asserted); output-field
    generation therefore uses the host traceback, which is internally
    consistent by construction.
    """
    q_idx = np.asarray(q_idx)
    s_idx = np.asarray(s_idx)
    q_len = np.asarray(q_len, np.int64)
    s_len = np.asarray(s_len, np.int64)

    def rev(mat, lens):
        out = np.zeros_like(mat)
        for r in range(mat.shape[0]):
            L = int(lens[r])
            out[r, :L] = mat[r, :L][::-1]
        return out

    # the reverse pass depends only on the inputs — dispatch BOTH passes
    # before any fetch and read all six arrays in ONE device_get (one
    # synchronizing readback per batch instead of two)
    matrix = jnp.asarray(blosum62_matrix(), jnp.int32)
    fwd = _sw_scan(
        jnp.asarray(q_idx), jnp.asarray(q_len, jnp.int32),
        jnp.asarray(s_idx), jnp.asarray(s_len, jnp.int32), matrix,
    )
    bwd = _sw_scan(
        jnp.asarray(rev(q_idx, q_len)), jnp.asarray(q_len, jnp.int32),
        jnp.asarray(rev(s_idx, s_len)), jnp.asarray(s_len, jnp.int32),
        matrix,
    )
    (score, q_end, s_end), (score_r, q_end_r, s_end_r) = jax.device_get(
        (fwd, bwd)
    )
    assert (score_r == score).all(), "forward/reverse score mismatch"
    q_start = q_len + 1 - q_end_r.astype(np.int64)
    s_start = s_len + 1 - s_end_r.astype(np.int64)
    return score, q_start, q_end, s_start, s_end
