"""Batched anti-diagonal affine-gap Smith-Waterman forward pass (pure JAX).

This is the reference/device-portable implementation of the wavefront DP
that replaces the reference's GASAL2 CUDA kernels
(/root/reference/GASAL2/src/kernels/local_kernel_template.h) and SSW
(/root/reference/ext/ssw/ssw.c): one `lax.scan` step per anti-diagonal,
each step a handful of vector ops over the (batch, query) plane. The
XLA twin (extend_portable.py) builds on it, and the CUDA kernel
(cuda/sw_extend.cuh) implements the same recurrence; all produce
identical outputs and are cross-checked in tests.

Scoring matches SSW: +A for equal codes < 4, else -B; gap of length L
costs O + (L-1)*E; local alignment (H floored at 0). Direction nibbles
for the host/device traceback are emitted per cell:

    bits 0-1: H source (0 stop, 1 diagonal, 2 E=gap-in-query 'I',
              3 F=gap-in-target 'D')
    bit 2:    E formed by gap extension (vs open)
    bit 3:    F formed by gap extension (vs open)

Tie-breaks replicate ssw.c: ends prefer smallest target index, then
smallest query index; H prefers diagonal on ties; F ('D') beats E ('I')
on gap ties; extension beats opening on ties.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

NEG = jnp.int32(-(1 << 28))


class SwParams(NamedTuple):
    match: int
    mismatch: int
    gap_open: int
    gap_extend: int


def _shift_right(x: jnp.ndarray, fill) -> jnp.ndarray:
    """x[..., q] -> x[..., q-1] with `fill` at q=0."""
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (1,), fill, dtype=x.dtype), x[..., :-1]], axis=-1
    )


@functools.partial(jax.jit, static_argnames=("params", "with_dirs"))
def sw_forward(
    q_codes: jnp.ndarray,  # (B, Q) uint8, padded with 4
    t_codes: jnp.ndarray,  # (B, T) uint8, padded with 4
    qlen: jnp.ndarray,  # (B,) int32
    tlen: jnp.ndarray,  # (B,) int32
    params: SwParams,
    with_dirs: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (score (B,), t_end (B,), q_end (B,), dirs (D, B, Q) uint8).

    Ends are inclusive cell coordinates of the best local alignment with
    SSW tie-breaking; score==0 means nothing aligned. D = Q + T - 1.
    """
    B, Q = q_codes.shape
    T = t_codes.shape[1]
    D = Q + T - 1
    A = jnp.int32(params.match)
    Bm = jnp.int32(params.mismatch)
    O = jnp.int32(params.gap_open)
    Eg = jnp.int32(params.gap_extend)

    q_i32 = q_codes.astype(jnp.int32)
    q_idx = jax.lax.broadcasted_iota(jnp.int32, (B, Q), 1)
    q_valid = q_idx < qlen[:, None]
    tlen_b = tlen[:, None]

    # target padded out to D so the per-step dynamic slice never clamps
    t_pad = jnp.pad(t_codes, ((0, 0), (0, D - T)), constant_values=4)

    def step(carry, d):
        H1, H2, E1, F1, revt, best_h, best_t = carry
        t_col = jax.lax.dynamic_slice_in_dim(t_pad, d, 1, axis=1)  # (B, 1)
        revt = _shift_right(revt, 0)
        revt = revt.at[:, 0].set(t_col[:, 0])

        Hm1s = _shift_right(H1, 0)
        Em1s = _shift_right(E1, NEG)
        e_open = Hm1s - O
        e_ext_v = Em1s - Eg
        E = jnp.maximum(e_open, e_ext_v)
        e_is_ext = e_open <= e_ext_v

        f_open = H1 - O
        f_ext_v = F1 - Eg
        F = jnp.maximum(f_open, f_ext_v)
        f_is_ext = f_open <= f_ext_v

        Hm2s = _shift_right(H2, 0)
        sub = jnp.where((q_i32 == revt) & (q_i32 < 4), A, -Bm)
        dsub = Hm2s + sub

        e1 = jnp.maximum(E, 0)
        f1 = jnp.maximum(F, 0)
        gap1 = jnp.maximum(e1, f1)
        H = jnp.maximum(jnp.maximum(dsub, gap1), 0)

        t_vec = d - q_idx
        valid = (t_vec >= 0) & (t_vec < tlen_b) & q_valid
        H = jnp.where(valid, H, 0)
        E = jnp.where(valid, E, NEG)
        F = jnp.where(valid, F, NEG)

        h_src = jnp.where(
            H == 0,
            0,
            jnp.where(dsub >= gap1, 1, jnp.where(e1 > f1, 2, 3)),
        ).astype(jnp.uint8)
        dirs = (
            h_src
            | (e_is_ext.astype(jnp.uint8) << 2)
            | (f_is_ext.astype(jnp.uint8) << 3)
            # bit 4: code equality, for sequence-free traceback (same
            # encoding as the CUDA kernel; host traceback masks it off)
            | ((q_i32 == revt).astype(jnp.uint8) << 4)
        )
        dirs = jnp.where(valid, dirs, jnp.uint8(0))

        upd = H > best_h  # first attainment per lane == smallest t per lane
        best_h = jnp.where(upd, H, best_h)
        best_t = jnp.where(upd, t_vec, best_t)

        out = dirs if with_dirs else jnp.zeros((), dtype=jnp.uint8)
        return (H, H1, E, F, revt, best_h, best_t), out

    # init derived from the inputs (not constants) so the carries carry
    # the same device-varying type as the inputs under shard_map
    zeros = q_i32 * 0
    init = (
        zeros,
        zeros,
        zeros + NEG,
        zeros + NEG,
        zeros,
        zeros,
        zeros - 1,
    )
    (H1, H2, E1, F1, revt, best_h, best_t), dirs = jax.lax.scan(
        step, init, jnp.arange(D, dtype=jnp.int32)
    )

    # SSW global tie-break: max score, then min t, then min q
    score = jnp.max(best_h, axis=1)
    is_best = best_h == score[:, None]
    INT_MAX = jnp.int32(2**30)
    t_cand = jnp.where(is_best, best_t, INT_MAX)
    t_end = jnp.min(t_cand, axis=1)
    q_end = jnp.argmax(is_best & (best_t == t_end[:, None]), axis=1).astype(jnp.int32)
    return score, t_end, q_end, dirs
