"""The XLA twin of the extend program: forward DP (sw_jax), traceback
with in-walk run-length encoding, and the packed (2*RLE_M + 14, B)
output, built from `lax.scan` and vector ops only.

It is the extend program on CPU (tests, CPU-only users, the virtual
multi-device meshes of the test suite) and the yardstick the CUDA kernel
(ops/extend_cuda.py) is checked against byte for byte.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .extend_device import OP_D, OP_EQ, OP_I, OP_X, RLE_M, _pack_rle_output
from .sw_jax import SwParams, sw_forward

# walker layers
_H = 0
_E = 1
_F = 2
_DONE = 3


def traceback_rle(dirs, score, t_end, q_end):
    """Walk the (D, B, Q) direction planes from each pair's alignment end
    and run-length encode the cigar on the fly. Returns (runs_op
    (RLE_M, B) i32, runs_len (RLE_M, B) i32, meta (8, B) i32 rows
    [t_begin, q_begin, edits, n_runs, 0..]) with runs at descending slots
    from RLE_M-1 (ascending rows = forward cigar order)."""
    D, B, Q = dirs.shape
    zero = jnp.int32(0)
    one = jnp.int32(1)
    rowm = jax.lax.broadcasted_iota(jnp.int32, (RLE_M, B), 0)

    init = dict(
        t=t_end.astype(jnp.int32),
        q=q_end.astype(jnp.int32),
        layer=jnp.where(score.astype(jnp.int32) > 0, _H, _DONE).astype(jnp.int32),
        edits=jnp.zeros(B, jnp.int32),
        cur_op=jnp.zeros(B, jnp.int32),
        cur_len=jnp.zeros(B, jnp.int32),
        nrun=jnp.zeros(B, jnp.int32),
        runs_op=jnp.zeros((RLE_M, B), jnp.int32),
        runs_len=jnp.zeros((RLE_M, B), jnp.int32),
        fin_t=jnp.zeros(B, jnp.int32),
        fin_q=jnp.zeros(B, jnp.int32),
        fin_e=jnp.zeros(B, jnp.int32),
    )

    def step(c, d):
        on_diag = (c["layer"] != _DONE) & (c["t"] + c["q"] == d)
        plane = jax.lax.dynamic_index_in_dim(dirs, d, 0, keepdims=False)  # (B, Q)
        qc = jnp.clip(c["q"], 0, Q - 1)
        dir_cell = jnp.take_along_axis(plane, qc[:, None], axis=1)[:, 0].astype(
            jnp.int32
        )
        h_src = dir_cell & 3
        e_ext = (dir_cell >> 2) & 1
        f_ext = (dir_cell >> 3) & 1
        is_match = ((dir_cell >> 4) & 1) == 1

        in_h = on_diag & (c["layer"] == _H)
        stop = in_h & (h_src == 0)
        do_m = in_h & (h_src == 1)
        do_i = (in_h & (h_src == 2)) | (on_diag & (c["layer"] == _E))
        do_d = (in_h & (h_src == 3)) | (on_diag & (c["layer"] == _F))

        op = jnp.where(
            do_m,
            jnp.where(is_match, OP_EQ, OP_X),
            jnp.where(do_i, OP_I, jnp.where(do_d, OP_D, 0)),
        )

        # in-walk RLE: close the current run when the op changes
        has_op = op > 0
        change = has_op & (op != c["cur_op"])
        emit1 = change & (c["cur_op"] > 0)
        sel1 = emit1[None, :] & (rowm == (RLE_M - 1 - c["nrun"])[None, :])
        runs_op = jnp.where(sel1, c["cur_op"][None, :], c["runs_op"])
        runs_len = jnp.where(sel1, c["cur_len"][None, :], c["runs_len"])
        nrun = c["nrun"] + emit1.astype(jnp.int32)
        cur_op = jnp.where(change, op, c["cur_op"])
        cur_len = jnp.where(change, one, c["cur_len"] + has_op.astype(jnp.int32))

        edits = c["edits"] + jnp.where(
            do_m & ~is_match, one, jnp.where(do_i | do_d, one, zero)
        )

        new_t = c["t"] - (do_m | do_d).astype(jnp.int32)
        new_q = c["q"] - (do_m | do_i).astype(jnp.int32)
        new_layer = jnp.where(
            do_m,
            _H,
            jnp.where(
                do_i,
                jnp.where(e_ext == 1, _E, _H),
                jnp.where(f_ext == 1, _F, _H),
            ),
        )
        off = (~stop) & ((new_t < 0) | (new_q < 0))
        finish = on_diag & (stop | off)
        # flush the in-progress run when the walk ends
        flush = finish & (cur_op > 0)
        sel2 = flush[None, :] & (rowm == (RLE_M - 1 - nrun)[None, :])
        runs_op = jnp.where(sel2, cur_op[None, :], runs_op)
        runs_len = jnp.where(sel2, cur_len[None, :], runs_len)
        nrun = nrun + flush.astype(jnp.int32)
        cur_op = jnp.where(finish, zero, cur_op)

        fin_t = jnp.where(stop, c["t"] + 1, new_t + 1)
        fin_q = jnp.where(stop, c["q"] + 1, new_q + 1)

        nxt = dict(
            t=jnp.where(on_diag & ~finish, new_t, c["t"]),
            q=jnp.where(on_diag & ~finish, new_q, c["q"]),
            layer=jnp.where(finish, _DONE, jnp.where(on_diag, new_layer, c["layer"])),
            edits=edits,
            cur_op=cur_op,
            cur_len=cur_len,
            nrun=nrun,
            runs_op=runs_op,
            runs_len=runs_len,
            fin_t=jnp.where(finish, fin_t, c["fin_t"]),
            fin_q=jnp.where(finish, fin_q, c["fin_q"]),
            fin_e=jnp.where(finish, edits, c["fin_e"]),
        )
        return nxt, None

    final, _ = jax.lax.scan(
        step, init, jnp.arange(D - 1, -1, -1, dtype=jnp.int32)
    )
    meta = jnp.zeros((8, B), jnp.int32)
    meta = meta.at[0].set(final["fin_t"])
    meta = meta.at[1].set(final["fin_q"])
    meta = meta.at[2].set(final["fin_e"])
    meta = meta.at[3].set(final["nrun"])
    return final["runs_op"], final["runs_len"], meta


def _extend_portable_body(q_t, t_t, qlen, tlen, params: SwParams):
    """(Q, B)/(T, B) u8 codes -> packed (2*RLE_M + 14, B) u8 output."""
    q_bq = q_t.T  # sw_forward wants (B, Q)
    t_bt = t_t.T
    score, t_end, q_end, dirs = sw_forward(
        q_bq, t_bt, qlen.astype(jnp.int32), tlen.astype(jnp.int32), params,
        with_dirs=True,
    )
    runs_op, runs_len, meta = traceback_rle(dirs, score, t_end, q_end)
    return _pack_rle_output(runs_op, runs_len, score, t_end, q_end, meta)


def extend_body(q_t, t_t, qlen, tlen, params: SwParams, sub: int):
    """The extend program body (see extend_device.extend_program), run
    per `sub`-column group to bound the (D, sub, Q) direction planes."""
    B = q_t.shape[1]
    outs = [
        _extend_portable_body(q_t[:, i : i + sub], t_t[:, i : i + sub],
                              qlen[i : i + sub], tlen[i : i + sub], params)
        for i in range(0, B, sub)
    ]
    return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)


extend_body.label = "XLA twin (lax.scan)"
