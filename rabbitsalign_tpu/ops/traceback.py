"""Host-side traceback over direction nibbles produced by the wavefront
Smith-Waterman forward pass (sw_jax).

Vectorized over the batch: every iteration advances all unfinished
alignments one step (one numpy gather per step). The recorded op stream is
then run-length encoded per pair, with M resolved into '='/'X' by code
comparison — matching the reference's GPU-result post-processing
(CalculateNumberMismatch semantics, ext/ssw/ssw_cpp.cpp:126-205).

Plays the role of GASAL2's gasal_get_tb kernel
(/root/reference/GASAL2/src/kernels/get_tb.h) plus the cigar conversion in
src/gasal2_ssw.cpp:185-235.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..align.cigar import CIGAR_DEL, CIGAR_EQ, CIGAR_INS, CIGAR_X, Cigar

# walk op codes
_OP_NONE = 0
_OP_M = 1
_OP_I = 2
_OP_D = 3

_LAYER_H = 0
_LAYER_E = 1
_LAYER_F = 2
_DONE = 3


def traceback_batch(
    dirs: np.ndarray,  # (D, B, Q) or (D, Q, B) uint8
    score: np.ndarray,  # (B,)
    t_end: np.ndarray,  # (B,)
    q_end: np.ndarray,  # (B,)
    q_codes: np.ndarray,  # (B, Q) uint8
    t_codes: np.ndarray,  # (B, T) uint8
    layout: str = "dbq",
) -> List[Optional[Tuple[int, int, Cigar, int]]]:
    """For each pair, return (t_begin, q_begin, eqx_cigar, edit_distance)
    over the aligned region, or None when score == 0."""
    B = q_codes.shape[0]
    D = dirs.shape[0]
    max_steps = D + 1
    dqb = layout == "dqb"

    t = t_end.astype(np.int64).copy()
    q = q_end.astype(np.int64).copy()
    layer = np.where(score > 0, _LAYER_H, _DONE).astype(np.int64)
    ops_rec = np.zeros((B, max_steps), dtype=np.uint8)
    n_steps = np.zeros(B, dtype=np.int64)
    t_begin = np.zeros(B, dtype=np.int64)
    q_begin = np.zeros(B, dtype=np.int64)
    all_b = np.arange(B)

    step = 0
    active = layer != _DONE
    while active.any() and step < max_steps:
        # full-width masked ops: B is small, avoiding index compression
        tb = np.where(active, t, 0)
        qb = np.where(active, q, 0)
        if dqb:
            d = dirs[tb + qb, qb, all_b]
        else:
            d = dirs[tb + qb, all_b, qb]
        h_src = d & 3
        e_ext = (d >> 2) & 1
        f_ext = (d >> 3) & 1

        in_h = active & (layer == _LAYER_H)
        stop = in_h & (h_src == 0)
        do_m = in_h & (h_src == 1)
        do_i = (in_h & (h_src == 2)) | (active & (layer == _LAYER_E))
        do_d = (in_h & (h_src == 3)) | (active & (layer == _LAYER_F))

        op = np.where(do_m, _OP_M, np.where(do_i, _OP_I, np.where(do_d, _OP_D, _OP_NONE)))
        ops_rec[:, step] = np.where(active, op, 0)

        t_begin = np.where(stop, t + 1, t_begin)
        q_begin = np.where(stop, q + 1, q_begin)

        cont = active & ~stop
        t = np.where(cont, t - (do_m | do_d), t)
        q = np.where(cont, q - (do_m | do_i), q)
        layer = np.where(
            cont,
            np.where(
                do_m,
                _LAYER_H,
                np.where(
                    do_i,
                    np.where(e_ext == 1, _LAYER_E, _LAYER_H),
                    np.where(f_ext == 1, _LAYER_F, _LAYER_H),
                ),
            ),
            _DONE,
        )
        n_steps = np.where(cont, n_steps + 1, n_steps)

        # alignments that walked off the matrix edge begin at cell+1
        off = cont & ((t < 0) | (q < 0))
        t_begin = np.where(off, t + 1, t_begin)
        q_begin = np.where(off, q + 1, q_begin)
        layer = np.where(off, _DONE, layer)

        step += 1
        active = layer != _DONE

    results: List[Optional[Tuple[int, int, Cigar, int]]] = []
    for b in range(B):
        if score[b] <= 0:
            results.append(None)
            continue
        ops = ops_rec[b, : n_steps[b] + 1][::-1]
        ops = ops[ops != _OP_NONE]
        cigar = Cigar()
        edit = 0
        qi = int(q_begin[b])
        ti = int(t_begin[b])
        i = 0
        n = ops.shape[0]
        while i < n:
            o = ops[i]
            j = i
            while j < n and ops[j] == o:
                j += 1
            length = j - i
            if o == _OP_M:
                a = q_codes[b, qi : qi + length]
                c = t_codes[b, ti : ti + length]
                eq = a == c
                edit += int(np.count_nonzero(~eq))
                boundaries = np.flatnonzero(eq[1:] != eq[:-1]) + 1
                starts = np.concatenate([[0], boundaries])
                ends = np.concatenate([boundaries, [length]])
                for rs, re in zip(starts, ends):
                    cigar.push(CIGAR_EQ if eq[rs] else CIGAR_X, int(re - rs))
                qi += length
                ti += length
            elif o == _OP_I:
                cigar.push(CIGAR_INS, length)
                edit += length
                qi += length
            else:
                cigar.push(CIGAR_DEL, length)
                edit += length
                ti += length
            i = j
        results.append((int(t_begin[b]), int(q_begin[b]), cigar, edit))
    return results
