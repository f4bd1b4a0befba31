"""Device extension: the choice of extend program per platform, the
jitted wrappers every caller dispatches through, and the platform-neutral
host helpers around them.

An extend program maps (Q, B)/(T, B) u8 codes and (B,) lengths to the
packed (OUT_ROWS, B) u8 buffer below: forward Smith-Waterman, traceback
from the best cell and a run-length-encoded cigar, all on the device, so
the direction tensor never leaves it. This replaces the reference's
GPU flow of downloading packed traceback matrices + cigars
(/root/reference/GASAL2/src/gasal_align.cu:266-304,
/root/reference/src/gasal2_ssw.cpp:179-249).

Packed output layout (2*RLE_M + 14, B): 2-byte runs — rows [0,M) length
lo byte, rows [M,2M) (op << 5) | (length >> 8) (op 3 bits, length 13
bits; lengths cap at T <= 2048 so 13 bits always fit) — then score,
t_end, q_end, t_begin, q_begin, edits as u16 (lo,hi) row pairs, then
n_runs u16 (0xFFFF = more than M runs -> host re-align). Runs sit at
slots [M - n_runs, M) in forward cigar order (the walker discovers them
back-to-front and fills slots descending from M-1).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..align.cigar import CIGAR_DEL, CIGAR_EQ, CIGAR_INS, CIGAR_X, Cigar
from .sw_jax import SwParams

RLE_M = 32  # cigar run slots per pair; MUST equal `M` in native/engine.cpp
# chunk_set_device_results and kRleM in ops/cuda/sw_extend.cuh

# run op codes (0 = no run)
OP_EQ = 1
OP_X = 2
OP_I = 3
OP_D = 4

OUT_ROWS = 2 * RLE_M + 14

REF_PAGE_BITS = 30  # 1 GiB resident-reference pages (int32-safe offsets)
REF_PAGE_SIZE = 1 << REF_PAGE_BITS
REF_PAGE_OVERLAP = 4096  # >= max target window (T caps at 2048)


def pack_ref_pages(codes: np.ndarray) -> np.ndarray:
    """Reshape the flat nt4 code array into overlapped pages
    (P, PAGE + OVERLAP) so every target window [tstart, tstart+T) lives
    entirely inside the page tstart >> REF_PAGE_BITS. Pad value 4 ('N')."""
    n = codes.shape[0]
    n_pages = max(1, -(-n // REF_PAGE_SIZE))
    # a sub-page genome gets one page of its own size (page id is then
    # always 0 and the in-page offset equals tstart), so small references
    # don't pad to a full GiB
    width = min(REF_PAGE_SIZE, max(n, 1)) + REF_PAGE_OVERLAP
    pages = np.full((n_pages, width), 4, dtype=np.uint8)
    for p in range(n_pages):
        lo = p * REF_PAGE_SIZE
        hi = min(n, lo + width)
        pages[p, : hi - lo] = codes[lo:hi]
    return pages


def pack_input(q_t: np.ndarray, t_t: np.ndarray, qlen: np.ndarray, tlen: np.ndarray) -> np.ndarray:
    Q, B = q_t.shape
    T = t_t.shape[0]
    buf = np.empty((Q + T + 4, B), dtype=np.uint8)
    buf[:Q] = q_t
    buf[Q : Q + T] = t_t
    buf[Q + T] = qlen & 0xFF
    buf[Q + T + 1] = (qlen >> 8) & 0xFF
    buf[Q + T + 2] = tlen & 0xFF
    buf[Q + T + 3] = (tlen >> 8) & 0xFF
    return buf


def unpack_output(out: np.ndarray, D: int = 0):
    """Returns (op_runs (M, B), len_runs (M, B), n_runs (B,), score,
    t_end, q_end, t_begin, q_begin, edits). `D` is unused (kept for API
    stability); n_runs == 0xFFFF marks an overflowed (>M-run) pair that
    the caller must re-align on the host."""
    M = RLE_M
    hi = out[M : 2 * M].astype(np.int32)
    op_runs = (hi >> 5).astype(np.uint8)
    len_runs = out[:M].astype(np.int32) | ((hi & 0x1F) << 8)
    vals = []
    for i in range(7):
        lo = out[2 * M + 2 * i].astype(np.int32)
        hi = out[2 * M + 2 * i + 1].astype(np.int32)
        vals.append(lo | (hi << 8))
    score, t_end, q_end, t_begin, q_begin, edits, n_runs = vals
    return (op_runs, len_runs, n_runs, score, t_end, q_end, t_begin,
            q_begin, edits)


def _pack_rle_output(runs_op, runs_len, score, t_end, q_end, meta):
    """Pack the walker-RLE'd traceback (extend_portable.traceback_rle)
    into the u8 transfer buffer. Runs stay at their descending slots:
    rows [M - n_runs, M) hold the forward-order cigar."""

    def u16rows(v):
        v = v.astype(jnp.int32)
        return jnp.stack([(v & 0xFF).astype(jnp.uint8), ((v >> 8) & 0xFF).astype(jnp.uint8)])

    n_runs = meta[3]
    nr = jnp.where(n_runs > RLE_M, 0xFFFF, n_runs)
    return jnp.concatenate(
        [
            (runs_len & 0xFF).astype(jnp.uint8),
            ((runs_op << 5) | ((runs_len >> 8) & 0x1F)).astype(jnp.uint8),
            u16rows(score),
            u16rows(t_end),
            u16rows(q_end),
            u16rows(meta[0]),  # t_begin
            u16rows(meta[1]),  # q_begin
            u16rows(meta[2]),  # edits
            u16rows(nr),
        ],
        axis=0,
    )


def ops_to_cigars(
    op_runs: np.ndarray,   # (M, B) uint8 run op codes
    len_runs: np.ndarray,  # (M, B) int32 run lengths
    n_runs: np.ndarray,    # (B,) int32; 0xFFFF = overflow
    score: np.ndarray,
) -> List[Optional[Tuple[Cigar, int]]]:
    """Decode the device-RLE runs into =/X/I/D cigars. Runs live at slots
    [M - n_runs, M) in forward cigar order. Returns per pair (cigar, n_ops_consumed) or None for score<=0, empty
    streams, and >M-run overflows (caller re-aligns those on the host)."""
    _MAP = {OP_EQ: CIGAR_EQ, OP_X: CIGAR_X, OP_I: CIGAR_INS, OP_D: CIGAR_DEL}
    B = op_runs.shape[1]
    opsT = np.ascontiguousarray(op_runs.T)
    lensT = np.ascontiguousarray(len_runs.T)
    out: List[Optional[Tuple[Cigar, int]]] = []
    for b in range(B):
        nr = int(n_runs[b])
        if score[b] <= 0 or nr == 0 or nr > RLE_M:
            out.append(None)
            continue
        cigar = Cigar()
        total = 0
        ok = True
        off = RLE_M - nr
        for r in range(off, off + nr):
            op = int(opsT[b, r])
            ln = int(lensT[b, r])
            if not 1 <= op <= 4 or ln <= 0:
                ok = False
                break
            cigar.push(_MAP[op], ln)
            total += ln
        out.append((cigar, total) if ok else None)
    return out


def unpack_q2(buf, ref_codes, Q: int, T: int):
    """Decode the q2 upload layout into (q_t (Q,B) u8, t_t (T,B) u8,
    qlen (B,), tlen (B,)): 2-bit-packed queries (chunk_fill_batch_q2) —
    4 codes/byte + N-mask bitmap + u16 lengths + u32 target offset —
    with targets gathered from the device-resident paged reference.
    Shared by every extend program."""
    B = buf.shape[1]
    Qp = (Q + 3) // 4
    Qm = (Q + 7) // 8
    packed = buf[:Qp]
    nmask = buf[Qp : Qp + Qm]
    tail = buf[Qp + Qm :]
    r = jnp.arange(Q, dtype=jnp.int32)
    code = (packed[r >> 2] >> ((r & 3) << 1)[:, None].astype(jnp.uint8)) & 3
    nbit = (nmask[r >> 3] >> (r & 7)[:, None].astype(jnp.uint8)) & 1
    qlen = tail[0].astype(jnp.int32) | (tail[1].astype(jnp.int32) << 8)
    tlen = tail[2].astype(jnp.int32) | (tail[3].astype(jnp.int32) << 8)
    q_t = jnp.where((nbit != 0) | (r[:, None] >= qlen[None, :]),
                    jnp.uint8(4), code.astype(jnp.uint8))
    tstart = (
        tail[4].astype(jnp.uint32)
        | (tail[5].astype(jnp.uint32) << 8)
        | (tail[6].astype(jnp.uint32) << 16)
        | (tail[7].astype(jnp.uint32) << 24)
    )
    page = (tstart >> jnp.uint32(REF_PAGE_BITS)).astype(jnp.int32)
    off = (tstart & jnp.uint32(REF_PAGE_SIZE - 1)).astype(jnp.int32)
    page_w = ref_codes.shape[1]
    rows = jnp.arange(T, dtype=jnp.int32)[:, None]
    ridx = jnp.minimum(off[None, :] + rows, page_w - 1)
    t_t = jnp.where(rows < tlen[None, :],
                    ref_codes[page[None, :].repeat(T, axis=0), ridx],
                    jnp.uint8(4))
    return q_t, t_t, qlen, tlen


ExtendBody = Callable  # (q_t, t_t, qlen, tlen, params, sub) -> (OUT_ROWS, B) u8


def extend_program(platform: str) -> ExtendBody:
    """The extend program for a JAX platform: the XLA twin
    (extend_portable) on ``cpu``, the CUDA kernel (extend_cuda, built and
    registered here) on ``gpu``. Any other platform is an error; nothing
    falls back."""
    if platform == "cpu":
        from .extend_portable import extend_body

        return extend_body
    if platform == "gpu":
        from . import extend_cuda

        extend_cuda.register()  # builds the library on first use
        return extend_cuda.extend_body
    raise RuntimeError(
        f"no extend program for platform {platform!r} (cpu: XLA twin, "
        "gpu: CUDA kernel)")


def extend_batch_packed_resident_q2(buf, ref_codes, Q: int, T: int,
                                    params: SwParams, sub: int,
                                    body: ExtendBody):
    """Production layout: 2-bit queries + target offsets into the
    device-resident reference pages (unpack_q2) -> packed output."""
    with jax.enable_x64(False):
        return _extend_resident_q2(buf, ref_codes, Q, T, params, sub, body)


@functools.partial(jax.jit,
                   static_argnames=("Q", "T", "params", "sub", "body"))
def _extend_resident_q2(buf, ref_codes, Q: int, T: int, params: SwParams,
                        sub: int, body: ExtendBody):
    q_t, t_t, qlen, tlen = unpack_q2(buf, ref_codes, Q, T)
    return body(q_t, t_t, qlen, tlen, params, sub)


def extend_batch_packed(buf, Q: int, T: int, params: SwParams,
                        body: ExtendBody):
    """Self-contained layout (pack_input: query and target codes plus
    lengths) -> packed output."""
    with jax.enable_x64(False):
        return _extend_packed(buf, Q, T, params, body)


@functools.partial(jax.jit, static_argnames=("Q", "T", "params", "body"))
def _extend_packed(buf, Q: int, T: int, params: SwParams, body: ExtendBody):
    qlen = buf[Q + T].astype(jnp.int32) | (buf[Q + T + 1].astype(jnp.int32) << 8)
    tlen = buf[Q + T + 2].astype(jnp.int32) | (buf[Q + T + 3].astype(jnp.int32) << 8)
    return body(buf[:Q], buf[Q : Q + T], qlen, tlen, params, buf.shape[1])
