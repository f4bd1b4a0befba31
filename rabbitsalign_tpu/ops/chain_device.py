"""Device-side NAM chaining: the sweep-line merge as a lax.scan.

SURVEY §7 lists the reference's irregular NAM construction
(`merge_hits_into_nams`, /root/reference/src/nam.cpp:370-536) as the
hardest part to express on an accelerator: a sweep over hits that mutates an
insertion-ordered list of "open" NAMs — extend the first open NAM whose
(query, ref) windows admit the hit, else open a new one, and flush open
NAMs that fell behind the sweep line. This module is that algorithm as
a single `lax.scan` over the hit stream with the open-NAM list held in
a fixed-capacity table:

* the table is kept PACKED in insertion order (slots [0, n_open)), so
  "first open NAM that matches" is the lowest set bit of a vectorized
  match mask — bit-exact with the sequential scan's first-match rule;
* flushes emit masked rows and compact the table with a stable argsort
  (relative order of survivors preserved, as the reference's vector
  erase does);
* segment boundaries (a new (ref_id, orientation) group) flush
  everything and reset the sweep state, so one scan handles a whole
  read's concatenated hit stream;
* emissions are collected as (step, slot) masked rows; flattening in
  step-major slot-minor order reproduces the reference's exact NAM
  emission order (which is observable: nam_id feeds downstream
  tie-breaks);
* more than `cap` concurrently-open NAMs sets an overflow flag and the
  caller re-chains that read on the host (mirroring the per-read
  fallback discipline of the device seeding path).

`find_nams_device_chain` wires it up as a complete find_nams twin:
host-side hit collection (lookups + min-length-diff rule + robin_hood
group order, all validated elsewhere) feeding the device merge,
element-for-element equal to chain/nams.find_nams — tested on the CPU
mesh in tests/test_chain_device.py.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG1 = jnp.int32(-1)

# emitted row fields
_F_QS, _F_QE, _F_RS, _F_RE, _F_NH = range(5)


@functools.partial(jax.jit, static_argnames=("k", "cap"))
def merge_hits_device(hits, seg_start, valid, k: int, cap: int):
    """Run the sweep-line merge over one read's hit stream.

    hits (H, 4) int32 rows [query_start, query_end, ref_start, ref_end]
    in the exact host processing order (groups concatenated in
    robin_hood iteration order, hits sorted within each group by the
    reference's introsort); seg_start (H,) bool marks the first hit of
    each group; valid (H,) bool marks real rows.

    Returns (rows (H+1, cap, 5) int32, mask (H+1, cap) bool, overflow
    () bool): flattening `rows[mask]` in (step, slot) order gives the
    emitted NAMs as [query_start, query_end, ref_start, ref_end,
    n_hits] in the reference's emission order. The trailing step is the
    end-of-stream flush."""
    H = hits.shape[0]
    zeros = jnp.zeros(cap, jnp.int32)

    init = dict(
        qs=zeros, qe=zeros, rs=zeros, re=zeros,
        qp=zeros, rp=zeros, nh=zeros,
        n_open=jnp.int32(0),
        prev_q=jnp.int32(0),
        overflow=jnp.bool_(False),
    )
    slot = jnp.arange(cap, dtype=jnp.int32)

    def emit_rows(st):
        return jnp.stack([st["qs"], st["qe"], st["rs"], st["re"], st["nh"]],
                         axis=1)

    def compact(st, emit_mask):
        """Emit masked slots and stably compact the survivors."""
        alive = slot < st["n_open"]
        emit = emit_mask & alive
        rows = emit_rows(st)
        # stable partition: emitted slots sink to the back, survivors
        # keep their relative (insertion) order
        perm = jnp.argsort(emit.astype(jnp.int32), stable=True)
        out = dict(st)
        for f in ("qs", "qe", "rs", "re", "qp", "rp", "nh"):
            out[f] = st[f][perm]
        out["n_open"] = st["n_open"] - jnp.sum(emit, dtype=jnp.int32)
        return out, rows, emit

    def step(st, x):
        qs, qe, rs, re, seg, ok = x
        # --- segment boundary: flush everything, reset sweep ---------
        flush_all = seg & ok
        st, rows0, emit0 = compact(
            st, jnp.where(flush_all, jnp.ones(cap, bool), jnp.zeros(cap, bool))
        )
        st["prev_q"] = jnp.where(flush_all, jnp.int32(0), st["prev_q"])

        alive = slot < st["n_open"]
        # --- first-match rule over the packed table -------------------
        in_win = (
            alive
            & (st["qp"] < qs) & (qs <= st["qe"])
            & (st["rp"] < rs) & (rs <= st["re"])
        )
        case_a = (qe > st["qe"]) & (re > st["re"])
        case_b = (qe <= st["qe"]) & (re <= st["re"])
        m = in_win & (case_a | case_b)
        any_m = ok & jnp.any(m)
        first = jnp.argmax(m).astype(jnp.int32)
        hit_slot = any_m & (slot == first)
        grow = hit_slot & case_a
        st["qe"] = jnp.where(grow, qe, st["qe"])
        st["re"] = jnp.where(grow, re, st["re"])
        st["qp"] = jnp.where(hit_slot, qs, st["qp"])
        st["rp"] = jnp.where(hit_slot, rs, st["rp"])
        st["nh"] = jnp.where(hit_slot, st["nh"] + 1, st["nh"])

        # --- no match: append at slot n_open --------------------------
        add = ok & ~any_m
        st["overflow"] = st["overflow"] | (add & (st["n_open"] >= cap))
        at = add & (slot == st["n_open"])
        st["qs"] = jnp.where(at, qs, st["qs"])
        st["qe"] = jnp.where(at, qe, st["qe"])
        st["rs"] = jnp.where(at, rs, st["rs"])
        st["re"] = jnp.where(at, re, st["re"])
        st["qp"] = jnp.where(at, qs, st["qp"])
        st["rp"] = jnp.where(at, rs, st["rp"])
        st["nh"] = jnp.where(at, jnp.int32(1), st["nh"])
        st["n_open"] = st["n_open"] + add.astype(jnp.int32)

        # --- sweep-line flush (only after advancing > k) --------------
        do_flush = ok & (qs > st["prev_q"] + jnp.int32(k))
        st, rows1, emit1 = compact(
            st, jnp.where(do_flush, st["qe"] < qs, jnp.zeros(cap, bool))
        )
        st["prev_q"] = jnp.where(do_flush, qs, st["prev_q"])

        # a step can emit from both the segment flush and the sweep
        # flush; the segment flush empties the table first, so the two
        # emission sets never overlap in a step and seg rows come first
        rows = jnp.where(emit0[:, None], rows0, rows1)
        return st, (rows, emit0 | emit1)

    xs = (
        hits[:, 0], hits[:, 1], hits[:, 2], hits[:, 3],
        seg_start, valid,
    )
    final, (rows, mask) = jax.lax.scan(step, init, xs)
    # end-of-stream flush
    final, rows_end, emit_end = compact(final, jnp.ones(cap, bool))
    rows = jnp.concatenate([rows, rows_end[None]], axis=0)
    mask = jnp.concatenate([mask, emit_end[None]], axis=0)
    return rows, mask, final["overflow"]


def merge_stream_device_padded(stream, seg, k: int, cap: int):
    """Run the jitted sweep merge over an ordered hit stream padded to a
    power-of-two length: every distinct raw length would otherwise be a
    fresh trace + XLA compile. Shared by the
    standalone device chain and the composed front end so the padding
    discipline cannot drift. Returns (rows, mask, H, Hp, overflow) with
    rows/mask as numpy; the end-of-stream flush row is at index Hp."""
    H = len(stream)
    Hp = 16
    while Hp < H:
        Hp *= 2
    hits_arr = np.zeros((Hp, 4), dtype=np.int32)
    hits_arr[:H] = np.asarray(stream, dtype=np.int32)
    seg_p = np.zeros(Hp, dtype=bool)
    seg_p[:H] = seg
    valid_p = np.zeros(Hp, dtype=bool)
    valid_p[:H] = True
    rows, mask, ovf = merge_hits_device(
        jnp.asarray(hits_arr), jnp.asarray(seg_p), jnp.asarray(valid_p),
        k, cap,
    )
    return np.asarray(rows), np.asarray(mask), H, Hp, bool(ovf)


def iter_merged_nam_rows(rows, mask, seg, H: int, Hp: int):
    """Yield (group_index, qs, qe, rs, re, n_hits) for every NAM row the
    padded merge emitted, in flush order, applying the attribution rule:
    a segment-boundary step's rows belong to the PRECEDING group; sweep
    flushes and the end-of-stream flush (row Hp) to the current group.
    Shared by find_nams_device_chain and ops/front_device."""
    grp_of = np.zeros(H, dtype=np.int64)
    g = -1
    for s_i in range(H):
        if seg[s_i]:
            g += 1
        grp_of[s_i] = g
    for s_i in list(range(H)) + [Hp]:
        if not mask[s_i].any():
            continue
        if s_i < H and seg[s_i]:
            gi = int(grp_of[s_i]) - 1
        else:
            gi = g if s_i >= H else int(grp_of[s_i])
        for c in np.flatnonzero(mask[s_i]):
            qs, qe, rs, re, nh = (int(v) for v in rows[s_i, c])
            yield gi, qs, qe, rs, re, nh


def find_nams_device_chain(query_randstrobes, index, cap: int = 32):
    """find_nams (reference src/nam.cpp:771-926) with the sweep-line NAM
    merge running on the accelerator: host-side lookups + hit collection
    (min-length-diff rule, robin_hood group order — the validated
    chain/nams.py code) produce the ordered hit stream; the scan kernel
    merges it; NAM records are reconstructed in emission order. Returns
    (nonrepetitive_fraction, List[Nam]) exactly like find_nams; reads
    overflowing the open-NAM table re-chain on the host."""
    from ..chain.nams import (
        Nam,
        _add_to_hits_per_ref,
        _nam_score as host_score,
        _rh_items,
        find_nams,
    )
    from ..utils.sorting import introsort

    nq = len(query_randstrobes)
    if nq == 0:
        return 1.0, []
    positions = index.find(query_randstrobes.hash)
    found = positions >= 0
    total_hits = int(np.sum(found))
    filtered = np.zeros(nq, dtype=bool)
    if total_hits:
        filtered[found] = index.is_filtered(positions[found])
    hits_per_ref: List[dict] = [{}, {}]
    nr_good_hits = 0
    for i in np.flatnonzero(found):
        if filtered[i]:
            continue
        nr_good_hits += 1
        _add_to_hits_per_ref(
            hits_per_ref[bool(query_randstrobes.is_reverse[i])],
            int(query_randstrobes.start[i]),
            int(query_randstrobes.end[i]),
            index,
            int(positions[i]),
        )
    nonrep = (
        float(np.float32(nr_good_hits) / np.float32(total_hits))
        if total_hits > 0 else 1.0
    )

    # ordered hit stream: groups in robin_hood order per orientation,
    # hits introsorted within each group (the host merge's exact input)
    stream: List[Tuple[int, int, int, int]] = []
    seg: List[bool] = []
    groups: List[Tuple[int, bool, int]] = []  # (ref_id, is_rc, n_hits)
    for is_rc in (0, 1):
        for ref_id, hits in _rh_items(hits_per_ref[is_rc]):
            hits = list(hits)
            introsort(hits, [(h[0] << 32) | h[2] for h in hits], False)
            for j, h in enumerate(hits):
                stream.append(h)
                seg.append(j == 0)
            groups.append((ref_id, bool(is_rc), len(hits)))
    if not stream:
        return nonrep, []

    seg_arr = np.asarray(seg, dtype=bool)
    rows, mask, H, Hp, overflow = merge_stream_device_padded(
        stream, seg_arr, index.k(), cap)
    if overflow:
        return find_nams(query_randstrobes, index)  # host fallback

    nams: List[Nam] = []
    for gi, qs, qe, rs, re, nh in iter_merged_nam_rows(
            rows, mask, seg_arr, H, Hp):
        ref_id, is_rc, _ = groups[gi]
        n = Nam(
            nam_id=len(nams), query_start=qs, query_end=qe,
            ref_start=rs, ref_end=re, n_hits=nh, ref_id=ref_id,
            is_rc=is_rc,
        )
        n.score = host_score(n)
        nams.append(n)
    return nonrep, nams
