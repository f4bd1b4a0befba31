"""Device (lax.scan) sweep-line NAM merge vs the host implementation —
SURVEY §7's 'irregular NAM chaining on the accelerator' hard part,
validated on the CPU backend (the kernel is pure jnp)."""

import random

import numpy as np
import pytest

from rabbitsalign_tpu.index.params import IndexParameters
from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex
from rabbitsalign_tpu.io.fasta import References
from rabbitsalign_tpu.seed.randstrobes import randstrobes_query

from .util import random_dna


def _nam_key(n):
    return (n.nam_id, n.query_start, n.query_end, n.ref_start, n.ref_end,
            n.ref_id, n.n_hits, n.score, n.is_rc)


@pytest.fixture(scope="module")
def world():
    unit = random_dna(400, seed=51)
    genome = (random_dna(30000, seed=50) + unit * 30
              + random_dna(30000, seed=52)
              + random_dna(20000, seed=50)[:9000])  # shared segment
    refs = References()
    refs.add("cA", genome[:45000].encode())
    refs.add("cB", genome[45000:].encode())
    params = IndexParameters.from_read_length(150)
    index = StrobemerIndex(refs, params)
    index.populate(0.0002)
    return genome, refs, params, index


def test_merge_hits_device_matches_host_synthetic():
    """Randomized raw hit streams (incl. overlapping windows, duplicate
    starts, multi-segment) through the scan kernel vs the host sweep."""
    from rabbitsalign_tpu.chain.nams import Nam, _nam_score, _open_new_nam, _flush
    from rabbitsalign_tpu.ops.chain_device import merge_hits_device

    r = random.Random(99)
    for case in range(30):
        # synthetic hit stream over 2-3 segments, host-order sorted
        n_seg = r.randint(1, 3)
        stream, seg = [], []
        for s_ in range(n_seg):
            n_hits = r.randint(1, 40)
            hits = []
            for _ in range(n_hits):
                qs = r.randrange(0, 130)
                qe = qs + r.randint(15, 40)
                rs = r.randrange(0, 400)
                re = rs + (qe - qs) + r.randint(-3, 3)
                hits.append((qs, qe, rs, re))
            hits.sort(key=lambda h: (h[0], h[2]))
            for j, h in enumerate(hits):
                stream.append(h)
                seg.append(j == 0)

        # host golden: run merge per segment
        k = 20
        host = []
        i = 0
        while i < len(stream):
            j = i + 1
            while j < len(stream) and not seg[j]:
                j += 1
            open_nams = []
            prev_q = 0
            for (qs, qe, rs, re) in stream[i:j]:
                added = False
                for o in open_nams:
                    if (o.query_prev_hit_startpos < qs <= o.query_end
                            and o.ref_prev_hit_startpos < rs <= o.ref_end):
                        if qe > o.query_end and re > o.ref_end:
                            o.query_end = qe
                            o.ref_end = re
                            o.query_prev_hit_startpos = qs
                            o.ref_prev_hit_startpos = rs
                            o.n_hits += 1
                            added = True
                            break
                        elif qe <= o.query_end and re <= o.ref_end:
                            o.query_prev_hit_startpos = qs
                            o.ref_prev_hit_startpos = rs
                            o.n_hits += 1
                            added = True
                            break
                if not added:
                    open_nams.append(_open_new_nam((qs, qe, rs, re), 0, False))
                if qs > prev_q + k:
                    open_nams = _flush(open_nams, qs, host)
                    prev_q = qs
            for n in open_nams:
                n.score = _nam_score(n)
                n.nam_id = len(host)
                host.append(n)
            i = j

        rows, mask, overflow = merge_hits_device(
            np.asarray(stream, np.int32), np.asarray(seg, bool),
            np.ones(len(stream), bool), k, 64,
        )
        assert not bool(overflow)
        rows = np.asarray(rows)
        mask = np.asarray(mask)
        got = []
        for s_i in range(rows.shape[0]):
            for c in np.flatnonzero(mask[s_i]):
                got.append(tuple(int(v) for v in rows[s_i, c]))
        want = [(n.query_start, n.query_end, n.ref_start, n.ref_end, n.n_hits)
                for n in host]
        assert got == want, case


def test_find_nams_device_chain_matches_host(world):
    from rabbitsalign_tpu.chain.nams import find_nams
    from rabbitsalign_tpu.ops.chain_device import find_nams_device_chain

    genome, refs, params, index = world
    r = random.Random(7)
    checked = 0
    for i in range(50):
        if i % 3 == 1:  # repeat array: many overlapping NAM chains
            st = 30000 + r.randrange(0, 400 * 28)
        elif i % 3 == 2:  # shared segment across contigs: 2+ groups
            st = 45000 + 9000 - 150 - r.randrange(0, 8000)
        else:
            st = r.randrange(0, len(genome) - 200)
        read = genome[st : st + 150]
        qrs = randstrobes_query(read.encode(), params)
        f_h, nams_h = find_nams(qrs, index)
        f_d, nams_d = find_nams_device_chain(qrs, index)
        assert f_d == f_h
        assert [_nam_key(n) for n in nams_d] == [_nam_key(n) for n in nams_h], i
        checked += len(nams_h)
    assert checked > 100


def test_find_nams_composed_batch_matches_host(world):
    """The COMPOSED device front end (one seed+find+run-walk dispatch ->
    host ordering -> device merge) must reproduce find_nams exactly:
    nonrepetitive fraction and every NAM field, for mapped reads,
    reverse-complement reads, repeat-region reads (repetitive filter)
    and junk reads; reads it flags (ties/overflow) take the host path by
    contract and are exempt."""
    from rabbitsalign_tpu.chain.nams import find_nams
    from rabbitsalign_tpu.ops.front_device import (
        find_nams_composed_batch,
        upload_index_split,
    )

    genome, refs, params, index = world
    r = random.Random(8)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    seqs = []
    for i in range(60):
        if i % 11 == 5:
            sq = "".join(r.choice("ACGT") for _ in range(150))
        else:
            # a few repeat-region reads (exercising the repetitive
            # filter); unit repeats are where the vectorized seeder's
            # documented min-queue-tie fallback fires, so most reads stay
            # off the repeat to keep the checked set large
            st = (r.randrange(30000, 30000 + 400 * 30) if i % 10 == 0
                  else r.randrange(0, len(genome) - 200))
            s = list(genome[st : st + 150])
            s[r.randrange(150)] = r.choice("ACGT")
            sq = "".join(s)
            if i % 3 == 1:
                sq = "".join(comp[c] for c in reversed(sq))
        seqs.append(sq.encode())

    dev = upload_index_split(index)
    got = find_nams_composed_batch(seqs, dev, params, index.filter_cutoff)

    n_checked = 0
    n_fallback = 0
    for sq, res in zip(seqs, got):
        qrs = randstrobes_query(sq, params)
        frac_h, nams_h = find_nams(qrs, index)
        if res is None:
            n_fallback += 1
            continue
        frac_d, nams_d = res
        assert frac_d == pytest.approx(frac_h, abs=0), sq[:40]
        assert len(nams_d) == len(nams_h)
        for a, b in zip(nams_d, nams_h):
            assert _nam_key(a) == _nam_key(b)
        n_checked += 1
    assert n_checked >= 45  # fallbacks must stay the exception
