"""Device-op tests: lax.scan wavefront SW vs the SSW port, host
traceback, the extend programs (XLA twin, CUDA kernel arithmetic on the
host, the CUDA kernel itself on a GPU) and the multi-device sharding
helpers on a virtual mesh."""

import random

import numpy as np
import pytest

from rabbitsalign_tpu.align.ssw import ssw_align
from rabbitsalign_tpu.ops.sw_jax import SwParams, sw_forward
from rabbitsalign_tpu.ops.traceback import traceback_batch
from rabbitsalign_tpu.utils.dna import encode

from .util import random_dna

PARAMS = SwParams(2, 8, 12, 1)


def _pack(pairs, Q, T):
    B = len(pairs)
    qc = np.full((B, Q), 4, dtype=np.uint8)
    tc = np.full((B, T), 4, dtype=np.uint8)
    ql = np.zeros(B, dtype=np.int32)
    tl = np.zeros(B, dtype=np.int32)
    for i, (q, t) in enumerate(pairs):
        eq, et = encode(q), encode(t)
        qc[i, : eq.shape[0]] = eq
        tc[i, : et.shape[0]] = et
        ql[i] = eq.shape[0]
        tl[i] = et.shape[0]
    return qc, tc, ql, tl


def _mutate(s, r, nsub=0, nins=0, ndel=0):
    chars = list(s)
    for _ in range(nsub):
        chars[r.randrange(len(chars))] = r.choice("ACGT")
    for _ in range(nins):
        chars.insert(r.randrange(len(chars)), r.choice("ACGT"))
    for _ in range(ndel):
        del chars[r.randrange(len(chars))]
    return "".join(chars)


def test_sw_forward_matches_ssw():
    r = random.Random(31)
    Q, T = 64, 128
    pairs = []
    for i in range(24):
        core = random_dna(r.randint(30, 60), seed=500 + i)
        q = _mutate(core, r, r.randint(0, 4), r.randint(0, 1), r.randint(0, 1))[:Q]
        t = (random_dna(r.randint(0, 30), seed=i) + core + random_dna(r.randint(0, 30), seed=i + 1))[:T]
        pairs.append((q, t))
    pairs.append((random_dna(50, seed=1), random_dna(100, seed=2)))  # junk
    qc, tc, ql, tl = _pack(pairs, Q, T)
    score, t_end, q_end, dirs = map(np.asarray, sw_forward(qc, tc, ql, tl, PARAMS))
    res = traceback_batch(dirs, score, t_end, q_end, qc, tc)
    for i, (q, t) in enumerate(pairs):
        gold = ssw_align(encode(q), encode(t), 2, 8, 12, 1)
        if gold.score1 == 0:
            assert score[i] == 0
            continue
        assert (score[i], t_end[i], q_end[i]) == (gold.score1, gold.ref_end, gold.read_end), i
        tb = res[i]
        assert tb is not None
        assert (tb[0], tb[1]) == (gold.ref_begin, gold.read_begin), i
        assert str(tb[2].to_m()) == str(gold.cigar), i


def test_dryrun_multichip_cpu():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_shard_index_by_hash_run_alignment():
    """Shard cuts must move to equal-hash run starts so no run straddles
    two shards (what makes per-shard counts/runs globally exact)."""
    from rabbitsalign_tpu.parallel.sharding import SENTINEL, shard_index_by_hash

    rng = np.random.RandomState(3)
    # heavy duplication so naive equal-size cuts would split runs
    base = np.sort(rng.randint(0, 50, 997).astype(np.uint64))
    h, p, k, r, starts = shard_index_by_hash(
        base, np.arange(997, dtype=np.uint32), np.zeros(997, np.uint32), 4
    )
    flat = []
    for s_ in range(4):
        row = h[s_][h[s_] != SENTINEL]
        if len(flat) and row.size:
            assert flat[-1] != row[0], "run split across shards"
        flat.extend(row.tolist())
    assert np.array_equal(np.array(flat, dtype=np.uint64), base)
    assert starts[0] == 0 and np.all(np.diff(starts) >= 0)


def test_dumpstrobes_tool(tmp_path):
    from rabbitsalign_tpu.tools.dumpstrobes import main as dump_main

    ref = tmp_path / "r.fa"
    ref.write_text(">c\n" + random_dna(5000, seed=4) + "\n")
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert dump_main([str(ref)]) == 0
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) > 100
    f = lines[0].split("\t")
    assert f[0] == "c" and int(f[2]) > int(f[1])


def _extend_parity_pairs(Q, T):
    """Random extend pairs incl. junk, empty, and a >RLE_M-run overflow
    case — shared by the XLA twin, host-emulated and CUDA parity tests."""
    r = random.Random(77)
    pairs = []
    for i in range(40):
        core = random_dna(r.randint(60, 200), seed=900 + i)
        q = _mutate(core, r, r.randint(0, 6), r.randint(0, 2), r.randint(0, 2))[:Q]
        t = (random_dna(r.randint(0, 100), seed=i) + core
             + random_dna(r.randint(0, 100), seed=i + 1))[:T]
        pairs.append((q, t))
    pairs.append((random_dna(150, seed=1), random_dna(400, seed=2)))  # junk
    pairs.append(("", random_dna(100, seed=3)))  # empty query
    pairs.append((random_dna(100, seed=5), ""))  # empty target
    # overflow: a mismatch every 7th base keeps the local score climbing
    # (+12 - 8 per period) while generating ~2 runs per period -> >64 runs
    t_ov = random_dna(480, seed=6)
    q_ov = "".join(
        ("A" if t_ov[i] != "A" else "C") if i % 7 == 3 else t_ov[i]
        for i in range(252)
    )
    pairs.append((q_ov, t_ov))
    # pad to a full 128-pair batch (the engine dispatches whole buckets)
    while len(pairs) % 128:
        pairs.append(("", ""))
    return pairs


def _check_extend_parity(pairs, Q, T, out, sw=PARAMS):
    """Compare a packed extend-program output against the sw_jax +
    host-traceback golden."""
    from rabbitsalign_tpu.ops.extend_device import (
        RLE_M,
        ops_to_cigars,
        unpack_output,
    )

    qc, tc, ql, tl = _pack(pairs, Q, T)
    score_g, t_end_g, q_end_g, dirs_g = map(
        np.asarray, sw_forward(qc, tc, ql, tl, sw)
    )
    golden_tb = traceback_batch(dirs_g, score_g, t_end_g, q_end_g, qc, tc)

    (op_runs, len_runs, n_runs, score, t_end, q_end, t_begin, q_begin,
     edits) = unpack_output(out)
    cigars = ops_to_cigars(op_runs, len_runs, n_runs, score)

    saw_overflow = False
    for b in range(len(pairs)):
        assert score[b] == score_g[b], (b, score[b], score_g[b])
        if score_g[b] == 0:
            assert golden_tb[b] is None
            continue
        assert t_end[b] == t_end_g[b] and q_end[b] == q_end_g[b], b
        gt_begin, gq_begin, gcigar, gedits = golden_tb[b]
        if int(n_runs[b]) == 0xFFFF:
            saw_overflow = True
            assert len(gcigar.ops) > RLE_M  # genuine overflow
            assert cigars[b] is None
            continue
        assert t_begin[b] == gt_begin and q_begin[b] == gq_begin, b
        assert edits[b] == gedits, b
        assert cigars[b] is not None, b
        assert str(cigars[b][0]) == str(gcigar), b
    if sw == PARAMS:
        assert saw_overflow, "overflow case must exercise the 0xFFFF marker"


SCORINGS = [
    SwParams(2, 8, 12, 1),   # defaults
    SwParams(1, 1, 2, 1),    # flat scoring: dense score ties
    SwParams(3, 2, 3, 0),    # free gap extension
]


def _packed_parity_input(Q, T):
    from rabbitsalign_tpu.ops.extend_device import pack_input

    pairs = _extend_parity_pairs(Q, T)
    qc, tc, ql, tl = _pack(pairs, Q, T)
    buf = pack_input(
        np.ascontiguousarray(qc.T), np.ascontiguousarray(tc.T), ql, tl
    )
    return pairs, buf


@pytest.mark.parametrize("sw", SCORINGS)
def test_portable_extend_matches_host_traceback(sw):
    """The XLA twin of the extend program — forward + in-walk RLE
    traceback + packed output — must match the host traceback golden on
    CPU, including degenerate scoring (dense ties, zero-cost gap
    extension)."""
    from rabbitsalign_tpu.ops.extend_device import extend_batch_packed, extend_program

    Q, T = 256, 512
    pairs, buf = _packed_parity_input(Q, T)
    out = np.asarray(extend_batch_packed(buf, Q, T, sw, extend_program("cpu")))
    _check_extend_parity(pairs, Q, T, out, sw)


@pytest.mark.parametrize("sw", SCORINGS)
def test_cuda_kernel_arithmetic_matches_xla_twin_on_host(sw):
    """The CUDA kernel's per-lane arithmetic (ops/cuda/sw_extend.cuh),
    compiled for the host with the warp's shuffles played out in a loop,
    must give the XLA twin's packed output byte for byte. Integer
    arithmetic throughout, so the comparison is exact equality."""
    from rabbitsalign_tpu.ops.extend_cuda import extend_host_emulated
    from rabbitsalign_tpu.ops.extend_device import extend_batch_packed, extend_program

    Q, T = 256, 512
    pairs, buf = _packed_parity_input(Q, T)
    twin = np.asarray(extend_batch_packed(buf, Q, T, sw, extend_program("cpu")))
    qc, tc, ql, tl = _pack(pairs, Q, T)
    emu = extend_host_emulated(qc.T, tc.T, ql, tl, sw)
    assert np.array_equal(emu, twin)
    _check_extend_parity(pairs, Q, T, emu, sw)


def test_cuda_wrapper_shapes_match_twin_layout():
    """The FFI wrapper's host-side geometry: rows per lane and the
    direction scratch per bucket, and an abstract trace of the wrapper
    giving exactly the XLA twin's packed (2*RLE_M + 14, B) u8 layout."""
    import jax
    import jax.numpy as jnp

    from rabbitsalign_tpu.ops import extend_cuda
    from rabbitsalign_tpu.ops.extend_device import OUT_ROWS, RLE_M
    from rabbitsalign_tpu.ops.extend_portable import extend_body as twin

    assert OUT_ROWS == 2 * RLE_M + 14
    for Q, R in ((1, 1), (32, 1), (33, 2), (152, 5), (160, 5), (161, 8),
                 (256, 8), (384, 12), (512, 16)):
        assert extend_cuda.rows_per_lane(Q) == R, Q
    with pytest.raises(ValueError):
        extend_cuda.rows_per_lane(513)
    # a pair's plane holds every diagonal by 32*R padded query rows
    assert extend_cuda.scratch_shape(152, 256, 1024) == (1024, 407 * 160)
    assert extend_cuda.scratch_shape(512, 2048, 512) == (512, 2559 * 512)
    for Q, T, B in ((152, 256, 64), (512, 2048, 8)):
        args = (jax.ShapeDtypeStruct((Q, B), jnp.uint8),
                jax.ShapeDtypeStruct((T, B), jnp.uint8),
                jax.ShapeDtypeStruct((B,), jnp.int32),
                jax.ShapeDtypeStruct((B,), jnp.int32))
        got = jax.eval_shape(
            lambda *a: extend_cuda.extend_body(*a, PARAMS, B), *args)
        want = jax.eval_shape(lambda *a: twin(*a, PARAMS, B), *args)
        assert (got.shape, got.dtype) == (want.shape, want.dtype) == (
            (OUT_ROWS, B), jnp.uint8)


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm", "neuron"])
def test_extend_program_per_platform(platform, monkeypatch):
    """One extend program per platform: cpu -> XLA twin, gpu -> CUDA
    kernel (built and registered on selection), anything else -> error,
    never a silent fallback."""
    from rabbitsalign_tpu.ops import extend_cuda, extend_portable
    from rabbitsalign_tpu.ops.extend_device import extend_program

    built = []
    monkeypatch.setattr(extend_cuda, "register", lambda: built.append(1))
    if platform == "cpu":
        assert extend_program(platform) is extend_portable.extend_body
        assert not built
    elif platform == "gpu":
        assert extend_program(platform) is extend_cuda.extend_body
        assert built == [1]
    else:
        with pytest.raises(RuntimeError, match="no extend program"):
            extend_program(platform)


BUCKETS = [(152, 256, 1024), (256, 512, 512), (256, 1536, 512),
           (512, 2048, 512)]  # native/engine.engine_buckets(150)


def _bucket_pairs(Q, T, B):
    """The parity pairs plus planted, N-laden and short pairs up to B."""
    r = random.Random(Q * 7 + T)
    pairs = [(q[:Q], t[:T]) for q, t in _extend_parity_pairs(Q, T)[:44]]
    while len(pairs) < B:
        i = len(pairs)
        core = random_dna(r.randint(8, Q), seed=5000 + i)
        if i % 9 == 0:
            core = "".join(c if r.random() > 0.05 else "N" for c in core)
        q = _mutate(core, r, r.randint(0, 5), r.randint(0, 2), r.randint(0, 2))[:Q]
        t = (random_dna(r.randint(0, 60), seed=i) + core
             + random_dna(r.randint(0, 60), seed=i + 1))[: r.randint(1, T)]
        pairs.append((q, t))
    return pairs


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BUCKETS, ids=lambda s: "x".join(map(str, s)))
def test_cuda_extend_matches_xla_twin_gpu(gpu, shape):
    """On the card, at every production bucket width: the CUDA kernel's
    packed output equals the XLA twin's byte for byte (integer
    arithmetic, so exact equality; TF32 and float rounding do not arise)
    and decodes to the sw_jax + host-traceback golden, at default and at
    tie-dense scoring, with N codes and lengths below the bucket shape."""
    import jax

    from rabbitsalign_tpu.ops.extend_device import (
        extend_batch_packed,
        extend_program,
        pack_input,
    )
    from rabbitsalign_tpu.ops.extend_portable import extend_body as twin

    Q, T, B = shape
    pairs = _bucket_pairs(Q, T, B)
    qc, tc, ql, tl = _pack(pairs, Q, T)
    buf = jax.device_put(pack_input(
        np.ascontiguousarray(qc.T), np.ascontiguousarray(tc.T), ql, tl))
    cuda = extend_program(gpu.platform)
    for sw in (PARAMS, SwParams(1, 1, 2, 1)):
        got = np.asarray(extend_batch_packed(buf, Q, T, sw, cuda))
        want = np.asarray(extend_batch_packed(buf, Q, T, sw, twin))
        assert np.array_equal(got, want), np.argwhere(got != want)[:8]
        _check_extend_parity(pairs, Q, T, got, sw)


def test_portable_extend_matches_striped_ssw_default_scoring():
    """The device kernel keeps the TEXTBOOK recurrence while host SSW is
    striped-exact (ssw.c semantics); the two provably coincide only for
    gap_open > gap_extend (the pipeline gates device dispatch off at
    O == E). This pins the O > E equivalence empirically: adversarial
    pairs at default scoring, full coordinate + cigar agreement between
    the XLA extend twin and ssw_align."""
    import re

    from rabbitsalign_tpu.ops.extend_device import (
        extend_batch_packed,
        extend_program,
        ops_to_cigars,
        pack_input,
        unpack_output,
    )

    def norm(cig):
        runs = re.findall(r"(\d+)([A-Z=])", cig)
        out = []
        for ln, op in runs:
            op = "M" if op in "=XM" else op
            if out and out[-1][1] == op:
                out[-1][0] += int(ln)
            else:
                out.append([int(ln), op])
        return "".join(f"{l}{o}" for l, o in out)

    rng = np.random.RandomState(99)
    pyr = random.Random(5150)
    Q, T, B = 152, 256, 128
    qc = np.full((B, Q), 4, np.uint8)
    tc = np.full((B, T), 4, np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        mode = b % 5
        m = pyr.randrange(30, 151)
        n = pyr.randrange(m, min(T, m + 120))
        if mode == 0:
            q = rng.randint(0, 4, m).astype(np.uint8)
            t = rng.randint(0, 4, n).astype(np.uint8)
            st = pyr.randrange(0, n - m + 1)
            t[st:st + m] = q
            for _ in range(m // 15):
                t[st + pyr.randrange(m)] = pyr.randrange(4)
        elif mode == 1:  # tandem repeats: tie-heavy
            u = pyr.randrange(3, 20)
            q = (np.arange(m) % u % 4).astype(np.uint8)
            t = (np.arange(n) % u % 4).astype(np.uint8)
        elif mode == 2:  # N runs
            q = rng.randint(0, 4, m).astype(np.uint8)
            p = pyr.randrange(0, max(1, m - 9))
            q[p:p + pyr.randrange(2, 8)] = 4
            t = rng.randint(0, 4, n).astype(np.uint8)
            st = pyr.randrange(0, n - m + 1)
            t[st:st + m] = np.where(q == 4, rng.randint(0, 4, m).astype(np.uint8), q)
        elif mode == 3:  # homopolymer
            q = np.zeros(m, np.uint8)
            t = np.zeros(n, np.uint8)
            for _ in range(4):
                t[pyr.randrange(n)] = pyr.randrange(4)
        else:
            q = rng.randint(0, 5, m).astype(np.uint8)
            t = rng.randint(0, 5, n).astype(np.uint8)
        qc[b, :m] = q
        tc[b, :n] = t
        ql[b] = m
        tl[b] = n
    buf = pack_input(np.ascontiguousarray(qc.T), np.ascontiguousarray(tc.T),
                     ql, tl)
    out = np.asarray(
        extend_batch_packed(buf, Q, T, PARAMS, extend_program("cpu")))
    (op_runs, len_runs, n_runs, score, t_end, q_end, t_begin, q_begin,
     edits) = unpack_output(out)
    cigars = ops_to_cigars(op_runs, len_runs, n_runs, score)
    for b in range(B):
        res = ssw_align(qc[b, :ql[b]].astype(np.int8),
                        tc[b, :tl[b]].astype(np.int8), 2, 8, 12, 1)
        if res.score1 == 0:
            assert score[b] == 0, b
            continue
        assert (int(score[b]), int(t_begin[b]), int(t_end[b]),
                int(q_begin[b]), int(q_end[b])) == (
            res.score1, res.ref_begin, res.ref_end, res.read_begin,
            res.read_end), b
        if cigars[b] is not None:
            assert norm(str(cigars[b][0])) == norm(str(res.cigar)), b
