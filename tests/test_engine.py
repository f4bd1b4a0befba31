"""Native engine vs Python pipeline: byte-identical output.

The C++ engine (native/engine.cpp) reimplements phase A/B of the chunk
pipeline; these tests drive both implementations over simulated reads
(SNPs, indels, reverse complements, unmappable reads, rescue-needing
mates) in every output mode and require byte-identical SAM/PAF text plus
matching statistics and insert-size state.
"""

import random

import pytest

from rabbitsalign_tpu.align.aligner import Aligner, AlignmentParameters
from rabbitsalign_tpu.index.params import IndexParameters
from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex
from rabbitsalign_tpu.io.fasta import References
from rabbitsalign_tpu.io.sam import CIGAR_OPS_EQX, CIGAR_OPS_M, Sam, SamRecord
from rabbitsalign_tpu.map.common import InsertSizeDistribution, MappingParameters
from rabbitsalign_tpu.map.randomness import MinstdRand
from rabbitsalign_tpu.map.stats import AlignmentStatistics
from rabbitsalign_tpu.ops.batch_extend import HostBatchAligner
from rabbitsalign_tpu.pipeline.batched import phase_a_chunk, phase_b_chunk

try:
    from rabbitsalign_tpu.native.engine import NativeEngine, engine_available

    HAVE_ENGINE = engine_available()
except Exception:  # pragma: no cover
    HAVE_ENGINE = False

pytestmark = pytest.mark.skipif(not HAVE_ENGINE, reason="native engine unavailable")


@pytest.fixture(scope="module")
def world():
    rng = random.Random(99)
    genome = "".join(rng.choice("ACGT") for _ in range(300_000))
    refs = References()
    refs.add("chr1", genome[:200_000].encode())
    refs.add("chr2", genome[200_000:].encode())
    params = IndexParameters.from_read_length(150)
    index = StrobemerIndex(refs, params)
    index.populate(0.0002)
    return genome, refs, params, index


def simulate_se(genome, n, seed=7):
    r = random.Random(seed)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    records = []
    for i in range(n):
        st = r.randrange(0, len(genome) - 160)
        rd = genome[st : st + 150]
        kind = i % 50
        if kind < 2:
            rd = "".join(r.choice("ACGT") for _ in range(150))
        else:
            ch = list(rd)
            for _ in range(3):
                p = r.randrange(150)
                ch[p] = r.choice("ACGT")
            rd = "".join(ch)
            if kind % 5 == 1:
                cut = r.randrange(40, 100)
                g = r.randrange(1, 6)
                rd = genome[st : st + cut] + genome[st + cut + g : st + 150 + g]
            if kind % 4 == 2:
                rd = "".join(comp[c] for c in reversed(rd))
        records.append(SamRecord(f"r{i}", rd.encode(), b"I" * len(rd)))
    return records


def simulate_pe(genome, n, seed=13):
    r = random.Random(seed)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    rec1, rec2 = [], []
    for i in range(n):
        st = r.randrange(0, len(genome) - 800)
        insert = max(170, min(700, int(r.gauss(300, 60))))
        f1 = genome[st : st + 150]
        f2 = "".join(comp[c] for c in reversed(genome[st + insert - 150 : st + insert]))

        def mut(s):
            ch = list(s)
            for _ in range(r.randrange(0, 4)):
                p = r.randrange(len(ch))
                ch[p] = r.choice("ACGT")
            return "".join(ch)

        f1, f2 = mut(f1), mut(f2)
        if i % 37 == 5:
            f2 = "".join(r.choice("ACGT") for _ in range(150))
        if i % 41 == 7:
            f1 = "".join(r.choice("ACGT") for _ in range(150))
        if i % 53 == 9:
            f1 = f1[:60] + genome[st + 63 : st + 153]
        rec1.append(SamRecord(f"p{i}/1", f1.encode(), b"I" * len(f1)))
        rec2.append(SamRecord(f"p{i}/2", f2.encode(), b"I" * len(f2)))
    return rec1, rec2


def run_python(world, chunks, mp, ap):
    _, refs, params, index = world
    aligner = Aligner(ap)
    batch = HostBatchAligner(ap)
    stats = AlignmentStatistics()
    isize = InsertSizeDistribution()
    cigar_ops = CIGAR_OPS_EQX if mp.cigar_eqx else CIGAR_OPS_M
    texts = []
    for ci, (r1, r2, r3) in enumerate(chunks):
        eng = MinstdRand(0)
        eng.seed(ci)
        paf = []
        sam = Sam(refs, cigar_ops, "", mp.output_unmapped, mp.details)
        work, _ = phase_a_chunk(
            r1, r2, r3, paf, isize, aligner, batch, mp, params, refs, index, eng
        )
        infos = batch.flush()
        phase_b_chunk(work, infos, sam, stats, isize, aligner, mp, params, refs, eng)
        texts.append(sam.take() if mp.is_sam_out else "".join(paf))
    return "".join(texts), stats, isize


def run_native(world, chunks, mp, ap):
    _, refs, params, index = world
    eng = NativeEngine(index, params, refs, ap, mp, "")
    texts = []
    for ci, (r1, r2, r3) in enumerate(chunks):
        texts.append(eng.chunk_b(eng.chunk_a(r1, r2, r3, ci)))
    return "".join(texts), eng


def _se_chunks(world, n=600, chunk=200):
    se = simulate_se(world[0], n)
    return [(se[i : i + chunk], [], []) for i in range(0, n, chunk)]


def _pe_chunks(world, n=450, chunk=150):
    r1, r2 = simulate_pe(world[0], n)
    return [(r1[i : i + chunk], r2[i : i + chunk], []) for i in range(0, n, chunk)]


def test_engine_se_default(world):
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * world[3].filter_cutoff, 1000)
    chunks = _se_chunks(world)
    py, stats, _ = run_python(world, chunks, mp, ap)
    na, eng = run_native(world, chunks, mp, ap)
    assert py == na
    c = eng.counters()
    assert c["tot_all_tried"] == stats.tot_all_tried
    assert c["inconsistent_nams"] == stats.inconsistent_nams
    assert c["nam_rescue"] == stats.nam_rescue
    assert c["tot_rescued"] == stats.tot_rescued


def test_engine_se_modes(world):
    ap = AlignmentParameters()
    mp = MappingParameters(
        r=150, max_secondary=3, cigar_eqx=True, details=True, output_unmapped=False
    )
    mp.rescue_cutoff = min(2 * world[3].filter_cutoff, 1000)
    chunks = _se_chunks(world)
    py, _, _ = run_python(world, chunks, mp, ap)
    na, _ = run_native(world, chunks, mp, ap)
    assert py == na


def test_engine_pe_default(world):
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * world[3].filter_cutoff, 1000)
    chunks = _pe_chunks(world)
    py, stats, isize = run_python(world, chunks, mp, ap)
    na, eng = run_native(world, chunks, mp, ap)
    assert py == na
    mu, sigma, n = eng.isize()
    assert mu == pytest.approx(isize.mu, abs=1e-9)
    assert n == isize.sample_size
    assert eng.counters()["tot_rescued"] == stats.tot_rescued


def test_engine_pe_details_secondary(world):
    ap = AlignmentParameters()
    mp = MappingParameters(r=150, max_secondary=2, details=True)
    mp.rescue_cutoff = min(2 * world[3].filter_cutoff, 1000)
    chunks = _pe_chunks(world)
    py, _, _ = run_python(world, chunks, mp, ap)
    na, _ = run_native(world, chunks, mp, ap)
    assert py == na


def test_engine_paf(world):
    ap = AlignmentParameters()
    mp = MappingParameters(r=150, is_sam_out=False)
    mp.rescue_cutoff = min(2 * world[3].filter_cutoff, 1000)
    py, _, _ = run_python(world, _se_chunks(world), mp, ap)
    na, _ = run_native(world, _se_chunks(world), mp, ap)
    assert py == na
    py, _, _ = run_python(world, _pe_chunks(world), mp, ap)
    na, _ = run_native(world, _pe_chunks(world), mp, ap)
    assert py == na


def test_engine_synthetic_device_results(world):
    """The C++ device-output ingestion (decode + validation + end-bonus
    post-processing) must match host alignment when fed a faithful packed
    buffer, and must fall back to the host aligner on corrupt cigars."""
    import numpy as np

    from rabbitsalign_tpu.align.cigar import (
        CIGAR_DEL,
        CIGAR_EQ,
        CIGAR_INS,
        CIGAR_X,
    )

    _, refs, params, index = world
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)
    chunks = _pe_chunks(world, n=150, chunk=150)

    # golden: everything host-resolved
    golden, _ = run_native(world, chunks, mp, ap)

    # device-fed: build the packed output buffer from raw (pre-end-bonus)
    # host SSW results, exactly what the kernel would return
    from rabbitsalign_tpu.align.cigar import CIGAR_MATCH
    from rabbitsalign_tpu.align.ssw import ssw_align

    eng = NativeEngine(index, params, refs, ap, mp, "")
    eng.MIN_DEVICE_JOBS = 1  # force every batch through the device path
    texts = []
    for ci, (r1, r2, r3) in enumerate(chunks):
        ch = eng.chunk_a(r1, r2, r3, ci)
        from rabbitsalign_tpu.ops.extend_device import RLE_M

        for idxs, Q, T, B, sub in eng.plan_batches(ch, 64):
            buf = eng.fill_batch(ch, idxs, B, Q, T)
            D = Q + T - 1
            out = np.zeros((2 * RLE_M + 14, B), dtype=np.uint8)
            for col, j in enumerate(idxs):
                qn = int(ch.qlens[j])
                tn = int(ch.tlens[j])
                qc = buf[:qn, col]
                tc = buf[Q : Q + tn, col]
                res = ssw_align(qc, tc, ap.match, ap.mismatch, ap.gap_open,
                                ap.gap_extend)
                if res.score1 == 0 or res.flag != 0:
                    continue  # score row stays 0 -> failed-info path
                # per-base device op stream, then RLE as the kernel would
                stream = []
                edits = 0
                qi, ti = res.read_begin, res.ref_begin
                for op_len in res.cigar.ops:
                    op = op_len & 0xF
                    for _ in range(op_len >> 4):
                        if op == CIGAR_MATCH:
                            if qc[qi] == tc[ti]:
                                stream.append(1)  # EQ
                            else:
                                stream.append(2)  # X
                                edits += 1
                            qi += 1
                            ti += 1
                        elif op == CIGAR_INS:
                            stream.append(3)
                            qi += 1
                            edits += 1
                        else:
                            stream.append(4)  # DEL
                            ti += 1
                            edits += 1
                runs = []
                for v in stream:
                    if runs and runs[-1][0] == v:
                        runs[-1][1] += 1
                    else:
                        runs.append([v, 1])
                # runs live at slots [M - n_runs, M) in forward order
                # (the extend programs' descending-slot layout), 2 bytes per run:
                # length lo, then (op << 5) | (length >> 8)
                off = RLE_M - min(len(runs), RLE_M)
                for r, (v, ln) in enumerate(runs[:RLE_M]):
                    out[off + r, col] = ln & 0xFF
                    out[RLE_M + off + r, col] = (v << 5) | ((ln >> 8) & 0x1F)
                n_runs = len(runs) if len(runs) <= RLE_M else 0xFFFF
                vals = [
                    res.score1, res.ref_end, res.read_end,
                    res.ref_begin, res.read_begin, edits, n_runs,
                ]
                for vi, v in enumerate(vals):
                    out[2 * RLE_M + 2 * vi, col] = v & 0xFF
                    out[2 * RLE_M + 2 * vi + 1, col] = (v >> 8) & 0xFF
                if col % 2 == 1:
                    # corrupt the stream (op bits zeroed) on every other
                    # valid column: must trigger host fallback (col % 7
                    # left small batches with no corrupted column at all
                    # once the tight bucket split the job list)
                    out[RLE_M : 2 * RLE_M, col] = 0
            eng.set_device_results(ch, out, D, np.asarray(idxs))
        texts.append(eng.chunk_b(ch))
    assert "".join(texts) == golden
    assert eng.counters()["fallbacks"] > 0


def test_engine_device_parity(world):
    """Device-dispatched extension must match the host-resolved engine
    byte for byte (validation + end-bonus post-processing identical).
    On the CPU test mesh this drives the XLA twin round-robined over all
    8 virtual devices with per-device resident reference pages — the
    multi-device production dispatch path; on a GPU (run with
    RABBITSALIGN_TEST_GPU=1) the same run uses the CUDA kernel."""
    import jax
    import numpy as np

    from rabbitsalign_tpu.pipeline.native_pipeline import NativePipeline

    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * world[3].filter_cutoff, 1000)
    chunks = _pe_chunks(world, n=300, chunk=150)

    dispatched = []

    def run(use_device):
        pipe = NativePipeline(world[3], world[2], world[1], ap, mp,
                              use_device=use_device)
        if jax.devices()[0].platform == "cpu":
            # small batches so several dispatches round-robin across the
            # virtual devices (on a GPU keep the production bucket shapes)
            pipe.batch_size = 64
        pipe.engine.MIN_DEVICE_JOBS = 1
        texts = []
        pipe.map_all(
            ((ci, a, b, c) for ci, (a, b, c) in enumerate(chunks)),
            texts.append,
        )
        if use_device:
            dispatched.append(pipe._next_dev)
        return b"".join(texts)

    assert run(False) == run(True)
    if len(jax.devices()) > 1:
        # the round-robin actually visited multiple devices
        assert dispatched[0] >= 2


def test_native_index_build_matches_numpy(world):
    """Native index build (seeding + sort in C++) must produce arrays
    identical to the numpy path, including bucket table and cutoff."""
    import os

    import numpy as np

    import rabbitsalign_tpu.native as nat
    from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex

    genome, refs, params, _ = world
    ix_native = StrobemerIndex(refs, params)
    ix_native.populate(0.0002, 2)

    os.environ["RABBITSALIGN_TPU_NO_NATIVE"] = "1"
    nat._tried, nat._lib = False, None
    try:
        ix_np = StrobemerIndex(refs, params)
        ix_np.populate(0.0002, 1)
    finally:
        del os.environ["RABBITSALIGN_TPU_NO_NATIVE"]
        nat._tried, nat._lib = False, None

    assert np.array_equal(ix_native.hashes, ix_np.hashes)
    assert np.array_equal(ix_native.positions, ix_np.positions)
    assert np.array_equal(ix_native.packed, ix_np.packed)
    assert np.array_equal(
        ix_native.randstrobe_start_indices, ix_np.randstrobe_start_indices
    )
    assert ix_native.filter_cutoff == ix_np.filter_cutoff


def test_native_reader_matches_python_input(world, tmp_path):
    """The native chunked FASTQ reader + chunk_a_fx must produce the same
    SAM text as Python-parsed records through chunk_a, for SE, PE and
    interleaved (pair + orphan) inputs, plain and gzipped."""
    import gzip

    from rabbitsalign_tpu.io.fastq import InputBuffer
    from rabbitsalign_tpu.native.engine import NativeReader

    genome, refs, params, index = world
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)

    se = simulate_se(genome, 260)
    r1, r2 = simulate_pe(genome, 200)

    def fq(recs):
        return b"".join(
            f"@{r.name} extra comment\n".encode() + r.seq + b"\n+\n" + r.qual + b"\n"
            for r in recs
        )

    p_se = tmp_path / "se.fq"
    p_se.write_bytes(fq(se))
    p_r1 = tmp_path / "r1.fq.gz"
    p_r1.write_bytes(gzip.compress(fq(r1)))
    p_r2 = tmp_path / "r2.fq.gz"
    p_r2.write_bytes(gzip.compress(fq(r2)))
    # interleaved with an orphan in the middle
    inter = []
    for i, (a, b) in enumerate(zip(r1, r2)):
        inter.append(a)
        if i == 57:
            continue  # drop the mate -> orphan
        inter.append(b)
    p_il = tmp_path / "il.fq"
    p_il.write_bytes(fq(inter))

    def via_python(path1, path2="", interleaved=False):
        eng = NativeEngine(index, params, refs, ap, mp, "")
        texts = []
        for ci, a, b, c in InputBuffer(str(path1), str(path2) if path2 else "",
                                       100, interleaved).chunks():
            texts.append(eng.chunk_b(eng.chunk_a(a, b, c, ci)))
        return "".join(texts)

    def via_native(path1, path2="", interleaved=False):
        eng = NativeEngine(index, params, refs, ap, mp, "")
        reader = NativeReader(str(path1), str(path2) if path2 else "",
                              interleaved, 100)
        texts = []
        for ci, fx, _, _ in reader:
            ch = eng.chunk_a_fx(fx, ci)
            reader.free_chunk(fx)
            texts.append(eng.chunk_b(ch))
        reader.close()
        return "".join(texts)

    assert via_python(p_se) == via_native(p_se)
    assert via_python(p_r1, p_r2) == via_native(p_r1, p_r2)
    assert via_python(p_il, interleaved=True) == via_native(p_il, interleaved=True)


def test_threaded_pipeline_se_identical(world, tmp_path):
    """SE mapping has no cross-chunk state, so the N-worker pipeline must
    produce byte-identical (ordered) output for any worker count."""
    from rabbitsalign_tpu.pipeline.native_pipeline import (
        NativePipeline,
        ThreadedNativePipeline,
    )

    genome, refs, params, index = world
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)

    se = simulate_se(genome, 500)
    p_se = tmp_path / "se.fq"
    p_se.write_bytes(b"".join(
        f"@{r.name}\n".encode() + r.seq + b"\n+\n" + r.qual + b"\n" for r in se
    ))

    def run_seq():
        out = []
        pipe = NativePipeline(index, params, refs, ap, mp, use_device=False)
        n = pipe.map_file(str(p_se), "", False, 64, out.append)
        return n, b"".join(out)

    def run_threaded(workers):
        out = []
        pipe = ThreadedNativePipeline(index, params, refs, ap, mp,
                                      use_device=False, n_workers=workers)
        n = pipe.map_file(str(p_se), "", False, 64, out.append)
        return n, b"".join(out)

    n0, t0 = run_seq()
    assert n0 == 500
    for workers in (1, 3):
        n, t = run_threaded(workers)
        assert n == 500
        assert t == t0

    # --pin-workers: identical output, and each worker actually pinned
    # to one allowed CPU (round-robin; reference pc.cpp:519-527 analog)
    import os

    out = []
    pipe = ThreadedNativePipeline(index, params, refs, ap, mp,
                                  use_device=False, n_workers=3,
                                  pin_workers=True)
    n = pipe.map_file(str(p_se), "", False, 64, out.append)
    assert n == 500 and b"".join(out) == t0
    allowed = sorted(os.sched_getaffinity(0))
    assert len(pipe.pinned_cpus) == 3
    for wid, cpu in pipe.pinned_cpus:
        assert cpu == allowed[wid % len(allowed)]
    # restore this thread's mask in case a worker pin leaked (it must
    # not: pinning happens on the worker threads)
    assert sorted(os.sched_getaffinity(0)) == allowed


def test_threaded_pipeline_pe_runs(world, tmp_path):
    """PE threaded output depends on worker scheduling (per-worker
    insert-size state, like the reference); check record count/flags."""
    from rabbitsalign_tpu.pipeline.native_pipeline import ThreadedNativePipeline

    genome, refs, params, index = world
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)

    r1, r2 = simulate_pe(genome, 300)

    def fq(recs):
        return b"".join(
            f"@{r.name}\n".encode() + r.seq + b"\n+\n" + r.qual + b"\n" for r in recs
        )

    p1 = tmp_path / "t1.fq"
    p1.write_bytes(fq(r1))
    p2 = tmp_path / "t2.fq"
    p2.write_bytes(fq(r2))

    out = []
    pipe = ThreadedNativePipeline(index, params, refs, ap, mp,
                                  use_device=False, n_workers=2)
    n = pipe.map_file(str(p1), str(p2), False, 50, out.append)
    assert n == 600
    lines = [l for l in b"".join(out).decode().splitlines() if l]
    assert len(lines) == 600
    # ordered by chunk: read names must appear in input order
    names = [l.split("\t")[0] for l in lines if not (int(l.split("\t")[1]) & 0x100)]
    assert names == [f"p{i}" for i in range(300) for _ in (0, 1)]


def test_threaded_pipeline_pe_deterministic(world, tmp_path):
    """With deterministic round-robin chunk handout, the N-worker PE
    output is a pure function of (input, n_workers): repeat runs must be
    byte-identical (the per-worker insert-size history is fixed by the
    chunk routing), and 1 deterministic worker equals the sequential
    pipeline exactly."""
    from rabbitsalign_tpu.pipeline.native_pipeline import (
        NativePipeline,
        ThreadedNativePipeline,
    )

    genome, refs, params, index = world
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)

    r1, r2 = simulate_pe(genome, 300)

    def fq(recs):
        return b"".join(
            f"@{r.name}\n".encode() + r.seq + b"\n+\n" + r.qual + b"\n" for r in recs
        )

    p1 = tmp_path / "d1.fq"
    p1.write_bytes(fq(r1))
    p2 = tmp_path / "d2.fq"
    p2.write_bytes(fq(r2))

    def run(workers):
        out = []
        pipe = ThreadedNativePipeline(index, params, refs, ap, mp,
                                      use_device=False, n_workers=workers,
                                      deterministic=True)
        n = pipe.map_file(str(p1), str(p2), False, 50, out.append)
        assert n == 600
        return b"".join(out)

    a = run(3)
    b = run(3)
    assert a == b, "deterministic 3-worker PE runs must be byte-identical"

    out_seq = []
    pipe = NativePipeline(index, params, refs, ap, mp, use_device=False)
    pipe.map_file(str(p1), str(p2), False, 50, out_seq.append)
    assert run(1) == b"".join(out_seq)


def test_multihost_shard_merge(world, tmp_path):
    """Simulate a 2-host run in one process: each 'host' maps its chunk
    shard through map_file_sharded; the merged output must equal the
    single-host run byte for byte (SE: no cross-chunk state)."""
    from rabbitsalign_tpu.parallel.multihost import ShardWriter, merge_output
    from rabbitsalign_tpu.pipeline.native_pipeline import NativePipeline

    genome, refs, params, index = world
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)

    se = simulate_se(genome, 400)
    p_se = tmp_path / "mh.fq"
    p_se.write_bytes(b"".join(
        f"@{r.name}\n".encode() + r.seq + b"\n+\n" + r.qual + b"\n" for r in se
    ))

    golden = []
    pipe = NativePipeline(index, params, refs, ap, mp, use_device=False)
    pipe.map_file(str(p_se), "", False, 64, golden.append)
    golden_text = b"".join(golden)

    base = str(tmp_path / "mh.sam")
    total = 0
    for pid in (0, 1):
        pipe = NativePipeline(index, params, refs, ap, mp, use_device=False)
        w = ShardWriter(base, pid, 2)
        total += pipe.map_file_sharded(str(p_se), "", False, 64, w, pid, 2)
        w.close()
    assert total == 400
    merge_output(base, 2, header="")
    assert open(base, "rb").read() == golden_text


def test_engine_edge_cases(world, tmp_path):
    """Short reads (< w_max), N runs, FASTA reads (no qual), and empty
    input must behave identically in both implementations."""
    from rabbitsalign_tpu.io.fastq import InputBuffer
    from rabbitsalign_tpu.native.engine import NativeReader

    genome, refs, params, index = world
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)

    recs = []
    r = random.Random(3)
    st = 1000
    full = genome[st : st + 150]
    recs.append(SamRecord("tiny", b"ACGT", b"IIII"))  # < w_max
    recs.append(SamRecord("short", genome[st : st + 30].encode(), b"I" * 30))
    nny = list(full)
    for p in range(40, 60):
        nny[p] = "N"
    recs.append(SamRecord("nrun", "".join(nny).encode(), b"I" * 150))
    recs.append(SamRecord("allN", b"N" * 150, b"I" * 150))
    recs.append(SamRecord("good", full.encode(), b"I" * 150))

    eng = NativeEngine(index, params, refs, ap, mp, "")
    na = eng.chunk_b(eng.chunk_a(recs, [], [], 0))

    from rabbitsalign_tpu.ops.batch_extend import HostBatchAligner

    aligner = Aligner(ap)
    batch = HostBatchAligner(ap)
    stats = AlignmentStatistics()
    isize = InsertSizeDistribution()
    rng_e = MinstdRand(0)
    rng_e.seed(0)
    sam = Sam(refs, CIGAR_OPS_M, "", True, False)
    work, _ = phase_a_chunk(recs, [], [], [], isize, aligner, batch, mp,
                            params, refs, index, rng_e)
    phase_b_chunk(work, batch.flush(), sam, stats, isize, aligner, mp, params,
                  refs, rng_e)
    assert sam.take() == na

    # FASTA used as reads: qual must print '*'
    fa = tmp_path / "reads.fa"
    fa.write_bytes(b">fx1 comment\n" + full.encode() + b"\n>fx2\nACGT\n")
    eng2 = NativeEngine(index, params, refs, ap, mp, "")
    reader = NativeReader(str(fa), "", False, 10)
    texts = []
    for ci, fx, _, _ in reader:
        ch = eng2.chunk_a_fx(fx, ci)
        reader.free_chunk(fx)
        texts.append(eng2.chunk_b(ch))
    reader.close()
    native_fa = "".join(texts)
    eng3 = NativeEngine(index, params, refs, ap, mp, "")
    py_texts = []
    for ci, a, b, c in InputBuffer(str(fa), "", 10, False).chunks():
        py_texts.append(eng3.chunk_b(eng3.chunk_a(a, b, c, ci)))
    assert native_fa == "".join(py_texts)
    assert "\t*\n" in native_fa or native_fa.rstrip().endswith("*")

    # empty input file
    empty = tmp_path / "empty.fq"
    empty.write_bytes(b"")
    reader = NativeReader(str(empty), "", False, 10)
    assert list(reader) == []
    reader.close()


@pytest.mark.parametrize("producer", [False, True])
def test_native_reader_error_contract(tmp_path, producer):
    """Malformed input: COMPLETE chunks parsed before the error are
    yielded, the partial chunk from the failing parse is never surfaced,
    then ValueError — identical in the sync and producer-thread modes."""
    from rabbitsalign_tpu.native.engine import NativeReader, engine_available

    if not engine_available():
        pytest.skip("native engine unavailable")

    fq = tmp_path / "bad.fq"
    with open(fq, "wb") as f:
        for i in range(25):
            f.write(b"@r%d\nACGTACGTACGT\n+\nIIIIIIIIIIII\n" % i)
        f.write(b"not-a-header\nACGT\n+\nIIII\n")

    reader = NativeReader(str(fq), "", False, 10, producer=producer)
    seen = []
    with pytest.raises(ValueError, match="malformed FASTQ"):
        for ci, ch, n_pairs, n_singles in reader:
            seen.append((ci, n_pairs, n_singles))
            reader.free_chunk(ch)
    reader.close()
    # chunks 0 and 1 (10 records each) are complete; the third chunk
    # contains the failing record and must not surface its 5 good reads
    assert seen == [(0, 0, 10), (1, 0, 10)]

    # PE length mismatch (error 3): same contract
    fq1 = tmp_path / "p1.fq"
    fq2 = tmp_path / "p2.fq"
    with open(fq1, "wb") as f:
        for i in range(12):
            f.write(b"@p%d\nACGTACGTACGT\n+\nIIIIIIIIIIII\n" % i)
    with open(fq2, "wb") as f:
        for i in range(7):
            f.write(b"@p%d\nACGTACGTACGT\n+\nIIIIIIIIIIII\n" % i)
    reader = NativeReader(str(fq1), str(fq2), False, 10, producer=producer)
    seen = []
    with pytest.raises(ValueError, match="different lengths"):
        for ci, ch, n_pairs, n_singles in reader:
            seen.append((ci, n_pairs, n_singles))
            reader.free_chunk(ch)
    reader.close()
    assert seen == []  # pair 8 of chunk 0 fails -> whole chunk dropped

    # symmetric: file2 LONGER is an error too, not silently dropped
    reader = NativeReader(str(fq2), str(fq1), False, 10, producer=producer)
    with pytest.raises(ValueError, match="different lengths"):
        for ci, ch, n_pairs, n_singles in reader:
            reader.free_chunk(ch)
    reader.close()

    # trailing blank lines are NOT an error (ubiquitous in real files;
    # the reference's production RabbitFX parser stops cleanly there)
    ok = tmp_path / "trail.fq"
    with open(ok, "wb") as f:
        for i in range(12):
            f.write(b"@t%d\nACGTACGTACGT\n+\nIIIIIIIIIIII\n" % i)
        f.write(b"\n\n")
    reader = NativeReader(str(ok), "", False, 10, producer=producer)
    total = 0
    for ci, ch, n_pairs, n_singles in reader:
        total += n_singles
        reader.free_chunk(ch)
    reader.close()
    assert total == 12

    from rabbitsalign_tpu.io.fastq import parse_fastx

    assert len(list(parse_fastx(str(ok)))) == 12  # Python twin agrees


@pytest.mark.parametrize("cfg", [
    # (k, s, l, u, A, B, O, E, L)
    (18, 14, 0, 7, 1, 4, 6, 2, 5),
    (22, 18, 2, 12, 3, 5, 9, 2, 15),
])
def test_engine_nondefault_parameters(world, cfg):
    """Engine vs Python with non-default seeding and scoring parameters
    (the concordance tests pin the defaults; this guards the plumbing)."""
    from rabbitsalign_tpu.index.params import DEFAULT

    k, s, l, u, A, B, O, E, L = cfg
    genome, refs, _, _ = world
    params = IndexParameters.from_read_length(150, k=k, s=s, l=l, u=u)
    index = StrobemerIndex(refs, params)
    index.populate(0.0002)
    w = (genome, refs, params, index)
    ap = AlignmentParameters(match=A, mismatch=B, gap_open=O, gap_extend=E,
                             end_bonus=L)
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)

    se = simulate_se(genome, 300, seed=k * 100 + s)
    chunks = [(se[i : i + 100], [], []) for i in range(0, 300, 100)]
    py, _, _ = run_python(w, chunks, mp, ap)
    na, _ = run_native(w, chunks, mp, ap)
    assert py == na

    r1, r2 = simulate_pe(genome, 200, seed=k * 7)
    chunks = [(r1[i : i + 100], r2[i : i + 100], []) for i in range(0, 200, 100)]
    py, _, _ = run_python(w, chunks, mp, ap)
    na, _ = run_native(w, chunks, mp, ap)
    assert py == na


def test_device_seed_mode_identical(world, tmp_path):
    """--device-seed: vectorized seeding + batched index find on the
    accelerator (CPU jax here — the ops are pure jnp), preseeded phase A
    in the engine. Output must be byte-identical to the host-seeded
    pipeline for SE and PE (tie rows and long reads fall back to host
    seeding per read)."""
    from rabbitsalign_tpu.pipeline.native_pipeline import NativePipeline

    genome, refs, params, index = world
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)

    se = simulate_se(genome, 400)
    p_se = tmp_path / "ds.fq"
    p_se.write_bytes(b"".join(
        f"@{r.name}\n".encode() + r.seq + b"\n+\n" + r.qual + b"\n" for r in se
    ))
    r1, r2 = simulate_pe(genome, 200)
    p1 = tmp_path / "ds1.fq"
    p2 = tmp_path / "ds2.fq"
    p1.write_bytes(b"".join(
        f"@{r.name}\n".encode() + r.seq + b"\n+\n" + r.qual + b"\n" for r in r1
    ))
    p2.write_bytes(b"".join(
        f"@{r.name}\n".encode() + r.seq + b"\n+\n" + r.qual + b"\n" for r in r2
    ))

    def run(path1, path2, device_seed):
        pipe = NativePipeline(index, params, refs, ap, mp,
                              use_device=True, device_seed=device_seed)
        out = []
        n = pipe.map_file(str(path1), str(path2) if path2 else "", False,
                          64, out.append)
        return n, b"".join(out)

    n0, host_se = run(p_se, None, False)
    n1, dev_se = run(p_se, None, True)
    assert (n0, n1) == (400, 400)
    assert dev_se == host_se

    n0, host_pe = run(p1, p2, False)
    n1, dev_pe = run(p1, p2, True)
    assert (n0, n1) == (400, 400)
    assert dev_pe == host_pe


def test_threaded_device_seed_identical(world, tmp_path):
    """--device-seed through the N-worker pipeline (each worker runs the
    preseed dispatch on its own engine): SE output must stay
    byte-identical to the sequential host-seeded run."""
    from rabbitsalign_tpu.pipeline.native_pipeline import (
        NativePipeline,
        ThreadedNativePipeline,
    )

    genome, refs, params, index = world
    ap = AlignmentParameters()
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = min(2 * index.filter_cutoff, 1000)

    se = simulate_se(genome, 300)
    p_se = tmp_path / "tds.fq"
    p_se.write_bytes(b"".join(
        f"@{r.name}\n".encode() + r.seq + b"\n+\n" + r.qual + b"\n" for r in se
    ))

    golden = []
    pipe = NativePipeline(index, params, refs, ap, mp, use_device=False)
    pipe.map_file(str(p_se), "", False, 64, golden.append)

    out = []
    tp = ThreadedNativePipeline(index, params, refs, ap, mp,
                                use_device=True, n_workers=2,
                                device_seed=True)
    n = tp.map_file(str(p_se), "", False, 64, out.append)
    assert n == 300
    assert b"".join(out) == b"".join(golden)
