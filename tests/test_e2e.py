"""End-to-end mapping tests through the CLI entry point."""

import random

import pytest

from rabbitsalign_tpu.cli import main
from rabbitsalign_tpu.utils.dna import reverse_complement

from .util import random_dna


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    random.seed(2025)
    tmp = tmp_path_factory.mktemp("e2e")
    genome = random_dna(80_000)
    ref = tmp / "ref.fa"
    with open(ref, "w") as f:
        f.write(">chr1 test\n")
        for j in range(0, len(genome), 70):
            f.write(genome[j : j + 70] + "\n")
    return tmp, genome, str(ref)


def simulate_se(genome, n=60):
    reads, truth = [], []
    for i in range(n):
        st = random.randrange(0, len(genome) - 150)
        rd = genome[st : st + 150]
        kind = i % 4
        if kind == 1:
            chars = list(rd)
            for _ in range(3):
                chars[random.randrange(150)] = random.choice("ACGT")
            rd = "".join(chars)
        elif kind == 2:
            rd = reverse_complement(rd).decode()
        elif kind == 3:
            rd = genome[st : st + 70] + genome[st + 74 : st + 154]
        reads.append(rd)
        truth.append(st)
    return reads, truth


def write_fastq(path, reads, prefix="r"):
    with open(path, "w") as f:
        for i, rd in enumerate(reads):
            f.write(f"@{prefix}{i}\n{rd}\n+\n{'I' * len(rd)}\n")


def test_se_sam(dataset):
    tmp, genome, ref = dataset
    random.seed(5)
    reads, truth = simulate_se(genome)
    fq = tmp / "se.fq"
    write_fastq(fq, reads)
    out = tmp / "se.sam"
    assert main(["--no-tpu", ref, str(fq), "-o", str(out)]) == 0
    lines = [l.split("\t") for l in open(out) if not l.startswith("@")]
    assert len(lines) == len(reads)
    placed = 0
    for fields, st in zip(lines, truth):
        flag = int(fields[1])
        if flag & 4:
            continue
        assert abs(int(fields[3]) - 1 - st) <= 5
        placed += 1
    assert placed == len(reads)
    # header sanity
    header = [l for l in open(out) if l.startswith("@")]
    assert any(l.startswith("@SQ\tSN:chr1\tLN:80000") for l in header)


def test_se_device_cli_matches_host(dataset, capsys):
    """The CLI's device path on CPU (the XLA twin, prewarmed before
    mapping) gives the --no-tpu SAM byte for byte, says what it extends
    on, and counts the pairs it extended."""
    tmp, genome, ref = dataset
    random.seed(8)
    reads, _ = simulate_se(genome, 240)
    fq = tmp / "se_dev.fq"
    write_fastq(fq, reads)
    outs = {}
    for mode in ("device", "host"):
        out = tmp / f"se_{mode}.sam"
        flags = ["--tpu-batch", "64"] if mode == "device" else ["--no-tpu"]
        assert main(flags + ["-t", "2", ref, str(fq), "-o", str(out)]) == 0
        outs[mode] = [l for l in open(out) if not l.startswith("@PG")]
        log = capsys.readouterr().err
        if mode == "device":
            assert "Extending on cpu" in log and "XLA twin" in log
            assert "Extend programs ready" in log
            pairs = int(log.split("Device-extended pairs: ")[1].split()[0])
            assert pairs > 0
    assert outs["device"] == outs["host"]


def test_se_paf(dataset):
    tmp, genome, ref = dataset
    random.seed(6)
    reads, truth = simulate_se(genome, 30)
    fq = tmp / "se2.fq"
    write_fastq(fq, reads)
    out = tmp / "se.paf"
    assert main(["--no-tpu", "-x", ref, str(fq), "-o", str(out)]) == 0
    lines = [l.split("\t") for l in open(out)]
    assert len(lines) >= 25
    for fields in lines:
        assert fields[5] == "chr1"
        assert fields[11].strip() == "255"


def test_pe_sam(dataset):
    tmp, genome, ref = dataset
    random.seed(7)
    r1s, r2s, truth = [], [], []
    for i in range(60):
        insert = random.randint(200, 450)
        st = random.randrange(0, len(genome) - insert)
        frag = genome[st : st + insert]
        r1s.append(frag[:150])
        r2s.append(reverse_complement(frag[-150:]).decode())
        truth.append((st, st + insert - 150))
    fq1, fq2 = tmp / "pe1.fq", tmp / "pe2.fq"
    write_fastq(fq1, r1s, "p")
    write_fastq(fq2, r2s, "p")
    out = tmp / "pe.sam"
    assert main(["--no-tpu", ref, str(fq1), str(fq2), "-o", str(out)]) == 0
    lines = [l.split("\t") for l in open(out) if not l.startswith("@")]
    assert len(lines) == 120
    proper = 0
    for i in range(0, len(lines), 2):
        f1, f2 = lines[i], lines[i + 1]
        st1, st2 = truth[i // 2]
        assert int(f1[1]) & 64  # READ1
        assert int(f2[1]) & 128  # READ2
        if int(f1[1]) & 2:
            proper += 1
            tlen1, tlen2 = int(f1[8]), int(f2[8])
            assert tlen1 == -tlen2 and tlen1 != 0
        assert abs(int(f1[3]) - 1 - st1) <= 5
        assert abs(int(f2[3]) - 1 - st2) <= 5
    assert proper >= 55


def test_create_and_use_index(dataset):
    tmp, genome, ref = dataset
    random.seed(8)
    reads, truth = simulate_se(genome, 20)
    fq = tmp / "idx.fq"
    write_fastq(fq, reads)
    assert main(["-i", ref, str(fq)]) == 0
    out1 = tmp / "a.sam"
    out2 = tmp / "b.sam"
    assert main(["--no-tpu", ref, str(fq), "-o", str(out1)]) == 0
    assert main(["--no-tpu", "--use-index", ref, str(fq), "-o", str(out2)]) == 0
    body1 = [l for l in open(out1) if not l.startswith("@")]
    body2 = [l for l in open(out2) if not l.startswith("@")]
    assert body1 == body2


def test_unmapped_suppression(dataset):
    tmp, genome, ref = dataset
    junk = ["".join(random.choice("ACGT") for _ in range(150)) for _ in range(5)]
    fq = tmp / "junk.fq"
    write_fastq(fq, junk)
    out = tmp / "junk.sam"
    assert main(["--no-tpu", "-U", ref, str(fq), "-o", str(out)]) == 0
    body = [l for l in open(out) if not l.startswith("@")]
    assert body == []


def test_eqx_and_rg(dataset):
    tmp, genome, ref = dataset
    st = 1000
    fq = tmp / "one.fq"
    write_fastq(fq, [genome[st : st + 150]])
    out = tmp / "one.sam"
    assert main([
        "--no-tpu", "--eqx", "--rg-id", "rg1", "--rg", "SM:sample1",
        ref, str(fq), "-o", str(out),
    ]) == 0
    content = open(out).read()
    assert "@RG\tID:rg1\tSM:sample1" in content
    body = [l for l in content.splitlines() if not l.startswith("@")]
    assert "150=" in body[0]
    assert "RG:Z:rg1" in body[0]


def validate_sam(text: str, ref_lengths: dict):
    """Light SAM-spec validation (the role of Picard ValidateSamFile in
    the reference's CI, .github/workflows/ci.yml:104-108): flag
    consistency, 1-based positions in range, CIGAR query-length == SEQ
    length, TLEN antisymmetry within pairs."""
    pairs = {}
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("@"):
            continue
        f = line.split("\t")
        assert len(f) >= 11, line
        flag, rname, pos, cigar, seq = int(f[1]), f[2], int(f[3]), f[5], f[9]
        n += 1
        if flag & 0x4:
            assert pos == 0 or (flag & 0x1)  # unmapped-with-mate keeps mate pos
            continue
        assert rname in ref_lengths, line
        assert 1 <= pos <= ref_lengths[rname], line
        # CIGAR query span must equal SEQ length (primary records)
        if not (flag & 0x100):
            span = 0
            num = ""
            for ch in cigar:
                if ch.isdigit():
                    num += ch
                else:
                    if ch in "MIS=X":
                        span += int(num)
                    num = ""
            assert span == len(seq), line
        if flag & 0x1 and not (flag & 0x100):
            tlen = int(f[8])
            pairs.setdefault(f[0], []).append((flag, tlen))
    for name, recs in pairs.items():
        if len(recs) == 2:
            assert recs[0][1] == -recs[1][1], (name, recs)
    return n


def test_sam_validity(dataset):
    import subprocess
    import sys as _sys

    tmp, genome, ref = dataset
    reads = tmp / "val.fq"
    import random as _r

    rr = _r.Random(11)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    with open(reads, "w") as f:
        for i in range(200):
            st = rr.randrange(0, len(genome) - 160)
            rd = genome[st : st + 150]
            if i % 3 == 1:
                rd = "".join(comp[c] for c in reversed(rd))
            if i % 5 == 2:
                rd = genome[st : st + 70] + genome[st + 74 : st + 154]
            if i % 17 == 3:
                rd = "".join(rr.choice("ACGT") for _ in range(150))
            f.write(f"@v{i}\n{rd}\n+\n{'I' * len(rd)}\n")
    out = tmp / "val.sam"
    from rabbitsalign_tpu.cli import main

    assert main(["--no-tpu", "-o", str(out), ref, str(reads)]) == 0
    text = open(out).read()
    n = validate_sam(text, {"chr1": len(genome)})
    assert n == 200


def test_cli_error_paths(dataset, tmp_path, capsys):
    tmp, genome, ref = dataset
    # nonexistent reads file
    assert main(["--no-tpu", ref, str(tmp_path / "missing.fq")]) == 1
    # malformed FASTQ (header without @)
    bad = tmp_path / "bad.fq"
    bad.write_text("not_a_header\nACGT\n+\nIIII\n")
    assert main(["--no-tpu", ref, str(bad)]) == 1
    # invalid -c
    fq = tmp_path / "one.fq"
    fq.write_text(f"@a\n{genome[:150]}\n+\n{'I' * 150}\n")
    assert main(["--no-tpu", "-c", "64", ref, str(fq)]) == 1
    # paired files of different lengths
    fq2 = tmp_path / "two.fq"
    fq2.write_text("")
    assert main(["--no-tpu", ref, str(fq), str(fq2)]) == 1
    capsys.readouterr()


def test_cli_interleaved(dataset, tmp_path, capsys):
    """--interleaved pairs consecutive same-name records; odd records map
    as single-end."""
    tmp, genome, ref = dataset
    import random as _r

    rr = _r.Random(5)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    il = tmp_path / "il.fq"
    out = tmp_path / "il.sam"
    with open(il, "w") as f:
        for i in range(40):
            st = rr.randrange(0, len(genome) - 700)
            ins = 300
            a = genome[st : st + 150]
            b = "".join(comp[c] for c in reversed(genome[st + ins - 150 : st + ins]))
            f.write(f"@x{i}/1\n{a}\n+\n{'I' * 150}\n")
            if i != 17:  # orphan
                f.write(f"@x{i}/2\n{b}\n+\n{'I' * 150}\n")
    assert main(["--no-tpu", "--interleaved", "-o", str(out), ref, str(il)]) == 0
    capsys.readouterr()
    lines = [l for l in open(out) if not l.startswith("@")]
    assert len(lines) == 79  # 39 pairs + 1 orphan
    paired = sum(1 for l in lines if int(l.split("\t")[1]) & 1)
    assert paired == 78


def test_cli_flags_reach_mapping_parameters():
    """Every behavior flag must survive the CLI -> CommandLineOptions ->
    runner plumbing (a dead flag parses fine and silently does nothing —
    this guards the class of bug where a new option is added to argparse
    but never copied into the mapping configuration)."""
    from rabbitsalign_tpu.cli import parse_command_line_arguments

    opt = parse_command_line_arguments([
        "--pe-ref-async", "--device-seed", "--deterministic",
        "--no-tpu", "-t", "4", "ref.fa", "r.fq",
    ])
    assert opt.pe_ref_async is True
    assert opt.device_seed is True
    assert opt.deterministic is True
    assert opt.n_threads == 4

    # and the runner actually forwards pe_ref_async into MappingParameters
    import inspect

    from rabbitsalign_tpu.pipeline import runner

    src = inspect.getsource(runner)
    assert "pe_ref_async" in src.split("MappingParameters(")[1].split(")")[0]


def test_pod_peers_requires_multinode():
    """--pod-index-peers is only consumed inside the multihost branch;
    accepting it on a single-node run would silently map with the full
    index in RAM (the exact scenario the flag exists to avoid)."""
    import pytest

    from rabbitsalign_tpu.cli import parse_command_line_arguments

    with pytest.raises(SystemExit):
        parse_command_line_arguments([
            "--pod-index-peers", "h1:9000,h2:9000",
            "-o", "out.sam", "ref.fa", "r.fq",
        ])
    # and the same peers parse fine once the pod is declared
    opt = parse_command_line_arguments([
        "--pod-index-peers", "h1:9000,h2:9000", "--num-nodes", "2",
        "--node-id", "0", "-o", "out.sam", "ref.fa", "r.fq",
    ])
    assert opt.pod_index_peers == "h1:9000,h2:9000"


def test_device_gated_off_at_equal_gap_costs():
    """O == E is the one scoring corner where ssw.c's striped lazy-F
    pruning diverges from the device kernel's textbook DP (probed:
    12k tie-dense pairs, zero divergences at any O > E); the pipeline
    must resolve gapped alignments on the host there."""
    import numpy as np

    from rabbitsalign_tpu.align.aligner import AlignmentParameters
    from rabbitsalign_tpu.index.params import IndexParameters
    from rabbitsalign_tpu.index.strobemer_index import StrobemerIndex
    from rabbitsalign_tpu.io.fasta import References
    from rabbitsalign_tpu.map.common import MappingParameters
    from rabbitsalign_tpu.pipeline.native_pipeline import NativePipeline

    rng = np.random.RandomState(3)
    refs = References()
    refs.add("c", rng.randint(0, 4, 30000, dtype=np.uint8).tobytes()
             .translate(bytes.maketrans(bytes(range(4)), b"ACGT")))
    params = IndexParameters.from_read_length(150)
    index = StrobemerIndex(refs, params)
    index.populate(0.0002)
    mp = MappingParameters(r=150)
    mp.rescue_cutoff = 2 * index.filter_cutoff

    pipe = NativePipeline(index, params, refs,
                          AlignmentParameters(gap_open=4, gap_extend=4),
                          mp)
    assert not pipe.use_device
    pipe2 = NativePipeline(index, params, refs,
                           AlignmentParameters(gap_open=12, gap_extend=1),
                           mp)
    assert pipe2.use_device
