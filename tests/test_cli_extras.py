"""Tests for the operational surface added in round 3: convert filters,
pretty -aln blocks, -log run stats, gapless Mu-filter fallback,
calibration commands."""

import io
import os
import sys

import numpy as np
import pytest

from tests.conftest import TEST_DATA

Q10 = os.path.join(TEST_DATA, "q10.bca")
Q100 = os.path.join(TEST_DATA, "q100.bca")


def test_gapless_sw_matches_kadane():
    from reseek_tpu.ops.sw_np import sw_gapless_score
    rng = np.random.default_rng(7)
    for _ in range(10):
        la, lb = rng.integers(2, 40, 2)
        S = rng.integers(-7, 5, (la, lb)).astype(np.int8)
        best = 0
        for d in range(-(la - 1), lb):
            run = 0
            for i in range(max(0, -d), min(la, lb - d)):
                run = max(run, 0) + int(S[i, i + d])
                best = max(best, run)
        assert sw_gapless_score(S) == best


def test_mu_filter_gapless_fallback():
    """use_para=False routes the Omega filter through the gapless kernel
    (src/dssaligner.cpp:1055-1067)."""
    from reseek_tpu.align.pipeline import PairAligner, encode_for_search
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.bca import read_bca
    chains = read_bca(Q10)[:3]
    params = DSSParams.create("sensitive")
    ecs = [encode_for_search(c, params, with_self_rev=False)
           for c in chains]
    pa = PairAligner(params)
    para = pa.mu_filter_score(ecs[0], ecs[1])
    params2 = DSSParams.create("sensitive")
    params2.use_para = False
    pa2 = PairAligner(params2)
    gapless = pa2.mu_filter_score(ecs[0], ecs[1])
    # different kernels, same scale: both are Mu-matrix local scores
    assert gapless >= 0.0
    assert para != gapless or para == 0.0


def test_convert_filters(tmp_path):
    from reseek_tpu.cli import main
    from reseek_tpu.io.bca import read_bca
    out = tmp_path / "sub.bca"
    assert main(["convert", Q10, "--bca", str(out), "--subsample", "2"]) == 0
    orig = read_bca(Q10)
    sub = read_bca(str(out))
    assert len(sub) == len(orig) // 2
    assert sub[0].label == orig[1].label

    out2 = tmp_path / "rev.cal"
    assert main(["convert", Q10, "--cal", str(out2), "--reverse"]) == 0
    from reseek_tpu.io.cal import read_cal
    rev = read_cal(str(out2))
    assert rev[0].label == orig[0].label
    assert rev[0].seq == orig[0].seq[::-1]

    labfile = tmp_path / "labels.txt"
    labfile.write_text(orig[0].label + "\n")
    out3 = tmp_path / "lab.cal"
    assert main(["convert", Q10, "--cal", str(out3),
                 "--labels", str(labfile)]) == 0
    assert [c.label for c in read_cal(str(out3))] == [orig[0].label]

    out4 = tmp_path / "flip.cal"
    assert main(["convert", Q10, "--cal", str(out4), "--flip"]) == 0
    flip = read_cal(str(out4))
    np.testing.assert_allclose(flip[0].coords, -orig[0].coords, atol=0.11)


def test_pretty_aln_blocks():
    from reseek_tpu.align.pipeline import PairAligner, encode_for_search
    from reseek_tpu.align.prettyaln import pretty_aln
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.bca import read_bca
    chains = read_bca(Q10)[:2]
    params = DSSParams.create("sensitive")
    params.omega = 0.0
    params.min_fwd_score = 0.0   # force P-value computation for this pair
    ecs = [encode_for_search(c, params) for c in chains]
    res = PairAligner(params).align(ecs[0], ecs[1], apply_filter=False)
    assert res is not None and res.path
    buf = io.StringIO()
    pretty_aln(buf, res, ecs[0], ecs[1], up=True)
    text = buf.getvalue()
    assert ecs[0].label in text and ecs[1].label in text
    assert "AQ " in text and "P-value" in text
    # block structure: A-row starts with the 1-based lo coordinate
    first_block = [ln for ln in text.splitlines() if ln.strip()][1]
    assert first_block.split()[0] == str(res.lo_a + 1)
    # row content reconstructs the aligned query substring
    arow = first_block.split()[1]
    assert arow.replace("-", "") in ecs[0].chain.seq


def test_search_log_and_stats(tmp_path):
    from reseek_tpu.cli import main
    logf = tmp_path / "run.log"
    outf = tmp_path / "hits.tsv"
    assert main(["search", Q10, "--sensitive", "--output", str(outf),
                 "--log", str(logf)]) == 0
    text = logf.read_text()
    assert "Search time" in text
    assert "Hits" in text
    assert "Comparisons/sec" in text
    assert "DSSAligner::Stats()" in text
    assert outf.read_text().count("\n") > 0


def test_search_aln_and_trace(tmp_path):
    from reseek_tpu.cli import main
    from reseek_tpu.io.bca import read_bca
    labels = [c.label for c in read_bca(Q10)[:2]]
    alnf = tmp_path / "aln.txt"
    logf = tmp_path / "trace.log"
    outf = tmp_path / "hits.tsv"
    assert main(["search", Q10, "--sensitive", "--output", str(outf),
                 "--aln", str(alnf), "--log", str(logf),
                 "--label1", labels[0], "--label2", labels[1]]) == 0
    assert "AQ " in alnf.read_text()
    trace = logf.read_text()
    assert f"A>{labels[0]}" in trace
    # either the pair aligns (score+path logged) or the filter reject is
    # logged — both are faithful trace outcomes (dssaligner.cpp:760-772)
    assert "AlnFwdScore=" in trace or "MuFilterOk=F" in trace


def test_calibrate_command(tmp_path, capsys):
    from reseek_tpu.cli import main
    out = tmp_path / "hist.tsv"
    assert main(["calibrate", Q100, "--fast", "--engine", "host",
                 "--output", str(out)]) == 0
    text = capsys.readouterr().out
    assert "loglinear:" in text and "shipped:" in text
    lines = out.read_text().splitlines()
    x0, dx = (float(v) for v in lines[0].split("\t"))
    assert dx > 0
    # the histogram file round-trips through fit-gumbel
    histf = tmp_path / "hist_only.tsv"
    histf.write_text("\n".join(
        [lines[0]] + [ln for ln in lines[1:] if not ln.startswith("#")])
        + "\n")
    assert main(["fit-gumbel", str(histf)]) == 0
    assert "mu=" in capsys.readouterr().out


def test_train_features(tmp_path):
    """Training on alignments produced by our own search yields sane
    log-odds (positive diagonal mass, positive expected score), and the
    LogOdds math matches hand computation."""
    import numpy as np
    from reseek_tpu.benchmarks.train import LogOdds, train_features
    from reseek_tpu.cli import main

    lo = LogOdds(3)
    lo.add_background(np.array([0, 0, 1, 2, 2, 2], np.uint8))
    lo.add_true_pairs(np.array([0, 2]), np.array([0, 2]))
    mx, expected = lo.log_odds_mx()
    # P(0)=2/6, obs(0,0)=2/4 -> ln(0.5/(1/9)) = ln(4.5)
    assert mx[0, 0] == pytest.approx(np.log(4.5))
    assert expected > 0

    # end-to-end: search q10, emit aligned rows, train
    outrows = tmp_path / "rows.tsv"
    assert main(["search", Q10, "--sensitive", "--output", str(outrows),
                 "--columns", "query+target+qrow+trow", "--noself"]) == 0
    alns = tmp_path / "alns.fa"
    with open(alns, "w") as f:
        for line in open(outrows):
            q, t, qrow, trow = line.rstrip("\n").split("\t")
            f.write(f">{q}\n{qrow}\n>{t}\n{trow}\n")
    outtsv = tmp_path / "trained.tsv"
    assert main(["train-features", Q10, "--alns", str(alns),
                 "--output", str(outtsv), "--features", "Conf,NENDist"]) == 0
    text = outtsv.read_text()
    assert text.count("FEATURE") == 2
    # self-similar structures: diagonal of the trained matrix is positive
    first = text.splitlines()
    as_conf = int(first[0].split("\t")[2])
    mx = np.array([[int(v) for v in first[1 + i].split("\t")]
                   for i in range(as_conf)])
    assert np.diag(mx).sum() > 0


def test_utility_commands(tmp_path):
    from reseek_tpu.cli import main
    from reseek_tpu.io.bca import read_bca

    # shuffle: same chain set, different order, valid .bca
    sh = tmp_path / "sh.bca"
    assert main(["shuffle", Q10, "--bca", str(sh), "--seed", "7"]) == 0
    orig = read_bca(Q10)
    shuf = read_bca(str(sh))
    assert sorted(c.label for c in shuf) == sorted(c.label for c in orig)

    # split: 3 splits covering all chains
    assert main(["split", Q10, "-n", "3",
                 "--prefix", str(tmp_path / "part")]) == 0
    got = []
    for k in (1, 2, 3):
        got += [c.label for c in read_bca(str(tmp_path / f"part{k}.bca"))]
    assert got == [c.label for c in orig]

    # convert2mu round-trips through the Mu FASTA reader
    mufa = tmp_path / "q10.mu.fa"
    assert main(["convert2mu", Q10, "--output", str(mufa)]) == 0
    from reseek_tpu.io.mufasta import read_mu_fasta
    labels, seqs = read_mu_fasta(str(mufa))
    assert labels == [c.label for c in orig]
    assert all(len(s) == len(c) for s, c in zip(seqs, orig))

    # gunzip
    import gzip
    gz = tmp_path / "x.txt.gz"
    with gzip.open(gz, "wb") as f:
        f.write(b"hello")
    out = tmp_path / "x.txt"
    assert main(["gunzip", str(gz), "--output", str(out)]) == 0
    assert out.read_bytes() == b"hello"

    # prepare-query: self-duplicate detection
    dup = tmp_path / "dup.bca"
    from reseek_tpu.io.bca import BCAWriter
    with BCAWriter(str(dup)) as w:
        for c in orig[:2] + orig[:1]:
            w.write_chain(c)
    rep = tmp_path / "rep.tsv"
    keep = tmp_path / "keep.bca"
    assert main(["prepare-query", str(dup), "--bca", str(keep),
                 "--output", str(rep)]) == 0
    assert len(read_bca(str(keep))) == 2
    # the duplicate row carries the reference's "%.1f%%<j>" tag
    assert "100.0%0" in rep.read_text()


def test_distmx_and_params(tmp_path):
    from reseek_tpu.cli import main
    out = tmp_path / "dist.tsv"
    assert main(["distmx", Q10, "--fast", "--engine", "host",
                 "--output", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) > 0
    a, b, ts = lines[0].split("\t")
    assert float(ts) != 0.0

    # --params file drives the search parameterization
    pf = tmp_path / "p.tsv"
    pf.write_text("AA\t0.398145\nConf\t0.202354\nGapOpen\t-0.6855\n"
                  "GapExt\t-0.0519\nOmega\t0\nMinFwdScore\t0\n")
    hits = tmp_path / "h.tsv"
    assert main(["search", Q10, "--sensitive", "--params", str(pf),
                 "--output", str(hits), "--columns", "query+target+dpscore",
                 "--scores-are-not-evalues"]) == 0
    assert hits.read_text().count("\n") > 0


def test_prepare_query_reference_golden(tmp_path):
    """prepare-query selection + status TSV byte-identical to the
    reference binary's -prepare_query on q100 (-minchainlength 50 -n 30),
    exercising the BLOSUM62 global-identity screen."""
    import os
    from conftest import GOLDEN
    from reseek_tpu.cli import main
    rep = tmp_path / "pq.tsv"
    assert main(["prepare-query", Q100, "--output", str(rep),
                 "--minchainlength", "50", "-n", "30"]) == 0
    with open(os.path.join(GOLDEN, "prepare_query_q100.tsv")) as f:
        assert rep.read_text() == f.read()


def test_mmseqs_index_dump(tmp_path):
    """mmseqs-index-dump (reference -mmseqs_index_dump): record walk,
    NUL checks, '@' for non-printing bytes."""
    import io
    from contextlib import redirect_stderr
    from reseek_tpu.cli import main
    recs = [b"q1\tt1\t0.5\nq1\tt2\t0.1\n\x00", b"q2\tt9\x01\n\x00"]
    db = tmp_path / "db"
    with open(db, "wb") as f, open(str(db) + ".index", "w") as ix:
        pos = 0
        for i, r in enumerate(recs):
            f.write(r)
            ix.write(f"{i}\t{pos}\t{len(r)}\n")
            pos += len(r)
    (tmp_path / "db.dbtype").write_bytes((0xC000).to_bytes(4, "little"))
    out = tmp_path / "out.txt"
    err = io.StringIO()
    with redirect_stderr(err):
        assert main(["mmseqs-index-dump", str(db),
                     "--output", str(out)]) == 0
    assert "2 records, 3 hits, 1 non-printing bytes" in err.getvalue()
    assert "q2\tt9@" in out.read_text()


def test_musubstmx_and_gunzip_lines(tmp_path):
    """musubstmx: emitted int table equals the shipped IntScoreMx_Mu;
    gunzip-lines round-trips text."""
    import gzip
    import re

    import numpy as np
    from reseek_tpu.cli import main
    from reseek_tpu.data.tables import get_tables
    out = tmp_path / "mx.txt"
    assert main(["musubstmx", "--output", str(out)]) == 0
    txt = out.read_text()
    sec = txt.split("int IntScoreMx_Mu[36][36]")[1].split("};")[0]
    vals = np.array([int(x) for x in re.findall(r"(-?\d+),", sec)])
    assert np.array_equal(vals.reshape(36, 36),
                          get_tables().mu_score_mx_int8)

    gz = tmp_path / "x.gz"
    with gzip.open(gz, "wt") as f:
        f.write("line1\nline2\n")
    txtout = tmp_path / "x.txt"
    assert main(["gunzip-lines", str(gz), "--output", str(txtout)]) == 0
    assert txtout.read_text() == "line1\nline2\n"
