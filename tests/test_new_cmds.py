"""Round-5 command ports: tracealn, feature-stats, test-gumbel,
scop40tsv2bit, lddt-bench, lddt-msa / daliscore-msa summary lines,
msta-lddtmuw (jalview + pymol), msta-lddtmuw1.

Goldens generated with the reference binary (build of /root/reference/src)
on committed fixtures; see each test for the exact command.  Where the
reference's own command is broken upstream (test_gumbel dies on its
normalization assert, gumbel.cpp:122; scop40tsv2bit segfaults in LoadDB)
the port is covered by self-consistency instead."""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import GOLDEN, TEST_DATA

MSTA = os.path.join(GOLDEN, "msta.afa")
MSTA_SET = os.path.join(GOLDEN, "msta_set.cal")


def run_cli(args, **kw):
    from reseek_tpu.cli import main
    return main(args)


def test_feature_stats_golden(capsys):
    assert run_cli(["feature-stats"]) == 0
    with open(os.path.join(GOLDEN, "feature_stats.txt")) as f:
        assert capsys.readouterr().out == f.read()


def test_tracealn_golden(tmp_path):
    """reseek -tracealn q10.bca -db q10.bca -log ... (100 pair traces:
    routing, self-rev scores, path prefix, E-value, Mu filter verdicts —
    all bit-parity quantities)."""
    log = tmp_path / "trace.log"
    assert run_cli(["tracealn", os.path.join(TEST_DATA, "q10.bca"),
                    "--db", os.path.join(TEST_DATA, "q10.bca"),
                    "--log", str(log)]) == 0
    body = "".join(l for l in log.read_text().splitlines(True)
                   if not l.startswith(("Finished", "Elapsed",
                                        "Max memory")))
    with open(os.path.join(GOLDEN, "tracealn_q10.txt")) as f:
        assert body.rstrip("\n") == f.read().rstrip("\n")


def test_test_gumbel_recovers_parameters(capsys):
    """Fit of a clean gumbel(1.3, 0.8) curve recovers the parameters
    (the reference binary's own -test_gumbel dies upstream)."""
    assert run_cli(["test-gumbel"]) == 0
    out = capsys.readouterr().out
    parts = dict(p.split(" ") for p in out.strip().split(", "))
    assert abs(float(parts["FitMu"]) - 1.3) < 0.15
    assert abs(float(parts["FitBeta"]) - 0.8) < 0.12


def test_scop40tsv2bit(tmp_path, capsys):
    """Reference-generated sepq hits TSV -> .bit; round-trips through
    read_bit and reports the Scop40Eval first-FP sensitivity count
    (the reference binary's own -scop40tsv2bit segfaults upstream)."""
    out = tmp_path / "hits.bit"
    assert run_cli(["scop40tsv2bit", os.path.join(GOLDEN, "sepq_hits3.tsv"),
                    "--input", os.path.join(GOLDEN, "sepq_set.cal"),
                    "--output", str(out)]) == 0
    assert capsys.readouterr().out.strip() == "1595 hits, Sens1FP 975"
    from reseek_tpu.benchmarks.scop40 import read_bit
    n_doms, d1, d2, sc = read_bit(str(out))
    assert len(d1) == 1595 and n_doms == 139
    with open(os.path.join(GOLDEN, "sepq_hits3.tsv")) as f:
        first = f.readline().split("\t")
    from reseek_tpu.io.reader import read_chains
    doms = [c.label.partition("/")[0]
            for c in read_chains(os.path.join(GOLDEN, "sepq_set.cal"))]
    assert doms[d1[0]] == first[0].partition("/")[0]
    assert float(sc[0]) == pytest.approx(float(first[2]), rel=1e-6)


def test_lddt_bench_golden(capsys):
    """reseek -lddt_bench msta.afa -input msta_set.cal -> LDDT=0.7564."""
    assert run_cli(["lddt-bench", MSTA, "--input", MSTA_SET]) == 0
    assert capsys.readouterr().out.strip() == "LDDT=0.7564 MSA=msta"


def test_lddt_msa_golden(tmp_path):
    out = tmp_path / "l.tsv"
    assert run_cli(["lddt-msa", MSTA, "--input", MSTA_SET,
                    "--output", str(out)]) == 0
    with open(os.path.join(GOLDEN, "lddt_msa.tsv")) as f:
        assert out.read_text() == f.read()


def test_daliscore_msa_golden(tmp_path):
    out = tmp_path / "d.tsv"
    assert run_cli(["daliscore-msa", MSTA, "--input", MSTA_SET,
                    "--output", str(out)]) == 0
    with open(os.path.join(GOLDEN, "daliscore_msa.tsv")) as f:
        assert out.read_text() == f.read()


def test_msta_lddtmuw_jalview_golden(tmp_path):
    out = tmp_path / "muw.jv"
    assert run_cli(["msta-lddtmuw", MSTA, "--input", MSTA_SET,
                    "--lddtmuw-jalview", str(out)]) == 0
    with open(os.path.join(GOLDEN, "msta_lddtmuw.jalview")) as f:
        assert out.read_text() == f.read()


def test_msta_lddtmuw_pymol_golden(tmp_path):
    out = tmp_path / "muw.pml"
    assert run_cli(["msta-lddtmuw", MSTA, "--input", MSTA_SET,
                    "--label", "m0", "--lddtmuw-pymol", str(out)]) == 0
    with open(os.path.join(GOLDEN, "msta_lddtmuw_m0.pml")) as f:
        assert out.read_text() == f.read()


def test_msta_lddtmuw1_golden(tmp_path):
    out = tmp_path / "muw1.txt"
    assert run_cli(["msta-lddtmuw1", MSTA, "--input", MSTA_SET,
                    "--label", "m0", "--output", str(out)]) == 0
    with open(os.path.join(GOLDEN, "msta_lddtmuw1_m0.txt")) as f:
        assert out.read_text().rstrip("\n") == f.read().rstrip("\n")


def test_reference_style_spelling(tmp_path, capsys):
    """Single-dash reference spelling works for the new commands."""
    from reseek_tpu.cli import main
    out = tmp_path / "muw.jv"
    assert main(["-msta_lddtmuw", MSTA, "-input", MSTA_SET,
                 "-lddtmuw_jalview", str(out)]) == 0
    assert out.exists()


def test_mudex_golden(tmp_path, capsys):
    """reseek -mudex q100.mu.fa: dictionary self-score quartiles +
    occupancy histogram, byte-identical to the reference binary."""
    log = tmp_path / "mudex.log"
    assert run_cli(["mudex", os.path.join(GOLDEN, "q100.mu.fa"),
                    "--log", str(log)]) == 0
    assert capsys.readouterr().out == (
        "Validate OK\n"
        "Max letters [1] = 3796 (14.0%)\n"
        "Max letters [2] = 15285 (56.4%)\n"
        "Max letters [3] = 6204 (22.9%)\n"
        "Max letters [4] = 1424 (5.3%)\n"
        "Max letters [5] = 409 (1.5%)\n")
    assert ("SelfScores: N=60466176, Min=20, LoQ=43, Med=47, HiQ=51, "
            "Max=75, Avg=47.3611") in log.read_text()


def test_mukmerfilter_obsolete():
    with pytest.raises(SystemExit, match="Obsolete"):
        run_cli(["mukmerfilter"])


def test_test_xdrop_golden(tmp_path):
    """reseek -test_xdrop: x-drop fwd/bwd/merge on BLOSUM62 string pairs,
    byte-identical log to the reference binary (incl. display quirks)."""
    log = tmp_path / "txd.log"
    assert run_cli(["test-xdrop", "--log", str(log)]) == 0
    body = "".join(l for l in log.read_text().splitlines(True)
                   if not l.startswith(("Finished", "Elapsed",
                                        "Max memory")))
    with open(os.path.join(GOLDEN, "test_xdrop.txt")) as f:
        assert body.rstrip("\n") == f.read().rstrip("\n")


def test_scan_files(capsys):
    assert run_cli(["scan-files", "/root/reference/test_structures"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and all(o.endswith(".pdb.gz") for o in out)


def test_msa2cmp_golden(tmp_path):
    """reseek -msa2cmp msta.afa -input msta_set.cal: contact-map profile
    byte-identical to the reference binary (incl. the f32 QuartsFloat
    accumulation and GCC-FMA GetDist rounding)."""
    out = tmp_path / "cmp.tsv"
    assert run_cli(["msa2cmp", MSTA, "--input", MSTA_SET,
                    "--output", str(out)]) == 0
    with open(os.path.join(GOLDEN, "msa2cmp.tsv")) as f:
        assert out.read_text() == f.read()


def test_binner_golden(tmp_path, capsys):
    """reseek -binner (fieldnr 2, 8 bins): histogram + cumulative +
    reverse-cumulative TSVs and the QuartsFloat stderr line, all
    byte-identical to the reference binary.  (The reference itself
    segfaults when -accum is omitted — fprintf(NULL) in AccumToTsv,
    src/binner.h:184 — our port just skips unset outputs.)"""
    h, a, r = (tmp_path / x for x in ("h.tsv", "a.tsv", "r.tsv"))
    assert run_cli(["binner", os.path.join(GOLDEN, "binner_vals.tsv"),
                    "--fieldnr", "2", "--bins", "8",
                    "--output", str(h), "--accum", str(a),
                    "--accumrev", str(r)]) == 0
    for got, name in ((h, "binner_hist.tsv"), (a, "binner_accum.tsv"),
                      (r, "binner_accumrev.tsv")):
        with open(os.path.join(GOLDEN, name)) as f:
            assert got.read_text() == f.read()
    assert ("Min=-0.133, LoQ=3.67, Med=5.01, HiQ=6.18, Max=10.8, "
            "Avg=4.97") in capsys.readouterr().err


def test_calibrate2(tmp_path, capsys):
    """calibrate2 on the sepq labeled set: the TS -> -log(P) fit is in
    the neighborhood of the reference's documented SCOP40 superfamily
    fit (m=20.5 b=2.89, src/calibrate2.cpp:12) and the table is
    well-formed.  (The reference binary's own command dies upstream —
    scop40benchroc.cpp:295 assert.)"""
    out = tmp_path / "cal2.tsv"
    assert run_cli(["calibrate2", os.path.join(GOLDEN, "sepq_set.cal"),
                    "--benchlevel", "sf", "--engine", "host",
                    "--output", str(out)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("Linear fit to -log(P) m=")
    m = float(line.split("m=")[1].split()[0])
    b = float(line.split("b=")[1])
    assert 10 < m < 40 and 1 < b < 8
    rows = out.read_text().splitlines()
    assert rows[0] == "TS\tP\tMinusLogP\tMinusLogP_fit\tP_fit"
    assert len(rows) > 10


def test_daliscore_msas2_golden(tmp_path):
    """reseek -daliscore_msas2 with both testdirs holding the msta MSA:
    byte-identical to the reference binary (incl. its duplicated-z2 and
    norm-prints-score output quirks)."""
    import shutil
    td1, td2 = tmp_path / "td1", tmp_path / "td2"
    td1.mkdir(); td2.mkdir()
    shutil.copy(MSTA, td1 / "msta.afa")
    shutil.copy(MSTA, td2 / "msta.afa")
    accs = tmp_path / "accs.txt"
    accs.write_text("msta.afa\n")
    out = tmp_path / "out.tsv"
    assert run_cli(["daliscore-msas2", str(accs), "--input", MSTA_SET,
                    "--testdir", str(td1), "--testdir2", str(td2),
                    "--output", str(out)]) == 0
    with open(os.path.join(GOLDEN, "daliscore_msas2.tsv")) as f:
        want = f.read().replace("/tmp/td1/", str(td1) + "/") \
                       .replace("/tmp/td2/", str(td2) + "/")
    assert out.read_text() == want
