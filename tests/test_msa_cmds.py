"""alignselfrev / lddt-msa-foldmason / mu-mapping command tests.

alignselfrev and lddt-msa-foldmason goldens generated with the reference
binary.  (The reference's -daliscore_msas and -mu_mapping are themselves
broken — inverted success check / assert — so those are covered by
self-consistency checks only; see the command docstrings.)"""

import io
import os
from contextlib import redirect_stderr

from conftest import GOLDEN, TEST_DATA


def test_alignselfrev_golden(tmp_path):
    from reseek_tpu.cli import main
    out = tmp_path / "asr.tsv"
    rc = main(["alignselfrev", os.path.join(TEST_DATA, "q10.bca"),
               "--output", str(out)])
    assert rc == 0
    with open(os.path.join(GOLDEN, "alignselfrev_q10.tsv")) as f:
        assert out.read_text() == f.read()


def test_lddt_msa_foldmason_golden(tmp_path):
    from reseek_tpu.cli import main
    out = tmp_path / "fm.tsv"
    with redirect_stderr(io.StringIO()):
        rc = main(["lddt-msa-foldmason", os.path.join(GOLDEN, "msta.afa"),
                   "--input", os.path.join(GOLDEN, "msta_set.cal"),
                   "--output", str(out)])
    assert rc == 0
    with open(os.path.join(GOLDEN, "lddt_msa_foldmason.tsv")) as f:
        assert out.read_text() == f.read()


def test_batch_msa_cmds(tmp_path):
    """lddt-msas row values agree with msta-score's avg_LDDT_mu on the
    same MSA; daliscore-msas Z agrees with msta-scores' Z."""
    import shutil

    from reseek_tpu.cli import main
    testdir = tmp_path / "aln"
    testdir.mkdir()
    shutil.copy(os.path.join(GOLDEN, "msta.afa"), testdir / "fam1")
    accs = tmp_path / "accs.txt"
    accs.write_text("fam1\n")
    o1 = tmp_path / "l.tsv"
    o2 = tmp_path / "d.tsv"
    with redirect_stderr(io.StringIO()):
        assert main(["lddt-msas", str(accs),
                     "--input", os.path.join(GOLDEN, "msta_set.cal"),
                     "--testdir", str(testdir),
                     "--output", str(o1)]) == 0
        assert main(["daliscore-msas", str(accs),
                     "--input", os.path.join(GOLDEN, "msta_set.cal"),
                     "--testdir", str(testdir),
                     "--output", str(o2)]) == 0
    # values pinned to the reference's msta-score output on this MSA
    assert "LDDT_mu=0.7644" in o1.read_text()
    assert "Z=26.6" in o2.read_text()


def test_mu_mapping(tmp_path):
    from reseek_tpu.cli import main
    out = tmp_path / "mu.tsv"
    assert main(["mu-mapping", "--output", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 37  # header + 36 letters
    # letter 35 = 'j' decomposes to SS3=2 ('C'), NENSS3=2, RENDist4=3
    assert lines[-1] == "j\tC\tC\tD"
