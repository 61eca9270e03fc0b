"""-align_bags self-check parity: MKF bag path vs full SW on the same
pairs (reference src/align_bag.cpp:97-199), golden generated with the
reference binary on q100.bca (includes its PROBLEM rows verbatim)."""

import io
import os
from contextlib import redirect_stderr

from conftest import GOLDEN, TEST_DATA


def test_align_bags_golden(tmp_path):
    from reseek_tpu.cli import main
    out = tmp_path / "ab.tsv"
    with redirect_stderr(io.StringIO()):
        rc = main(["align-bags",
                   os.path.join(TEST_DATA, "q100.bca"),
                   "--output", str(out)])
    assert rc == 0
    with open(os.path.join(GOLDEN, "alignbags_q100.tsv")) as f:
        golden = f.read()
    assert out.read_text() == golden
