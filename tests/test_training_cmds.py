"""Training-command parity/function tests.

float-feature-bins: report lines (expected score + BIN_T thresholds)
byte-identical to the reference binary's -float_feature_bins -log output
on the committed aligned-pairs fixture (golden ffb_nendist16.txt).

sscluster: functional check — k-means over intra-window CA distances
must produce SS-correlated clusters (the reference's randu32 init stream
is not replicated, so centroid numbering differs; shipped Conf centroids
are baked in data/tables.npz)."""

import io
import os
import re
from contextlib import redirect_stderr

from conftest import GOLDEN, TEST_DATA


def test_float_feature_bins_golden(tmp_path):
    from reseek_tpu.cli import main
    out = tmp_path / "ffb.txt"
    with redirect_stderr(io.StringIO()):
        rc = main(["float-feature-bins",
                   os.path.join(GOLDEN, "ffb_pairs.fa"),
                   "--train-cal", os.path.join(GOLDEN, "sepq_set.cal"),
                   "--feature", "NENDist", "--alpha-size", "16",
                   "--output", str(out)])
    assert rc == 0
    mine = [ln for ln in out.read_text().splitlines()
            if re.search(r"ALPHA_SIZE|BIN_T|expected", ln)]
    with open(os.path.join(GOLDEN, "ffb_nendist16.txt")) as f:
        golden = f.read().splitlines()
    assert mine == golden


def test_sscluster_functional(tmp_path):
    from reseek_tpu.cli import main
    out = tmp_path / "ssc.txt"
    with redirect_stderr(io.StringIO()):
        rc = main(["sscluster", os.path.join(TEST_DATA, "q10.bca"),
                   "-k", "8", "-n", "2000", "--output", str(out)])
    assert rc == 0
    lines = [ln for ln in out.read_text().splitlines()
             if ln.startswith("Mean[")]
    assert len(lines) == 8
    # the largest cluster must be dominated by one SS class (helix
    # geometry is tight); parse counts from the first row
    m = re.search(r"h=(\d+) s=(\d+) t=(\d+) ~=(\d+)", lines[0])
    counts = sorted(int(x) for x in m.groups())[::-1]
    assert counts[0] > 3 * max(1, sum(counts[1:]))
