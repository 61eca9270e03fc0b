"""MSA scorers (lddt-msa / daliscore-msa) vs reference-binary goldens.

Golden values were produced with the reference binary on a 2-row MSA of
the qrowg/trowg global rows for the first non-self q10 sensitive hit
(10gs_A vs 1a0f_A):
  reseek -lddt_msa msa.fa -input q10.cal      ->  0.6745
  reseek -daliscore_msa msa.fa -input q10.cal ->  Score=1249.6  Z=15.0
"""

import io
import os

import numpy as np
import pytest

from tests.conftest import TEST_DATA

Q10 = os.path.join(TEST_DATA, "q10.bca")


@pytest.fixture(scope="module")
def msa2(tmp_path_factory):
    """Two-row MSA from our own search's global rows (matches the
    reference run because the search itself is bit-parity)."""
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.search.driver import SearchOptions, self_search
    chains = read_bca(Q10)
    params = DSSParams.create("sensitive")
    opts = SearchOptions(
        columns=parse_columns("query+target+qrowg+trowg"),
        max_evalue=10.0, mode="sensitive")
    buf = io.StringIO()
    self_search(chains, params, opts, buf, engine="host")
    for line in buf.getvalue().splitlines():
        q, t, qr, tr = line.split("\t")
        if q != t:
            p = tmp_path_factory.mktemp("msa") / "msa2.fa"
            p.write_text(f">{q}\n{qr}\n>{t}\n{tr}\n")
            return str(p)
    raise RuntimeError("no non-self hit found")


def test_lddt_msa_golden(msa2):
    from reseek_tpu.benchmarks.msa import score_msa
    from reseek_tpu.io.bca import read_bca
    rows, mean = score_msa(msa2, read_bca(Q10), metric="lddt")
    assert len(rows) == 1
    assert rows[0][0] == "10gs_A" and rows[0][1] == "1a0f_A"
    assert "%.4f" % rows[0][2] == "0.6745"


def test_dali_msa_golden(msa2):
    from reseek_tpu.benchmarks.msa import score_msa
    from reseek_tpu.io.bca import read_bca
    rows, mean_z = score_msa(msa2, read_bca(Q10), metric="dali")
    (l1, l2, (score, z)), = rows
    assert "%.1f" % score == "1249.6"
    assert "%.1f" % z == "15.0"


def test_dali_pair_score_formula():
    """Spot-check DALI_dpscorefun (src/dali.cpp:93-110)."""
    from reseek_tpu.benchmarks.msa import dali_pair_score
    # mean = 10 -> weight exp(-(10/20)^2), ratio = 2/10
    v = dali_pair_score(np.array([9.0]), np.array([11.0]))[0]
    assert v == pytest.approx(np.exp(-0.25) * (0.2 - 0.2))
    v = dali_pair_score(np.array([10.0]), np.array([10.0]))[0]
    assert v == pytest.approx(np.exp(-0.25) * 0.2)
    # mean > 100 -> 0
    assert dali_pair_score(np.array([150.0]), np.array([151.0]))[0] == 0.0


def test_core_columns():
    from reseek_tpu.benchmarks.msa import col_to_pos, core_columns
    rows = ["AB-D", "A-cD"]
    core = core_columns(rows)
    # col 1 has 1 gap (> 2//10+1 = 1? no, <=1 ok); col 2 has lowercase
    assert core.tolist() == [True, True, False, True]
    ctp = col_to_pos(rows[1], core)
    assert ctp.tolist() == [0, -1, -1, 2]


def test_match_chains_sequence_only():
    """DALIScorer matching semantics (src/daliscorer.cpp:134-162): a
    sequence matches a chain iff the ungapped uppercased row equals the
    chain seq — the label is NEVER consulted (regression: a row whose
    label matches but whose residues differ must be treated as missing,
    exactly like the reference; found by a live A/B cross-check of
    daliscore-msas2 with a residue-swapped MSA)."""
    import numpy as np
    from reseek_tpu.benchmarks.msa import _match_chains
    from reseek_tpu.chain import Chain
    c = Chain("m0", "ACDEF", np.zeros((5, 3), np.float32))
    msa_ok = [("wronglabel", "AC-DEF")]
    msa_bad = [("m0", "AC-DFE")]  # label matches, residues swapped
    assert 0 in _match_chains(msa_ok, [c])
    assert 0 not in _match_chains(msa_bad, [c])
