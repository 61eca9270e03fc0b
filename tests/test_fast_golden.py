"""Reference-parity goldens for the -fast prefilter pipeline.

Goldens generated with the reference binary built from /root/reference/src
(g++ -O2), single thread:

  reseek -search q10.bca -db q100.bca -fast -output ...          (38 rows)
  reseek -search q10.bca -db q100.bca -fast -idxt -keeptmp ...   (35 rows
      + the stage-1 selection TSV, format: header `prefilter N`, then
      per-target `tidx nQ q1 q2 ...`, src/muprefilter.cpp:130-132)

These protect the fast-pipeline byte parity claim (README) against
refactors, and give idxt mode (the >100-query production mode,
src/muprefilter.cpp:70-80) a reference-derived selection golden.
"""

import io
import os

import pytest

from conftest import GOLDEN, TEST_DATA

Q10 = os.path.join(TEST_DATA, "q10.bca")
Q100 = os.path.join(TEST_DATA, "q100.bca")


def _run_fast(engine, mode=None):
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.search.driver import SearchOptions, fast_search
    queries = read_bca(Q10)
    opts = SearchOptions(columns=parse_columns("std"),
                         max_evalue=10.0, mode="fast")
    buf = io.StringIO()
    fast_search(queries, Q100, DSSParams.create("fast"), opts, buf,
                engine=engine, prefilter_mode=mode)
    return buf.getvalue()


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return f.read()


def test_fast_golden_host():
    assert _run_fast("host") == _golden("fast_q10_q100.tsv")


def test_fast_golden_device():
    """The device stage-2 engine (PostMuFilter analog) emits the same
    bytes as the host path and the reference binary."""
    assert _run_fast("device") == _golden("fast_q10_q100.tsv")


def test_fast_idxt_golden():
    assert _run_fast("host", mode="idxt") == \
        _golden("fast_idxt_q10_q100.tsv")


def test_fast_idxt_golden_device():
    assert _run_fast("device", mode="idxt") == \
        _golden("fast_idxt_q10_q100.tsv")


def test_prefilter_idxt_selection_golden():
    """idxt stage-1 selection equals the reference's -keeptmp TSV."""
    import numpy as np
    from reseek_tpu.encoder.dss import encode_chain
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.search.prefilter import prefilter_search

    q_mu = [encode_chain(c).mu_letters for c in read_bca(Q10)]
    t_mu = [(i, encode_chain(c).mu_letters)
            for i, c in enumerate(read_bca(Q100))]
    pf = prefilter_search(q_mu, t_mu, mode="idxt")
    mine = {t: sorted(qs) for t, qs in pf.target_to_queries().items()}

    ref = {}
    with open(os.path.join(GOLDEN, "prefilter_idxt_q10_q100.tsv")) as f:
        header = f.readline().split()
        assert header[0] == "prefilter"
        for line in f:
            parts = [int(x) for x in line.split()]
            tidx, nq = parts[0], parts[1]
            qs = parts[2:]
            assert len(qs) == nq
            ref[tidx] = sorted(qs)
    assert int(header[1]) == len(ref)
    assert mine == ref


def test_postmufilter_standalone():
    """postmufilter (reference -postmufilter): stage 2 driven from the
    committed reference prefilter TSV reproduces the committed reference
    -fast output byte-for-byte."""
    from reseek_tpu.cli import main
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "pmf.tsv")
        rc = main(["postmufilter", Q10, "--db", Q100,
                   "--filin",
                   os.path.join(GOLDEN, "prefilter_idxt_q10_q100.tsv"),
                   "--output", out])
        assert rc == 0
        with open(out) as f:
            assert f.read() == _golden("fast_idxt_q10_q100.tsv")
