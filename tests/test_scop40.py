"""SCOP40 evaluator tests using the real dom_scopid truth table."""

import os

from tests.conftest import TEST_DATA
from reseek_tpu.benchmarks.scop40 import Scop40Eval, read_dom_scopid


def test_truth_table_counts():
    d = read_dom_scopid(os.path.join(TEST_DATA, "dom_scopid.tsv"))
    ev = Scop40Eval(d)
    assert ev.nrdoms == 11211
    assert ev.nt == 454766  # matches scop40.py level sf2


def test_is_tp_levels():
    d = read_dom_scopid(os.path.join(TEST_DATA, "dom_scopid.tsv"))
    ev = Scop40Eval(d)
    doms = list(d)
    sf_groups = {}
    for dom in doms:
        sf_groups.setdefault(ev.dom2sf[dom], []).append(dom)
    big = next(v for v in sf_groups.values() if len(v) >= 2)
    assert ev.is_tp(big[0], big[1]) == 1
    other = next(dom for dom in doms if ev.dom2sf[dom] != ev.dom2sf[big[0]])
    assert ev.is_tp(big[0], other) == 0
    assert ev.is_tp("unknown_dom", big[0]) == -1


def test_sepq_synthetic():
    d = read_dom_scopid(os.path.join(TEST_DATA, "dom_scopid.tsv"))
    ev = Scop40Eval(d)
    doms = list(d)
    sf_groups = {}
    for dom in doms:
        sf_groups.setdefault(ev.dom2sf[dom], []).append(dom)
    big = next(v for v in sf_groups.values() if len(v) >= 5)
    other = next(dom for dom in doms if ev.dom2sf[dom] != ev.dom2sf[big[0]])
    # 4 TP hits at good E-values, then 1 FP
    hits = [(big[0], big[i], 1e-9 * i) for i in range(1, 5)]
    hits.append((big[0], other, 0.5))
    r = ev.evaluate(hits)
    assert r.ntp == 4 and r.nfp == 1
    # the FP contributes epq = 1/11211 < 0.1, so SEPQ plateaus at 4/NT
    assert abs(r.sepq0_1 - 4 / ev.nt) < 1e-12
    assert r.n_first_fp == 4
