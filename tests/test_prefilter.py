"""Mu k-mer prefilter tests (candidate selection semantics)."""

import numpy as np

from reseek_tpu.data.tables import get_tables
from reseek_tpu.search.prefilter import (MASK14, MIN_KMER_PAIR_SCORE,
                                         diag_hsp_scores, neighborhoods,
                                         prefilter_search, spaced_kmers)


def test_spaced_kmer_codes():
    mu = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9], np.uint8)
    kms = spaced_kmers(mu)
    assert len(kms) == 3
    # pattern offsets 0,1,2,5,6 -> letters (1,2,3,6,7) at pos 0
    want = ((((1 * 36 + 2) * 36 + 3) * 36 + 6) * 36 + 7)
    s = get_tables().mu_prefilter_mx_int8
    self_score = sum(int(s[x, x]) for x in (1, 2, 3, 6, 7))
    if self_score >= MIN_KMER_PAIR_SCORE:
        assert kms[0] == want
    else:
        assert kms[0] == -1


def test_neighborhood_contains_self_and_scores():
    s = get_tables().mu_prefilter_mx_int8.astype(np.int64)
    km = ((((1 * 36 + 2) * 36 + 3) * 36 + 6) * 36 + 7)
    hood = neighborhoods([km])[km]
    lets = [1, 2, 3, 6, 7]
    if sum(int(s[x, x]) for x in lets) >= MIN_KMER_PAIR_SCORE:
        assert km in set(int(x) for x in hood)
    # every member scores >= threshold
    for nb in hood[:50]:
        nl = []
        v = int(nb)
        for _ in range(5):
            nl.append(v % 36)
            v //= 36
        nl.reverse()
        sc = sum(int(s[a, b]) for a, b in zip(lets, nl))
        assert sc >= MIN_KMER_PAIR_SCORE


def test_diag_hsp_kadane_matches_loop():
    rng = np.random.default_rng(0)
    s = get_tables().mu_prefilter_mx_int8.astype(np.int64)
    for _ in range(20):
        q = rng.integers(0, 36, 50).astype(np.uint8)
        t = rng.integers(0, 36, 60).astype(np.uint8)
        d = int(rng.integers(0, 100))
        got = diag_hsp_scores(get_tables().mu_prefilter_mx_int8, q, t,
                              np.array([d]))[0]
        # direct loop (FindHSP, src/prefiltermu.cpp:27-47)
        ql, tl = len(q), len(t)
        i = max(ql - d - 1, 0)
        j = max(d - ql + 1, 0)
        b = f = 0
        while i < ql and j < tl:
            f += int(s[q[i], t[j]])
            if f > b:
                b = f
            elif f < 0:
                f = 0
            i += 1
            j += 1
        assert got == b


def test_self_prefilter_selects_self():
    rng = np.random.default_rng(1)
    mus = [rng.integers(0, 36, 80).astype(np.uint8) for _ in range(3)]
    res = prefilter_search(mus, list(enumerate(mus)))
    for qi in range(3):
        assert qi in [t for t, _s in res.query_targets[qi]]


def test_scop40_scale_prefilter_parity():
    """1hhs query vs the 11,211-chain scop40.mu.fa, exact mode, checked
    against the reference binary's -prefilter_mu -output2 scores (golden
    tests/golden/scop40_prefilter_1hhs_scores.tsv, produced with
    `reseek -prefilter_mu 1hhs.mu.fa -db scop40.mu.fa -threads 1`).

    All kept targets must score identically; the kept SET may differ only
    at the boundary (lowest-kept) score, where the reference's lazy
    2B-truncation quicksort breaks ties by internal order
    (src/rankedscoresbag.cpp:5-51)."""
    import os
    import numpy as np
    from reseek_tpu.encoder.dss import encode_chain
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.search.prefilter import (_swap_kl, prefilter_search,
                                             read_mu_fasta)
    from tests.conftest import GOLDEN, TEST_DATA

    scopfa = os.path.join(TEST_DATA, "scop40.mu.fa")
    if not os.path.exists(scopfa):
        import pytest
        pytest.skip("scop40.mu.fa not available")
    # query Mu letters exactly as the reference -convert2mu FASTA would
    # round-trip them (encode -> ASCII -> g_CharToLetterMu)
    chain = read_bca(os.path.join(TEST_DATA, "1hhs.bca"))[0]
    q_mu = _swap_kl(encode_chain(chain).mu_letters)
    tlabels, t_mu = read_mu_fasta(scopfa)
    pf = prefilter_search([q_mu], enumerate(t_mu), mode="exact",
                          ascii_roundtrip=False)
    ours = {tlabels[t]: s for t, s in pf.query_targets[0]}

    ref = {}
    with open(os.path.join(GOLDEN, "scop40_prefilter_1hhs_scores.tsv")) as f:
        for line in f:
            _q, t, s = line.rstrip("\n").split("\t")[:3]
            ref[t] = int(s)
    assert len(ours) == len(ref) == 1500
    boundary = min(ref.values())
    common = set(ref) & set(ours)
    assert all(ref[k] == ours[k] for k in common)
    sym = set(ref) ^ set(ours)
    assert len(sym) <= 4
    for k in sym:
        assert (ref.get(k, ours.get(k))) == boundary


def test_rankedscoresbag_compaction():
    """Periodic top-B compaction never changes the final selection
    (reference lazy-2B truncation semantics, rankedscoresbag.h:23)."""
    import numpy as np
    from reseek_tpu.search.prefilter import RankedScoresBag
    rng = np.random.default_rng(0)
    a = RankedScoresBag(5, top_b=7)
    b = RankedScoresBag(5, top_b=7)
    a.COMPACT_ROWS = 10  # force frequent compaction
    for _ in range(60):
        n = int(rng.integers(1, 30))
        q = rng.integers(0, 5, n)
        t = rng.integers(0, 1000, n)
        s = rng.integers(0, 50, n)
        a.add_chunk(q, t, s)
        b.add_chunk(q, t, s)
    assert a.finish().query_targets == b.finish().query_targets
