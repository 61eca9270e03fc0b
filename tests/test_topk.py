"""Collective top-B merge (parallel/topk.py): mesh selection must equal
the single-host RankedScoresBag selection exactly."""

import os

import numpy as np

from conftest import TEST_DATA

Q10 = os.path.join(TEST_DATA, "q10.bca")
Q100 = os.path.join(TEST_DATA, "q100.bca")


def _mesh(n):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:n]), ("db",))


def test_sharded_prefilter_matches_single():
    from reseek_tpu.encoder.dss import encode_chain
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.parallel.topk import sharded_prefilter_search
    from reseek_tpu.search.prefilter import prefilter_search

    q_mu = [encode_chain(c).mu_letters for c in read_bca(Q10)]
    t_mu = [encode_chain(c).mu_letters for c in read_bca(Q100)]

    single = prefilter_search(q_mu, list(enumerate(t_mu)))
    merged = sharded_prefilter_search(q_mu, t_mu, _mesh(8))
    assert merged.query_targets == single.query_targets


def test_sharded_prefilter_truncation_ties():
    """Force top-B truncation (B=5) so the global cutoff crosses shard
    boundaries; the merged selection must still equal single-host
    (score desc, target-index-ascending tie-break)."""
    from reseek_tpu.encoder.dss import encode_chain
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.parallel.topk import sharded_prefilter_search
    from reseek_tpu.search.prefilter import prefilter_search

    q_mu = [encode_chain(c).mu_letters for c in read_bca(Q10)]
    t_mu = [encode_chain(c).mu_letters for c in read_bca(Q100)]

    single = prefilter_search(q_mu, list(enumerate(t_mu)), top_b=5)
    merged = sharded_prefilter_search(q_mu, t_mu, _mesh(8), top_b=5)
    assert merged.query_targets == single.query_targets


def test_merge_topk_synthetic_ties():
    """Dense synthetic tie stress: many equal scores across shards."""
    from reseek_tpu.parallel.topk import merge_topk_sharded

    rng = np.random.default_rng(7)
    n_dev, nq, nt, top_b = 4, 3, 64, 6
    scores = rng.integers(0, 4, (nq, nt)).astype(np.int32)  # heavy ties
    # reference selection: per query by (-score, tidx)
    want = []
    for qi in range(nq):
        order = np.lexsort((np.arange(nt), -scores[qi]))
        want.append([(int(t), int(scores[qi][t]))
                     for t in order[:top_b]])

    bounds = np.linspace(0, nt, n_dev + 1).astype(int)
    sv, ti = [], []
    for d in range(n_dev):
        lo, hi = bounds[d], bounds[d + 1]
        loc_sv = np.full((nq, top_b), -(1 << 30), np.int32)
        loc_ti = np.full((nq, top_b), 2**31 - 1, np.int32)
        for qi in range(nq):
            order = np.lexsort((np.arange(lo, hi), -scores[qi, lo:hi]))
            for k, t in enumerate(order[:top_b]):
                loc_sv[qi, k] = scores[qi, lo + t]
                loc_ti[qi, k] = lo + t
        sv.append(loc_sv)
        ti.append(loc_ti)

    got = merge_topk_sharded(_mesh(n_dev), "db", sv, ti, top_b)
    assert got == want


def test_multihost_degenerate_process():
    """Multi-host orchestration (parallel/multihost.py) with the
    single-process degenerate case + virtual mesh: shard bounds tile the
    DB, and distributed_prefilter's global selection equals the
    single-host prefilter."""
    from reseek_tpu.encoder.dss import encode_chain
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.parallel.multihost import (distributed_prefilter,
                                               host_shard_bounds,
                                               init_distributed)
    from reseek_tpu.search.prefilter import prefilter_search

    pid, nproc = init_distributed()
    assert (pid, nproc) == (0, 1)
    assert host_shard_bounds(100, 0, 1) == (0, 100)
    b = [host_shard_bounds(101, i, 4) for i in range(4)]
    assert b[0][0] == 0 and b[-1][1] == 101
    assert all(b[i][1] == b[i + 1][0] for i in range(3))

    q_mu = [encode_chain(c).mu_letters for c in read_bca(Q10)]
    t_mu = [encode_chain(c).mu_letters for c in read_bca(Q100)]
    lo, hi = host_shard_bounds(len(t_mu), pid, nproc)
    merged = distributed_prefilter(q_mu, t_mu[lo:hi], lo, _mesh(8))
    single = prefilter_search(q_mu, list(enumerate(t_mu)))
    assert merged.query_targets == single.query_targets
