"""Row-sweep SW (ops/sw_sweep.py) vs the exact reference kernel
(ops/sw_np.py) on integer matrices — scores must be bit-identical."""

import numpy as np
import pytest

from reseek_tpu.ops.sw_np import sw_score
from reseek_tpu.ops.sw_sweep import (mu_filter_mask_sweep, mu_scores_sweep,
                                     sw_score_sweep)

NEG = np.float32(-9e9)


def _pad_batch(mats, la, lb):
    s = np.full((len(mats), la, lb), NEG, np.float32)
    for k, m in enumerate(mats):
        s[k, :m.shape[0], :m.shape[1]] = m
    return s


def test_sweep_matches_reference_random_int():
    rng = np.random.default_rng(7)
    mats = []
    for _ in range(24):
        a, b = rng.integers(3, 60, 2)
        mats.append(rng.integers(-7, 5, (a, b)).astype(np.float32))
    s = _pad_batch(mats, 64, 64)
    got = np.asarray(sw_score_sweep(s, -2.0, -1.0))
    for k, m in enumerate(mats):
        assert got[k] == sw_score(m, -2.0, -1.0)


def test_sweep_rectangular_and_gap_params():
    rng = np.random.default_rng(3)
    mats = [rng.integers(-9, 6, (17, 83)).astype(np.float32),
            rng.integers(-9, 6, (40, 128)).astype(np.float32)]
    s = _pad_batch(mats, 40, 128)
    got = np.asarray(sw_score_sweep(s, -11.0, -1.0))
    for k, m in enumerate(mats):
        assert got[k] == sw_score(m, -11.0, -1.0)


def test_mu_filter_mask_matches_pair_aligner(q10_chains):
    """Gate decisions equal the host PairAligner on real encoded chains."""
    import jax.numpy as jnp

    from reseek_tpu.align.pipeline import PairAligner, encode_for_search
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.search.engine import _mu_matrix_padded

    params = DSSParams.create("sensitive")
    chains = q10_chains
    ecs = [encode_for_search(c, params, with_self_rev=False) for c in chains]
    lens = np.array([len(e) for e in ecs])
    lmax = int(lens.max())
    n = len(ecs)
    mu = np.full((n, lmax), 36, np.uint8)
    mu_rev = np.full((n, lmax), 36, np.uint8)
    for i, e in enumerate(ecs):
        mu[i, :len(e)] = e.mu_letters
        mu_rev[i, :len(e)] = e.mu_letters[::-1]
    mumx = jnp.asarray(_mu_matrix_padded())
    pa = PairAligner(params)
    o, e_ = -float(params.para_mu_gap_open), -float(params.para_mu_gap_ext)

    pairs = [(i, j) for i in range(n) for j in range(i, n)]
    # canonical orientation: shorter chain on the A side
    ia = np.array([i if lens[i] <= lens[j] else j for i, j in pairs])
    ib = np.array([j if lens[i] <= lens[j] else i for i, j in pairs])
    la = int(lens[ia].max())
    lb = int(lens[ib].max())
    mask = np.asarray(mu_filter_mask_sweep(
        jnp.asarray(mu), jnp.asarray(mu_rev), jnp.asarray(ia),
        jnp.asarray(ib), mumx, la, lb, o, e_,
        float(params.omega_fwd), float(params.omega)))
    fwd, rev = mu_scores_sweep(
        jnp.asarray(mu), jnp.asarray(mu_rev), jnp.asarray(ia),
        jnp.asarray(ib), mumx, la, lb, o, e_)
    fwd, rev = np.asarray(fwd), np.asarray(rev)
    for k, (i, j) in enumerate(pairs):
        want = pa.mu_filter(ecs[i], ecs[j])
        assert bool(mask[k]) == want, (i, j, fwd[k], rev[k])
        # scores match the host kernel (with parasail saturation) exactly
        exact = pa.mu_filter_score(ecs[i], ecs[j])
        fe = 777.0 if fwd[k] > 250.0 else float(fwd[k])
        re_ = 255.0 if rev[k] > 250.0 else float(rev[k])
        if exact != 0.0:  # 0 means rejected before rev in the host path
            assert fe - re_ == exact


@pytest.mark.parametrize("kernels", [False, True])
def test_mu_sw_scores_kernel_choice(monkeypatch, kernels):
    """mu_sw_scores routes to the CUDA kernel only when asked; the plain
    path is the one-hot smx + scan sweep."""
    import jax.numpy as jnp

    from reseek_tpu.ops import sw_cuda
    from reseek_tpu.ops.sw_sweep import mu_smx_onehot, mu_sw_scores
    from reseek_tpu.search.engine import _mu_matrix_padded

    calls = []

    def fake_cuda(a, b, mumx, o, e):
        calls.append((a.shape, b.shape, o, e))
        return jnp.zeros(a.shape[0], jnp.float32)

    monkeypatch.setattr(sw_cuda, "mu_sw_scores_cuda", fake_cuda)
    rng = np.random.default_rng(4)
    a = jnp.asarray(rng.integers(0, 36, (3, 20)).astype(np.int32))
    b = jnp.asarray(rng.integers(0, 36, (3, 33)).astype(np.int32))
    mumx = jnp.asarray(_mu_matrix_padded())
    got = np.asarray(mu_sw_scores(a, b, mumx, -2.0, -1.0, kernels))
    if kernels:
        assert calls == [((3, 20), (3, 33), -2.0, -1.0)]
    else:
        assert calls == []
        want = np.asarray(sw_score_sweep(mu_smx_onehot(a, b, mumx),
                                         -2.0, -1.0))
        assert np.array_equal(got, want)
