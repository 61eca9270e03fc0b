"""The CUDA Smith-Waterman kernels (ops/sw_cuda.py, native/cuda/).

Their lane code (native/sw_lanes.h) is checked here through its host
build, lane by lane, against the plain references: the scan sweep for
the Mu filter, and the wavefront + walk (ops/sw_jax.py,
ops/postalign_jax.py) and the numpy reference (ops/sw_np.py) for the
traceback kernel.  The kernels themselves run only on the card: the
tests marked `gpu` compare them with the same references there."""

import numpy as np
import pytest

from reseek_tpu.constants import ALPHA_SIZES, DSSParams
from reseek_tpu.ops import sw_cuda

PARAMS = DSSParams.create("sensitive")
SIZES = tuple(ALPHA_SIZES[f] for f in PARAMS.features)
CODE_CHAR = {1: "M", 2: "D", 3: "I"}


def _mumx():
    from reseek_tpu.search.engine import _mu_matrix_padded
    return _mu_matrix_padded()


def _random_letters(rng, n, la, lb, related=True):
    a = np.full((n, la), 36, np.uint8)
    b = np.full((n, lb), 36, np.uint8)
    for k in range(n):
        x, y = rng.integers(3, la + 1), rng.integers(3, lb + 1)
        a[k, :x] = rng.integers(0, 36, x)
        b[k, :y] = rng.integers(0, 36, y)
        if related and k % 2 == 0:
            m = min(x, y)
            keep = rng.random(m) < 0.7
            b[k, :m] = np.where(keep, a[k, :m], b[k, :m])
    return a, b


def _mu_sweep_reference(a, b):
    import jax.numpy as jnp
    from reseek_tpu.ops.sw_sweep import mu_smx_onehot, sw_score_sweep
    o = -float(PARAMS.para_mu_gap_open)
    e = -float(PARAMS.para_mu_gap_ext)
    s = mu_smx_onehot(jnp.asarray(a.astype(np.int32)),
                      jnp.asarray(b.astype(np.int32)), jnp.asarray(_mumx()))
    return np.asarray(sw_score_sweep(s, o, e))


def _random_profiles(rng, n, la, lb):
    pa = np.full((n, len(SIZES), la), 255, np.uint8)
    pb = np.full((n, len(SIZES), lb), 255, np.uint8)
    for k in range(n):
        x, y = rng.integers(3, la + 1), rng.integers(3, lb + 1)
        for f, sz in enumerate(SIZES):
            pa[k, f, :x] = rng.integers(0, sz, x)
            pb[k, f, :y] = rng.integers(0, sz, y)
        if k % 2 == 0:
            m = min(x, y)
            pb[k, :, :m] = pa[k, :, :m]
    return pa, pb


def _align_reference(pa, pb):
    """Feature-ordered gather smx -> wavefront -> walk (the plain path the
    kernel must equal bit for bit), plus the cell-layout traceback."""
    import jax
    import jax.numpy as jnp
    from reseek_tpu.ops.postalign_jax import walk_traceback_batch
    from reseek_tpu.ops.smx_jax import flat_layout, smx_batch_gather
    from reseek_tpu.ops.sw_jax import sw_traceback_batch
    offsets, d, w = flat_layout(PARAMS.features, PARAMS.weights)

    def codes(p):
        return np.where(p == 255, d,
                        p.astype(np.int32) + offsets[None, :, None])

    s = smx_batch_gather(jnp.asarray(codes(pa)), jnp.asarray(codes(pb)),
                         jnp.asarray(w), None)
    tb_fn = jax.jit(sw_traceback_batch, static_argnames=("open_", "ext"))
    best, bi, bj, tbs = tb_fn(s, float(PARAMS.gap_open),
                              float(PARAMS.gap_ext))
    walked = walk_traceback_batch(tbs, best, bi, bj)
    la, lb = pa.shape[2], pb.shape[2]
    i = np.arange(la)[:, None]
    j = np.arange(lb)[None, :]
    tbs = np.asarray(tbs)
    cells = np.stack([tbs[i + j, k, i] for k in range(pa.shape[0])])
    return (tuple(np.asarray(x) for x in (best, bi, bj) + tuple(walked)),
            cells, np.asarray(s))


def _kernel_inputs(pa, pb):
    import jax.numpy as jnp
    from reseek_tpu.ops.smx_jax import flat_layout
    _offsets, _d, w = flat_layout(PARAMS.features, PARAMS.weights)
    tbl = np.asarray(sw_cuda.align_table(jnp.asarray(w), SIZES))
    ca = np.asarray(sw_cuda.profile_codes(jnp.asarray(pa), SIZES))
    cb = np.asarray(sw_cuda.profile_codes(jnp.asarray(pb), SIZES))
    return ca, cb, tbl, sw_cuda.align_meta(SIZES)


@pytest.mark.parametrize("la,want", [(1, 4), (96, 4), (128, 4), (129, 8),
                                     (256, 8), (257, 16), (1024, 16)])
def test_lanes_per_row_strip(la, want):
    assert sw_cuda.lanes_k(la) == want
    assert sw_cuda._host_lanes().swl_lanes_k(la) == want
    k = want
    npass = -(-la // (32 * k))
    assert sw_cuda.tb_pair_bytes(la, 100) == npass * 131 * 32 * k


@pytest.mark.parametrize("la,lb", [(40, 70), (128, 128), (200, 130),
                                   (700, 300), (1100, 64), (96, 1024)])
def test_mu_lanes_match_sweep(la, lb):
    """Single- and multi-pass strips, rectangular both ways."""
    rng = np.random.default_rng(la * 7 + lb)
    a, b = _random_letters(rng, 4, la, lb)
    tab = np.asarray(sw_cuda.mu_table(_mumx()))
    got = sw_cuda.emulate_mu_scores(
        a, b, tab, -PARAMS.para_mu_gap_open, -PARAMS.para_mu_gap_ext)
    assert np.array_equal(got, _mu_sweep_reference(a, b))


def test_mu_lanes_real_letters(q10_chains):
    """Mu letters of real chains, fwd and reversed, saturating scores
    included (self pairs)."""
    from reseek_tpu.encoder.dss import encode_chain
    mus = [encode_chain(c).mu_letters for c in q10_chains]
    lmax = max(len(m) for m in mus)
    n = len(mus)
    a = np.full((n * n, lmax), 36, np.uint8)
    b = np.full((n * n, lmax), 36, np.uint8)
    for i in range(n):
        for j in range(n):
            a[i * n + j, :len(mus[i])] = mus[i][::-1] if j % 3 else mus[i]
            b[i * n + j, :len(mus[j])] = mus[j]
    tab = np.asarray(sw_cuda.mu_table(_mumx()))
    got = sw_cuda.emulate_mu_scores(a, b, tab, -2, -1)
    assert np.array_equal(got, _mu_sweep_reference(a, b))
    assert got.max() > 250  # self pairs saturate the 8-bit filter


def test_mu_table_padding():
    tab = np.asarray(sw_cuda.mu_table(_mumx())).reshape(37, 37)
    assert (tab[36] == sw_cuda.MU_PAD_SCORE).all()
    assert (tab[:, 36] == sw_cuda.MU_PAD_SCORE).all()
    assert np.array_equal(tab[:36, :36], _mumx()[:36, :36].astype(np.int32))


@pytest.mark.parametrize("la,lb", [(30, 50), (128, 128), (256, 100),
                                   (600, 300), (100, 640)])
def test_align_lanes_match_wavefront(la, lb):
    """Scores, best cells, every traceback bit and the walked path equal
    the plain wavefront + walk bit for bit (multi-pass included)."""
    rng = np.random.default_rng(la + 3 * lb)
    pa, pb = _random_profiles(rng, 3, la, lb)
    ca, cb, tbl, meta = _kernel_inputs(pa, pb)
    got = sw_cuda.emulate_align(ca, cb, tbl, meta, len(SIZES),
                                PARAMS.gap_open, PARAMS.gap_ext)
    want, cells, _s = _align_reference(pa, pb)
    for g, w in zip(got[:7], want):
        assert np.array_equal(g, w)
    assert np.array_equal(sw_cuda.unpack_tb(got[7], la, lb), cells)


def test_align_lanes_match_reference_on_chains(q10_chains):
    """Real profiles against the numpy reference aligner (sw_np.sw_align
    over the reference-order substitution matrix)."""
    from reseek_tpu.align.pipeline import encode_for_search
    from reseek_tpu.ops.substmx import build_smx
    from reseek_tpu.ops.sw_np import sw_align
    ecs = [encode_for_search(c, PARAMS, with_self_rev=False)
           for c in q10_chains[:6]]
    pairs = [(i, j) for i in range(len(ecs)) for j in range(len(ecs))]
    la = max(len(e) for e in ecs)
    nf = len(SIZES)
    pa = np.full((len(pairs), nf, la), 255, np.uint8)
    pb = np.full((len(pairs), nf, la), 255, np.uint8)
    for k, (i, j) in enumerate(pairs):
        pa[k, :, :len(ecs[i])] = ecs[i].profile
        pb[k, :, :len(ecs[j])] = ecs[j].profile
    ca, cb, tbl, meta = _kernel_inputs(pa, pb)
    best, _bi, _bj, lo_a, lo_b, plen, path, _tb = sw_cuda.emulate_align(
        ca, cb, tbl, meta, nf, PARAMS.gap_open, PARAMS.gap_ext)
    for k, (i, j) in enumerate(pairs):
        smx = build_smx(PARAMS, ecs[i].profile, ecs[j].profile)
        score, ra, rb, rpath = sw_align(smx, PARAMS.gap_open, PARAMS.gap_ext)
        got_path = "".join(CODE_CHAR[c] for c in path[k, :plen[k]][::-1])
        assert (float(best[k]), int(lo_a[k]), int(lo_b[k]), got_path) \
            == (score, ra, rb, rpath)


def test_align_table_layout():
    """Per-feature blocks of W with the padding row/column, and the meta
    words the kernel indexes them with."""
    import jax.numpy as jnp
    from reseek_tpu.ops.smx_jax import flat_layout
    offsets, d, w = flat_layout(PARAMS.features, PARAMS.weights)
    tbl = np.asarray(sw_cuda.align_table(jnp.asarray(w), SIZES))
    meta = sw_cuda.align_meta(SIZES).astype(np.int64)
    assert len(tbl) == sum((s + 1) ** 2 for s in SIZES)
    for f, sz in enumerate(SIZES):
        base, stride = meta[f], meta[8 + f]
        assert stride == sz + 1
        blk = tbl[base: base + stride * stride].reshape(stride, stride)
        off = offsets[f]
        assert np.array_equal(blk[:sz, :sz], w[off:off + sz, off:off + sz])
        assert (blk[sz] == w[d, 0]).all() and (blk[:, sz] == w[d, 0]).all()
    pads = (meta[16] & 0xffffffff) | ((meta[17] & 0xffffffff) << 32)
    assert [(int(pads) >> (8 * f)) & 255 for f in range(8)] == list(SIZES)


def test_profile_codes_padding():
    import jax.numpy as jnp
    prof = np.array([[[0, 3, 255], [19, 255, 255]]], np.uint8)
    got = np.asarray(sw_cuda.profile_codes(jnp.asarray(prof), (4, 20)))
    assert got.shape == (1, 3, 8)
    assert got[0, :, :2].tolist() == [[0, 19], [3, 20], [4, 20]]
    assert (got[0, :, 2:] == 0).all()


def test_align_supported_features():
    assert sw_cuda.align_supported(PARAMS.features)
    assert not sw_cuda.align_supported(("AA",) * 9)


@pytest.mark.gpu
def test_cuda_mu_kernel_matches_sweep(gpu):
    import jax.numpy as jnp
    rng = np.random.default_rng(21)
    for la, lb in [(128, 128), (256, 512), (1024, 1024)]:
        a, b = _random_letters(rng, 64, la, lb)
        got = np.asarray(sw_cuda.mu_sw_scores_cuda(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(_mumx()), -2.0,
            -1.0))
        assert np.array_equal(got, _mu_sweep_reference(a, b))


@pytest.mark.gpu
def test_cuda_align_kernel_matches_wavefront(gpu):
    import jax.numpy as jnp
    rng = np.random.default_rng(22)
    for la, lb in [(128, 128), (512, 256), (1024, 1024)]:
        pa, pb = _random_profiles(rng, 8, la, lb)
        ca, cb, tbl, meta = _kernel_inputs(pa, pb)
        got = [np.asarray(x) for x in sw_cuda.sw_align_cuda(
            jnp.asarray(ca), jnp.asarray(cb), jnp.asarray(tbl), meta,
            len(SIZES), PARAMS.gap_open, PARAMS.gap_ext)]
        want, cells, _s = _align_reference(pa, pb)
        for g, w in zip(got[:7], want):
            assert np.array_equal(g, w)
        assert np.array_equal(sw_cuda.unpack_tb(got[7], la, lb), cells)
