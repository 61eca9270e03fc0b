"""SW kernel: fuzz the wavefront implementation against a direct
transliteration of the reference's row-scan (src/sw.cpp:79-212)."""

import numpy as np
import pytest

from reseek_tpu.ops.sw_np import sw_align, sw_score

DM, IM, MD, MI, SM = 1, 2, 4, 8, 16


def sw_transliterated(S, Open, Ext):
    """Line-by-line port of SWFast + TraceBackBitSW for testing."""
    LA, LB = S.shape
    MINF = np.float32(-9e9)
    Open = np.float32(Open)
    Ext = np.float32(Ext)
    Mrow = np.full(LB + 1, MINF, np.float32)
    Drow = np.full(LB + 1, MINF, np.float32)
    TB = np.zeros((LA, LB), np.uint8)
    Best = np.float32(0.0)
    bi = bj = -1
    M0 = np.float32(0.0)
    for i in range(LA):
        I0 = MINF
        for j in range(LB):
            tb = 0
            SavedM0 = M0
            xM = M0
            if Drow[j] > xM:
                xM = Drow[j]
                tb = DM
            if I0 > xM:
                xM = I0
                tb = IM
            if np.float32(0.0) >= xM:
                xM = np.float32(0.0)
                tb = SM
            M0 = Mrow[j]
            xM = np.float32(xM + S[i, j])
            if xM > Best:
                Best = xM
                bi, bj = i, j
            Mrow[j] = xM
            md = np.float32(SavedM0 + Open)
            Drow[j] = np.float32(Drow[j] + Ext)
            if md >= Drow[j]:
                Drow[j] = md
                tb |= MD
            mi = np.float32(SavedM0 + Open)
            I0 = np.float32(I0 + Ext)
            if mi >= I0:
                I0 = mi
                tb |= MI
            TB[i, j] = tb
        M0 = MINF
    if Best == 0.0:
        return 0.0, 0, 0, ""
    i, j = bi + 1, bj + 1
    state = "M"
    path = []
    while True:
        path.append(state)
        if state == "M":
            t = TB[i - 1][j - 1]
            if t & DM:
                state = "D"
            elif t & IM:
                state = "I"
            elif t & SM:
                break
            i -= 1
            j -= 1
        elif state == "D":
            t = TB[i - 1][j]
            state = "M" if (t & MD) else "D"
            i -= 1
        else:
            t = TB[i][j - 1]
            state = "M" if (t & MI) else "I"
            j -= 1
    path.reverse()
    # caller passes Besti+1: Leni = (bi+1) - i + 1; Loi = (bi+1) - Leni = i-1
    return float(Best), i - 1, j - 1, "".join(path)


@pytest.mark.parametrize("seed,gaps", [(0, (-0.685533, -0.051881)),
                                       (1, (-2.0, -1.0)),
                                       (2, (-0.685533, -0.051881))])
def test_sw_fuzz_vs_transliteration(seed, gaps):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        LA = int(rng.integers(1, 36))
        LB = int(rng.integers(1, 36))
        S = rng.normal(0.25, 1.2, (LA, LB)).astype(np.float32)
        ref = sw_transliterated(S, *gaps)
        mine = sw_align(S, *gaps)
        assert ref == mine
        assert sw_score(S, *gaps) == ref[0]


def test_sw_empty_and_negative():
    S = np.full((4, 4), -1.0, np.float32)
    assert sw_score(S, -1.0, -0.5) == 0.0
    assert sw_align(S, -1.0, -0.5) == (0.0, 0, 0, "")


def test_sw_perfect_diagonal():
    S = np.full((5, 5), -1.0, np.float32)
    np.fill_diagonal(S, 2.0)
    score, lo_a, lo_b, path = sw_align(S, -1.0, -0.5)
    assert score == 10.0 and lo_a == 0 and lo_b == 0 and path == "MMMMM"


def _random_batch(rng, b, la, lb, integer=True):
    """NEG-padded batch with ragged valid regions."""
    from reseek_tpu.ops.sw_np import NEG
    s = np.full((b, la, lb), NEG, np.float32)
    las = rng.integers(3, la + 1, b)
    lbs = rng.integers(3, lb + 1, b)
    for k in range(b):
        if integer:
            v = rng.integers(-3, 4, (las[k], lbs[k])).astype(np.float32)
        else:
            v = rng.normal(0, 2, (las[k], lbs[k])).astype(np.float32)
        s[k, :las[k], :lbs[k]] = v
    return s, las, lbs


@pytest.mark.parametrize("integer", [True, False])
def test_wavefront_score_parity(integer):
    """The plain JAX wavefront (ops/sw_jax.py) scores padded, tie-prone
    batches exactly like the numpy reference."""
    import jax.numpy as jnp
    from reseek_tpu.ops.sw_jax import sw_score_batch
    rng = np.random.default_rng(1)
    s, las, lbs = _random_batch(rng, 9, 40, 56, integer)
    got = np.asarray(sw_score_batch(jnp.asarray(s), -2.0, -0.5))
    for k in range(9):
        want = sw_score(s[k, :las[k], :lbs[k]], -2.0, -0.5)
        assert got[k] == np.float32(want), (k, got[k], want)


def test_wavefront_traceback_parity():
    """Wavefront traceback bits + host walk reproduce the reference
    alignment on padded, tie-prone integer batches."""
    import jax.numpy as jnp
    from reseek_tpu.ops.sw_jax import _tb_jit, walk_traceback
    rng = np.random.default_rng(2)
    b = 8
    s, las, lbs = _random_batch(rng, b, 33, 41, integer=True)
    best, bi, bj, tb = (np.asarray(x) for x in
                        _tb_jit(jnp.asarray(s), -1.5, -0.25))
    for k in range(b):
        want_score, lo_a, lo_b, path = sw_align(
            s[k, :las[k], :lbs[k]], -1.5, -0.25)
        if want_score <= 0:
            assert best[k] <= 0
            continue
        assert best[k] == np.float32(want_score)
        assert walk_traceback(tb[:, k, :], int(bi[k]), int(bj[k])) \
            == (lo_a, lo_b, path)
