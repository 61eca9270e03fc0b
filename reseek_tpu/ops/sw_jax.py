"""Batched Smith-Waterman in JAX: anti-diagonal wavefront as lax.scan.

Same recurrences and tie rules as the host kernel (reseek_tpu/ops/sw_np.py,
itself a replica of src/sw.cpp:79-212).  Dependencies only cross
anti-diagonals, so each scan step is an elementwise update over [B, LA]
state vectors — elementwise work with no data-dependent control flow.

Two entry points:
- sw_score_batch:   score-only forward pass (the hot path)
- sw_traceback_batch: also emits per-diagonal traceback bits + best cell,
  for the survivor pool that needs paths/CIGARs/LDDT
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = np.float32(-9e9)


def _skew(s: jnp.ndarray) -> jnp.ndarray:
    """S [B, LA, LB] -> S_skew [D, B, LA] with S_skew[d,b,i] = S[b,i,d-i]
    (NEG outside)."""
    b, la, lb = s.shape
    d = la + lb - 1
    jd = (jnp.arange(d)[None, :] - jnp.arange(la)[:, None])  # [LA, D]
    valid = (jd >= 0) & (jd < lb)
    jc = jnp.clip(jd, 0, lb - 1)
    out = jnp.take_along_axis(s, jc[None, :, :], axis=2)  # [B, LA, D]
    out = jnp.where(valid[None, :, :], out, NEG)
    return jnp.transpose(out, (2, 0, 1))  # [D, B, LA]


def _shift1(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([jnp.full_like(x[:, :1], NEG), x[:, :-1]], axis=1)


def _shift2(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([jnp.full_like(x[:, :2], NEG), x[:, :-2]], axis=1)


def _step_core(h1, h2, h3, e1, f1, s_diag, open_, ext):
    e_open = _shift2(h3) + open_
    e_ext = _shift1(e1) + ext
    e_pref = e_open >= e_ext
    e = jnp.where(e_pref, e_open, e_ext)

    f_open = _shift1(h3) + open_
    f_ext = f1 + ext
    f_pref = f_open >= f_ext
    f = jnp.where(f_pref, f_open, f_ext)

    m = _shift1(h2)
    src = jnp.zeros(m.shape, jnp.uint8)
    be = e > m
    m = jnp.where(be, e, m)
    src = jnp.where(be, np.uint8(1), src)
    bf = f > m
    m = jnp.where(bf, f, m)
    src = jnp.where(bf, np.uint8(2), src)
    rs = np.float32(0.0) >= m
    m = jnp.where(rs, np.float32(0.0), m)
    src = jnp.where(rs, np.uint8(3), src)

    h = m + s_diag
    return h, e, f, src, e_pref, f_pref


@functools.partial(jax.jit, static_argnames=("open_", "ext"))
def sw_score_batch(s: jnp.ndarray, open_: float,
                   ext: float) -> jnp.ndarray:
    """s: [B, LA, LB] f32 (NEG-padded).  Returns best scores [B] (>= 0)."""
    b, la, lb = s.shape
    s_skew = _skew(s)

    # derive the carries from s so they inherit any shard_map varying
    # axes (a plain jnp.full carry fails scan's vma type check)
    zrow = s[:, :, 0] * np.float32(0.0)   # [B, LA]

    def init():
        return zrow + NEG

    carry = (init(), init(), init(), init(), init(), zrow[:, 0])

    def step(carry, s_diag):
        h1, h2, h3, e1, f1, best = carry
        h, e, f, _src, _ep, _fp = _step_core(h1, h2, h3, e1, f1, s_diag,
                                             np.float32(open_), np.float32(ext))
        best = jnp.maximum(best, jnp.max(h, axis=1))
        return (h, h1, h2, e, f, best), None

    (h1, h2, h3, e1, f1, best), _ = jax.lax.scan(step, carry, s_skew)
    return best


def sw_traceback_batch(s: jnp.ndarray, open_: float, ext: float):
    """Returns (best [B], best_i [B], best_j [B], tb [D, B, LA] uint8).

    tb rows are in skewed layout; use unskew_traceback + walk_traceback to
    recover paths on the host."""
    b, la, lb = s.shape
    s_skew = _skew(s)
    iidx = jnp.arange(la)[None, :]

    # derive the zero carries from s so they inherit any shard_map varying
    # axes (a plain jnp.full carry fails scan's vma type check)
    zrow = s[:, :, 0] * np.float32(0.0)   # [B, LA]
    zvec = zrow[:, 0]                      # [B]

    def init():
        return zrow + NEG

    carry = (init(), init(), init(), init(), init(),
             zvec, zvec.astype(jnp.int32), zvec.astype(jnp.int32))

    def step(carry, s_diag_d):
        s_diag, d = s_diag_d
        h1, h2, h3, e1, f1, best, bi, bj = carry
        h, e, f, src, ep, fp = _step_core(h1, h2, h3, e1, f1, s_diag,
                                          np.float32(open_), np.float32(ext))
        # per-diagonal max with first-i tie (row-major first within diagonal)
        dmax = jnp.max(h, axis=1)
        di = jnp.argmax(h, axis=1).astype(jnp.int32)
        # row-major-first across diagonals: replace on strict > , or on ==
        # when the new cell has smaller i (see sw_np tie discussion)
        take = (dmax > best) | ((dmax == best) & (di < bi) & (best > 0))
        best = jnp.where(take, dmax, best)
        bi = jnp.where(take, di, bi)
        bj = jnp.where(take, d - di, bj)
        tb = src | jnp.where(ep, np.uint8(4), np.uint8(0)) \
            | jnp.where(fp, np.uint8(8), np.uint8(0))
        return (h, h1, h2, e, f, best, bi, bj), tb

    d = la + lb - 1
    (h1, h2, h3, e1, f1, best, bi, bj), tbs = jax.lax.scan(
        step, carry, (s_skew, jnp.arange(d, dtype=jnp.int32)))
    return best, bi, bj, tbs


_tb_jit = jax.jit(sw_traceback_batch, static_argnames=("open_", "ext"))


def walk_traceback(tb_skew: np.ndarray, best_i: int, best_j: int
                   ) -> Tuple[int, int, str]:
    """Host traceback walk over skewed TB [D, LA].

    The gap-preference bits emitted at diagonal d belong to the E/F values
    *used* at d, i.e. to the updates performed by cells on diagonal d-1 with
    the index mapping of sw_np (MD bit of E_d[i] -> cell (i-1, d-i); MI bit
    of F_d[i] -> cell (i, d-i-1)).  Rather than reshuffle, we read the bits
    from where they live:
      match src of cell (i,j):   tb_skew[i+j, i] & 3
      MD bit of cell (i,j):      tb_skew[i+j+1, i+1] & 4   (E_{d+1}[i+1])
      MI bit of cell (i,j):      tb_skew[i+j+1, i] & 8     (F_{d+1}[i])
    """
    def src(i, j):
        return tb_skew[i + j, i] & 3

    def md(i, j):
        return tb_skew[i + j + 1, i + 1] & 4

    def mi(i, j):
        return tb_skew[i + j + 1, i] & 8

    i, j = best_i + 1, best_j + 1
    state = "M"
    path = []
    while True:
        path.append(state)
        if state == "M":
            t = src(i - 1, j - 1)
            if t == 1:
                state = "D"
            elif t == 2:
                state = "I"
            elif t == 3:
                break
            i -= 1
            j -= 1
        elif state == "D":
            state = "M" if md(i - 1, j) else "D"
            i -= 1
        else:
            state = "M" if mi(i, j - 1) else "I"
            j -= 1
    path.reverse()
    return i - 1, j - 1, "".join(path)
