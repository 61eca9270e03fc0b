"""Device-side post-alignment ops: batched traceback walk and batched LDDT.

Traceback bits ([D, B, LA], tens of MB) are never fetched from the
device.  Instead the backward path walk runs on device as a masked
lax.scan over the skewed traceback tensor (the plain path; the CUDA
traceback kernel walks in-kernel), emitting compact per-pair outputs (lo
coords + reversed path codes), and LDDT runs on device from gathered
column positions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# path codes
PM, PD, PI, PEND = 1, 2, 3, 0


def walk_traceback_batch(tb: jnp.ndarray, best: jnp.ndarray,
                         bi: jnp.ndarray, bj: jnp.ndarray):
    """Batched backward walk of the SW traceback (sw.cpp:8-77 semantics).

    tb: [D, B, LA] uint8 skewed traceback (bits: 0-1 match src, 2 MD, 3 MI)
    Returns (lo_a [B], lo_b [B], plen [B], path_rev [B, D+1] uint8) where
    path_rev holds PM/PD/PI codes backward from the alignment end.
    """
    d_total, b, la = tb.shape
    max_steps = d_total + 1

    def gather_tb(i, j):
        # tb[i + j, :, i] per pair, clamped
        d = jnp.clip(i + j, 0, d_total - 1)
        ic = jnp.clip(i, 0, la - 1)
        return tb[d, jnp.arange(b), ic]

    def body(carry, _):
        i, j, st, done = carry
        # emit current state code (1=M, 2=D, 3=I) unless done
        code = jnp.where(done, np.uint8(PEND),
                         (st + 1).astype(jnp.uint8))

        t_m = gather_tb(i - 1, j - 1) & 3
        # MD bit of cell (i-1, j) and MI bit of cell (i, j-1) both live at
        # skew location [i+j, i] (see sw_jax.walk_traceback docstring)
        t_gap = gather_tb(i, j)
        t_md = t_gap & 4
        t_mi = t_gap & 8

        is_m = st == 0
        is_d = st == 1
        is_i = st == 2

        stop = is_m & (t_m == 3)
        nst = jnp.where(is_m & (t_m == 1), 1,
              jnp.where(is_m & (t_m == 2), 2,
              jnp.where(is_m, 0,
              jnp.where(is_d, jnp.where(t_md > 0, 0, 1),
                        jnp.where(t_mi > 0, 0, 2)))))
        ni = jnp.where(done, i, jnp.where(is_m | is_d, i - 1, i))
        nj = jnp.where(done, j, jnp.where(is_m | is_i, j - 1, j))
        ndone = done | stop
        # on stop we must NOT decrement (reference returns before --i/--j)
        ni = jnp.where(stop, i, ni)
        nj = jnp.where(stop, j, nj)
        return (ni, nj, jnp.where(done, st, nst).astype(st.dtype), ndone), code

    i0 = bi + 1
    j0 = bj + 1
    st0 = jnp.zeros_like(bi)
    done0 = best <= 0
    (fi, fj, _st, _done), codes = jax.lax.scan(
        body, (i0, j0, st0, done0), None, length=max_steps)
    path_rev = jnp.transpose(codes)  # [B, max_steps]
    plen = jnp.sum((path_rev != PEND).astype(jnp.int32), axis=1)
    return fi - 1, fj - 1, plen, path_rev


def lddt_batch(cq: jnp.ndarray, ct: jnp.ndarray, valid: jnp.ndarray,
               ncols: jnp.ndarray, with_risky: bool = False):
    """Batched LDDT_mu_fast (src/lddt.cpp:63-124).

    cq, ct: [B, M, 3] f32 gathered aligned-column coordinates
    valid:  [B, M] bool column mask; ncols: [B] int32 true column counts
    Column-score summation runs as a sequential scan to match the
    reference's left-to-right float32 accumulation exactly.

    Device sqrt/division and sum order need not match the host's, and the
    reference compiles its distance sum with FMA contraction (see fp.py),
    so device values can drift by ~1 ulp.  With with_risky=True a second output
    flags pairs where any threshold comparison (|d1-d2| vs {.5,1,2,4}) or
    the R0^2 gate sits within a safety margin of the boundary — callers
    recompute those on the host bit-exactly; for the rest the value is
    exact up to non-boundary division rounding (|error| < ~3e-7, which
    callers absorb with a display-band check)."""
    r0_sq = np.float32(225.0)

    def d2(c):
        d = c[:, :, None, :] - c[:, None, :, :]
        return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                + d[..., 2] * d[..., 2])

    a1 = d2(cq)
    a2 = d2(ct)
    pair_valid = (valid[:, :, None] & valid[:, None, :])
    m = cq.shape[1]
    iu = jnp.triu_indices(m, k=1)
    consider = ~((a1 > r0_sq) & (a2 > r0_sq)) & pair_valid
    # zero out diagonal & lower triangle by masking with upper-tri mask
    upper = (jnp.arange(m)[None, :, None] < jnp.arange(m)[None, None, :])
    consider = consider & upper

    d1 = jnp.sqrt(a1)
    dd = jnp.abs(d1 - jnp.sqrt(a2))
    npres = ((dd <= 0.5).astype(jnp.int32) + (dd <= 1.0)
             + (dd <= 2.0) + (dd <= 4.0))
    npres = jnp.where(consider, npres, 0)
    cons4 = jnp.where(consider, 4, 0)

    risky = None
    if with_risky:
        # margins sized from the actual device-vs-host error bounds
        # (2x slack): |dd| error <= ~1.5e-5 (two sqrt ulps at d <= ~20
        # plus the d^2 op-order difference propagated through sqrt);
        # |a - R0^2| error <= ~8e-5 near the 225 boundary (3 ulps of
        # 225).  Wider margins flag pairs ~linearly more often, and
        # every flagged pair costs a host recompute.
        near_t = jnp.zeros(dd.shape, bool)
        for t in (0.5, 1.0, 2.0, 4.0):
            near_t = near_t | (jnp.abs(dd - np.float32(t))
                               < np.float32(3e-5))
        near_r0 = ((jnp.abs(a1 - r0_sq) < np.float32(1e-3))
                   | (jnp.abs(a2 - r0_sq) < np.float32(1e-3)))
        anyp = (near_t & consider) | (near_r0 & pair_valid & upper)
        risky = jnp.any(jnp.any(anyp, axis=2), axis=1)

    preserved = jnp.sum(npres, axis=2) + jnp.sum(npres, axis=1)
    considered = jnp.sum(cons4, axis=2) + jnp.sum(cons4, axis=1)

    scores = jnp.where(considered > 0,
                       preserved.astype(jnp.float32)
                       / considered.astype(jnp.float32),
                       np.float32(0.0))
    scores = jnp.where(valid, scores, np.float32(0.0))

    # sequential f32 sum over columns (cumsum order == reference loop)
    def add(carry, x):
        c = carry + x
        return c, None

    # init carry derived from scores so it inherits shard_map varying axes
    total, _ = jax.lax.scan(add, scores[:, 0] * np.float32(0.0),
                            jnp.transpose(scores))
    out = total / jnp.maximum(ncols, 1).astype(jnp.float32)
    if with_risky:
        return out, risky
    return out
