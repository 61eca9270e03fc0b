"""Row-sweep Smith-Waterman for integer substitution matrices (the Mu
filter, reference src/parasail_mu.cpp / src/sw.cpp recurrences).

The wavefront kernel (ops/sw_jax.py, ops/sw_cuda.py) preserves the
reference's float32 rounding per cell, which matters for the full-profile
log-odds stages.  The 36-letter Mu filter, however, scores with an INTEGER
matrix (src/mumx_data.cpp IntScoreMx_Mu, -7..4) and integer gap penalties
(open 2 / ext 1, src/dssparams.h:45-46), so every DP value is an exact
small integer in float32 and ANY evaluation order gives bit-identical
scores.  That frees the kernel shape:

  - sweep rows (i over the A side, the shorter sequence), lanes = B side:
    LA sequential steps instead of LA+LB-1, and every lane does useful
    work (the wavefront computes ~2-8x padding cells)
  - the horizontal-gap recurrence F(i,j) = max(H(i-1,j-2)+open,
    F(i,j-1)+ext) reads ONLY the previous row (the reference folds S into
    H after the max, so F never depends on the current row).  Its closed
    form F(j) = j*ext + cummax_k<=j(A(k) - k*ext), A(k)=H(i-1,k-2)+open,
    is a Kogge-Stone scan: log2(LB) shifted maxes per row.
  - E(i,j) = max(H(i-2,j-1)+open, E(i-1,j)+ext) is elementwise.
  - H(i,j) = max(H(i-1,j-1), E, F, 0) + S(i,j).

All sums involve integers |v| << 2^24, exact in f32.  Scores equal
ops/sw_np.sw_score bit-for-bit (test_sw_sweep.py checks this).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = np.float32(-9e9)


def _cummax_lanes(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive running max along the last axis (Kogge-Stone)."""
    n = x.shape[-1]
    s = 1
    while s < n:
        shifted = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(s, 0)],
                          constant_values=NEG)[..., :n]
        x = jnp.maximum(x, shifted)
        s *= 2
    return x


def _row_step(h_prev, h_prev2, e_prev, s_row, open_, ext, kext):
    """One DP row given the previous two H rows; returns (h, e)."""
    # F(i,j) = max_k<=j ( H(i-1,k-2)+open + (j-k)*ext )
    a = jnp.pad(h_prev, [(0, 0)] * (h_prev.ndim - 1) + [(2, 0)],
                constant_values=NEG)[..., :h_prev.shape[-1]] + open_
    f = _cummax_lanes(a - kext) + kext
    # E(i,j) = max( H(i-2,j-1)+open, E(i-1,j)+ext )
    e = jnp.maximum(
        jnp.pad(h_prev2, [(0, 0)] * (h_prev2.ndim - 1) + [(1, 0)],
                constant_values=NEG)[..., :h_prev2.shape[-1]] + open_,
        e_prev + ext)
    m = jnp.pad(h_prev, [(0, 0)] * (h_prev.ndim - 1) + [(1, 0)],
                constant_values=NEG)[..., :h_prev.shape[-1]]
    m = jnp.maximum(jnp.maximum(m, e), jnp.maximum(f, np.float32(0.0)))
    return m + s_row, e


@functools.partial(jax.jit, static_argnames=("open_", "ext"))
def sw_score_sweep(s: jnp.ndarray, open_: float, ext: float) -> jnp.ndarray:
    """s: [B, LA, LB] f32 substitution tensor (NEG at padding).  Returns
    best local scores [B] (>= 0).  Exact for integer-valued s/open/ext."""
    b, la, lb = s.shape
    open_ = np.float32(open_)
    ext = np.float32(ext)
    kext = jnp.arange(lb, dtype=jnp.float32) * ext

    def step(carry, s_row):
        h_prev, h_prev2, e_prev, best = carry
        h, e = _row_step(h_prev, h_prev2, e_prev, s_row, open_, ext, kext)
        return (h, h_prev, e, jnp.maximum(best, h)), None

    # derive the init carry from s so it inherits any shard_map varying
    # axes (a plain jnp.full carry fails scan's vma type check)
    z0 = s[:, 0, :] * np.float32(0.0)
    z = z0 + NEG
    (h, h2, e, best), _ = jax.lax.scan(
        step, (z, z, z, z0), jnp.transpose(s, (1, 0, 2)))
    return jnp.maximum(jnp.max(best, axis=-1), np.float32(0.0))


def mu_sw_scores(a: jnp.ndarray, b: jnp.ndarray,
                 mumx_padded: jnp.ndarray, open_: float, ext: float,
                 kernels: bool = False) -> jnp.ndarray:
    """Mu SW scores for letter-array pairs a [B, LA], b [B, LB] (letter 36
    = padding).  kernels=True runs the CUDA kernel (ops/sw_cuda.py; the
    table is looked up in-kernel, no substitution tensor in device
    memory), else the one-hot smx + the scan sweep.  Identical values:
    integer scores are exact under any evaluation order."""
    if kernels:
        from reseek_tpu.ops.sw_cuda import mu_sw_scores_cuda
        return mu_sw_scores_cuda(a, b, mumx_padded, open_, ext)
    return sw_score_sweep(mu_smx_onehot(a, b, mumx_padded), open_, ext)


def mu_smx_onehot(a: jnp.ndarray, b: jnp.ndarray,
                  mumx_padded: jnp.ndarray) -> jnp.ndarray:
    """S[b,i,j] = mumx[a[b,i], b[b,j]] via one-hot matmuls; letter 36
    is padding (mumx_padded rows/cols 36 = NEG/2, so padded cells go to
    ~NEG).  Integer matrix values are exact in bf16.

    INVARIANT: the output is FINITE everywhere (padding uses the finite
    NEG = -9e9 sentinel, never inf/NaN).  The sweep kernels' `s * 0.0`
    carry-derivation trick relies on this — an inf/NaN in s would poison
    the carries."""
    oh_a = jax.nn.one_hot(a, 37, dtype=jnp.bfloat16)
    oh_b = jax.nn.one_hot(b, 37, dtype=jnp.bfloat16)
    emb = jax.lax.dot_general(
        oh_a, mumx_padded.astype(jnp.bfloat16),
        dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    return jax.lax.dot_general(
        emb.astype(jnp.bfloat16), oh_b,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)


@functools.partial(
    jax.jit,
    static_argnames=("la", "lb", "open_", "ext", "omega_fwd", "omega",
                     "kernels"))
def mu_filter_mask_sweep(mu_db: jnp.ndarray, mu_rev_db: jnp.ndarray,
                         idx_a: jnp.ndarray, idx_b: jnp.ndarray,
                         mumx_padded: jnp.ndarray,
                         la: int, lb: int, open_: float, ext: float,
                         omega_fwd: float, omega: float,
                         kernels: bool = False) -> jnp.ndarray:
    """Batched Mu filter gate (src/dssaligner.cpp:619-630).

    For each pair: fwd = SW(mu[a], mu[b]); pass iff fwd >= OmegaFwd and
    fwd - SW(mu_rev[a], mu[b]) >= Omega.  Orientation-free: SW is
    transpose- and double-reversal-invariant on scores, so
    SW(rev(q), t) == SW(rev(t), q) and callers may canonicalize the pair
    (shorter side as `a`).  Returns a bool mask [B]."""
    a = mu_db[idx_a][:, :la].astype(jnp.int32)
    ar = mu_rev_db[idx_a][:, :la].astype(jnp.int32)
    b = mu_db[idx_b][:, :lb].astype(jnp.int32)
    fwd = mu_sw_scores(a, b, mumx_padded, open_, ext, kernels)
    rev = mu_sw_scores(ar, b, mumx_padded, open_, ext, kernels)
    # parasail 8-bit saturation (align/pipeline.py MU_SAT_* notes):
    # saturated fwd -> 777, saturated rev -> 255
    fwd = jnp.where(fwd > np.float32(250.0), np.float32(777.0), fwd)
    rev = jnp.where(rev > np.float32(250.0), np.float32(255.0), rev)
    return (fwd >= np.float32(omega_fwd)) & \
        (fwd - rev >= np.float32(omega))


@functools.partial(jax.jit,
                   static_argnames=("la", "lb", "open_", "ext", "kernels"))
def mu_scores_sweep(mu_db: jnp.ndarray, mu_rev_db: jnp.ndarray,
                    idx_a: jnp.ndarray, idx_b: jnp.ndarray,
                    mumx_padded: jnp.ndarray, la: int, lb: int,
                    open_: float, ext: float, kernels: bool = False):
    """(fwd, rev) Mu SW scores for each pair, same conventions as
    mu_filter_mask_sweep.  fwd and rev run as ONE [2B] kernel batch."""
    a = mu_db[idx_a][:, :la].astype(jnp.int32)
    ar = mu_rev_db[idx_a][:, :la].astype(jnp.int32)
    b = mu_db[idx_b][:, :lb].astype(jnp.int32)
    both = mu_sw_scores(jnp.concatenate([a, ar]),
                        jnp.concatenate([b, b]), mumx_padded, open_, ext,
                        kernels)
    n = a.shape[0]
    return both[:n], both[n:]
