"""Batched substitution-matrix construction in JAX.

Two formulations of S[b,i,j] = sum_f w_f * M_f[profA[b,f,i], profB[b,f,j]]:

- ``smx_batch``:  matmul path.  Profiles become flat codes into a concatenated
  alphabet (D = sum of alphabet sizes, 132 for the default 8 features); the
  weighted per-feature matrices form a block-diagonal W [D, D]; then
  S = embA @ W @ onehotB^T collapses to two matmuls.  HIGHEST precision
  keeps f32-accurate accumulation.

- ``smx_batch_gather``: bit-exact path.  Eight [L,A] table gathers summed
  elementwise in feature order — identical float32 adds to the reference's
  SetSMx_NoRev (src/dssaligner.cpp:529-611).

Padding: profile positions beyond a chain's length must carry the dedicated
PAD code; W rows/cols for PAD are NEG so padded cells get large negative
scores and never win in SW.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from reseek_tpu.constants import ALPHA_SIZES, DSSParams
from reseek_tpu.ops.substmx import weighted_matrices

NEG = np.float32(-9e9)


@functools.lru_cache(maxsize=4)
def flat_layout(features: Tuple[str, ...], weights: Tuple[float, ...]):
    """Returns (offsets per feature [F], D, W [D+1, D+1] block-diag f32).

    The last code (index D) is the PAD code: W[PAD, :] = W[:, PAD] = NEG/8
    so a padded cell sums to ~NEG over 8 features.
    """
    mats = weighted_matrices(features, weights)
    sizes = [ALPHA_SIZES[f] for f in features]
    offsets = np.concatenate(([0], np.cumsum(sizes)[:-1])).astype(np.int32)
    d = int(sum(sizes))
    w = np.zeros((d + 1, d + 1), np.float32)
    for f, off, sz in zip(features, offsets, sizes):
        w[off: off + sz, off: off + sz] = mats[f]
    pad_pen = NEG / np.float32(len(features))
    w[d, :] = pad_pen
    w[:, d] = pad_pen
    return offsets, d, w


def flat_codes(profile: np.ndarray, offsets: np.ndarray, d: int,
               length: int, pad_to: int) -> np.ndarray:
    """uint8 [F, L] profile -> int32 [F, pad_to] flat codes with PAD=d."""
    f = profile.shape[0]
    out = np.full((f, pad_to), d, np.int32)
    out[:, :length] = profile.astype(np.int32) + offsets[:, None]
    return out


def smx_batch(codes_a: jnp.ndarray, codes_b: jnp.ndarray,
              w: jnp.ndarray) -> jnp.ndarray:
    """codes_*: int32 [B, F, L]; returns S [B, LA, LB] float32.

    embA[b,i,:] = sum_f W[codes_a[b,f,i], :]  (row gather + add, exact)
    S = embA @ onehotB^T                      (matmul, HIGHEST precision)
    """
    emb_a = w[codes_a].sum(axis=1)  # [B, LA, D+1]
    nb = w.shape[0]
    onehot_b = jax.nn.one_hot(codes_b, nb, dtype=jnp.float32)  # [B,F,LB,D+1]
    multihot_b = onehot_b.sum(axis=1)  # [B, LB, D+1]
    return jax.lax.dot_general(
        emb_a, multihot_b,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST)


def smx_batch_gather(prof_a: jnp.ndarray, prof_b: jnp.ndarray,
                     w: jnp.ndarray, offsets: jnp.ndarray) -> jnp.ndarray:
    """Bit-exact variant: feature-ordered elementwise adds of table lookups.

    prof_*: int32 [B, F, L] flat codes (PAD included); w as in flat_layout.
    """
    nf = prof_a.shape[1]
    s = w[prof_a[:, 0, :, None], prof_b[:, 0, None, :]]
    for k in range(1, nf):
        s = s + w[prof_a[:, k, :, None], prof_b[:, k, None, :]]
    return s
