"""Per-pair substitution matrix: S[i,j] = sum_f w_f * M_f[profA_f[i], profB_f[j]].

Exact numpy builder accumulates feature-by-feature in float32 exactly like
the reference's SetSMx_NoRev (src/dssaligner.cpp:529-611: first feature
assigns, the rest +=, all float32).

The device path looks the same sum up in-kernel in the same order
(ops/sw_cuda.py) or, on the plain JAX path, expresses it as two matmuls
over concatenated one-hot encodings with a block-diagonal weighted score
matrix — see reseek_tpu/ops/smx_jax.py.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

from reseek_tpu.constants import ALPHA_SIZES, DSSParams
from reseek_tpu.data.tables import get_tables


@functools.lru_cache(maxsize=8)
def weighted_matrices(features: Tuple[str, ...],
                      weights: Tuple[float, ...]) -> Dict[str, np.ndarray]:
    """w_f * log-odds matrix per feature, float32 (ApplyWeights,
    src/dssparams.cpp:344-364)."""
    t = get_tables()
    return {f: t.weighted_score_mx(f, w) for f, w in zip(features, weights)}


def build_smx(params: DSSParams, prof_a: np.ndarray,
              prof_b: np.ndarray) -> np.ndarray:
    """float32 [LA, LB] substitution matrix from uint8 profiles [F, L]."""
    mats = weighted_matrices(params.features, params.weights)
    fs = params.features
    m0 = mats[fs[0]]
    s = m0[prof_a[0][:, None], prof_b[0][None, :]].copy()
    for k in range(1, len(fs)):
        m = mats[fs[k]]
        s += m[prof_a[k][:, None], prof_b[k][None, :]]
    return s


def build_mu_smx(mu_a: np.ndarray, mu_b: np.ndarray) -> np.ndarray:
    """float32 [LA, LB] from int8 Mu matrix — the Mu-filter SW scores
    (exact int values, representable in f32)."""
    m = get_tables().mu_score_mx_int8.astype(np.float32)
    return m[mu_a[:, None], mu_b[None, :]]
