"""Seeded structure sets at scale from the chains committed in the repo.

The inputs are the 239 chains of tests/golden/q100.cal (100 chains,
49-1,231 residues) and tests/golden/sepq_set.cal (139 chains, 49-2,099
residues, among them 1hhs_A).  A set of N chains cycles through them and
adds Gaussian noise (0.25 A per axis, from the seed) to every coordinate:
the noise decorrelates the structure letters enough that replicas score
like homologs rather than byte-duplicates.  Replica k of chain c is
labelled "c/rk".  tools/make_scale_db.py writes such a set to disk.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np

from reseek_tpu.chain import Chain

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden")
NOISE_A = 0.25
# the reference's q10 set: ten of the q100 chains, in q10.bca's order
Q10_LABELS = ("1a0h_A", "155c__A", "12e8_H", "10gs_A", "1a0f_A", "1a04_A",
              "12ca__A", "1a06__A", "13pk_A", "1a0h_B")


def golden_chains(names: Sequence[str] = ("q100.cal", "sepq_set.cal")
                  ) -> List[Chain]:
    from reseek_tpu.io.cal import read_cal
    out: List[Chain] = []
    for name in names:
        out.extend(read_cal(os.path.join(GOLDEN, name)))
    return out


def golden_q10() -> List[Chain]:
    by_label = {c.label: c for c in golden_chains(("q100.cal",))}
    return [by_label[lab] for lab in Q10_LABELS]


def replicas(base: Sequence[Chain], n: int, seed: int,
             noise: float = NOISE_A) -> List[Chain]:
    """n chains cycling through `base`, each with fresh coordinate noise."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        c = base[k % len(base)]
        jitter = rng.normal(0.0, noise, c.coords.shape).astype(np.float32)
        out.append(Chain(f"{c.label}/r{k // len(base)}", c.seq,
                         c.coords + jitter))
    return out


def mu_strings(chains: Sequence[Chain]) -> List[str]:
    from reseek_tpu.encoder.dss import encode_chain, feature_string
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as tp:
        return list(tp.map(lambda c: feature_string(encode_chain(c), "Mu"),
                           chains))


def write_db(chains: Sequence[Chain], prefix: str) -> None:
    """<prefix>.bca (the chain DB, random-access stage-2 source) and
    <prefix>.mu.fa (Mu letters, the -dbmu stage-1 input that skips DB
    re-encoding, src/search.cpp:96-99)."""
    from reseek_tpu.io.bca import BCAWriter
    with BCAWriter(prefix + ".bca") as w, open(prefix + ".mu.fa", "w") as fa:
        for start in range(0, len(chains), 4096):
            part = chains[start:start + 4096]
            for c, mu in zip(part, mu_strings(part)):
                w.write_chain(c)
                fa.write(f">{c.label}\n{mu}\n")
