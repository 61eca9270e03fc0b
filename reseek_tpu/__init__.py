"""reseek_tpu — protein structure search engine in JAX, with CUDA kernels.

A from-scratch JAX/XLA implementation (with CUDA kernels) of the Reseek method
(Edgar 2024, Bioinformatics 40(11):btae687): C-alpha backbones are encoded
into discrete structure-state alphabets (the 36-letter Mu alphabet plus
per-feature log-odds profiles), candidate chain pairs are screened by Mu
k-mer filters, survivors are aligned with affine-gap Smith-Waterman over
multi-feature substitution profiles, and hits are reported with calibrated
P-values, CIGARs, LDDT and Kabsch superposition.

Compute-heavy stages (the Mu filter and survivor SW as CUDA kernels, LDDT
and the rest as XLA programs) run over padded, length-bucketed chain
batches on the GPU; databases shard across device meshes via
jax.sharding.
"""

__version__ = "0.1.0"

from reseek_tpu.chain import Chain
from reseek_tpu.constants import DSSParams

__all__ = ["Chain", "DSSParams", "__version__"]
