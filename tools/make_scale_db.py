"""Write a seeded structure DB at scale: Gaussian replicas (0.25 A) of the
chains committed in tests/golden (reseek_tpu/benchmarks/replicas.py).

Writes <out>.bca (the chain DB) and <out>.mu.fa (Mu-letter FASTA, the
-dbmu stage-1 input, src/search.cpp:96-99).

Usage: python tools/make_scale_db.py OUT_PREFIX [N_CHAINS=10000] [SEED=17]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from reseek_tpu.benchmarks.replicas import golden_chains, replicas, write_db
    out = sys.argv[1]
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 17
    t0 = time.time()
    write_db(replicas(golden_chains(), n, seed), out)
    print(f"built {n} chains in {time.time() - t0:.1f}s -> {out}.bca, "
          f"{out}.mu.fa")


if __name__ == "__main__":
    main()
