"""At-scale end-to-end benchmark: 1 query (1hhs) vs a large synthetic DB
through the full -fast pipeline (prefilter + top-1500 selection + stage-2
alignment of survivors), mirroring the reference's pdb90 speed check
(test_scripts/check_idxqt_speed.py: idxq <=10 s / <=700 MB RSS at 329k
chains on host "rip").

Usage: python tools/bench_scale.py DB_PREFIX [--no-dbmu] [--mode idxq|idxt]
  DB_PREFIX.bca / DB_PREFIX.mu.fa from tools/make_scale_db.py.
  Default uses -dbmu (the precomputed Mu artifact, reference
  src/search.cpp:96-99; the reference's own speed test also runs with
  -dbmu, test_scripts/idxqt_speed.bash).

Prints one JSON line: wall seconds, peak RSS MB, chains, hits.  The
query is 1hhs_A from tests/golden/sepq_set.cal.
"""

import io
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    prefix = sys.argv[1]
    use_dbmu = "--no-dbmu" not in sys.argv
    mode = None
    if "--mode" in sys.argv:
        mode = sys.argv[sys.argv.index("--mode") + 1]

    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.benchmarks.replicas import golden_chains
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.search.driver import SearchOptions, fast_search

    queries = [c for c in golden_chains(("sepq_set.cal",))
               if c.label == "1hhs_A"]
    opts = SearchOptions(columns=parse_columns("std"),
                         max_evalue=10.0, mode="fast")
    buf = io.StringIO()
    t0 = time.time()
    drv = fast_search(queries, prefix + ".bca", DSSParams.create("fast"),
                      opts, buf,
                      dbmu=(prefix + ".mu.fa") if use_dbmu else None,
                      engine=os.environ.get("RESEEK_SCALE_ENGINE", "auto"),
                      prefilter_mode=mode)
    wall = time.time() - t0
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    print(json.dumps({
        "bench": "1hhs_vs_synthetic_fast",
        "db": prefix, "dbmu": use_dbmu, "mode": mode or "auto",
        "wall_s": round(wall, 2), "peak_rss_mb": round(rss_mb, 1),
        "n_targets": drv.processed_pairs // max(1, drv.query_count),
        "hits": buf.getvalue().count("\n"),
        "ref_envelope": "pdb90 329k chains: idxq <=10 s / <=700 MB "
                        "(check_idxqt_speed.py)",
    }))


if __name__ == "__main__":
    main()
