"""Worker process for tests/test_multihost.py: one rank of a real
2-process jax.distributed CPU run of distributed_fast_search.

Usage: python multihost_worker.py PID NPROC PORT SCRATCH_DIR TOP_B
Writes SCRATCH_DIR/rows.<pid>; rank 0 also writes SCRATCH_DIR/merged.tsv.
"""

import os
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    scratch, top_b = sys.argv[4], int(sys.argv[5])
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{port}",
            num_processes=nproc, process_id=pid)

    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.parallel.multihost import distributed_fast_search
    from reseek_tpu.search.driver import SearchOptions

    ref = os.environ["RESEEK_TEST_DATA"]
    queries = read_bca(os.path.join(ref, "q10.bca"))
    options = SearchOptions(columns=parse_columns("std"),
                            max_evalue=10.0, mode="fast")
    out = None
    if jax.process_index() == 0:
        out = open(os.path.join(scratch, "merged.tsv"), "w")
    distributed_fast_search(queries, os.path.join(ref, "q100.bca"),
                            options, out, scratch_dir=scratch,
                            top_b=top_b)
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
