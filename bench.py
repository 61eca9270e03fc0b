"""Benchmark: aligned chain-pairs/sec on the q100 all-vs-all --sensitive
search (full pipeline: DSS encode + self-rev + Mu filter + SW + LDDT/TS)
through the production driver on the default (device) engine.

The input is tests/golden/q100.cal.  One warm-up pass compiles; the
median of three measured passes is reported, and the hit rows must be
identical in every pass.  Runs only on a GPU: with no accelerator it
exits non-zero.

Prints one JSON line: {"metric", "value", "unit", "device"}.
"""

import io
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
Q100 = os.path.join(HERE, "tests", "golden", "q100.cal")


def run_once(chains, params):
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.search.driver import SearchOptions, self_search
    opts = SearchOptions(
        columns=parse_columns("query+target+qlo+qhi+tlo+thi+evalue+cigar"),
        max_evalue=10.0, mode="sensitive")
    buf = io.StringIO()
    drv = self_search(chains, params, opts, buf)
    if drv.engine != "device":
        raise RuntimeError(f"ran on the {drv.engine} engine")
    return buf.getvalue()


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX runs on {dev.platform}", file=sys.stderr)
        return 2
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.cal import read_cal
    from reseek_tpu.search.engine import configure_jax
    configure_jax()

    params = DSSParams.create("sensitive")
    chains = read_cal(Q100)
    n = len(chains)
    n_pairs = n * (n + 1) // 2

    t0 = time.perf_counter()
    rows = run_once(chains, params)
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        if run_once(chains, params) != rows:
            raise AssertionError("hit rows changed between passes")
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[1]
    print(json.dumps({
        "metric": "aligned_pairs_per_sec_q100_sensitive",
        "value": n_pairs / dt,
        "unit": "pairs/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    print(f"# warm-up {warm_s:.3f} s, passes {times}, "
          f"rows {rows.count(chr(10))}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
