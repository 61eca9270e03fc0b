"""REAL multi-process distributed search test (SURVEY §2.8 items 2-4).

Spawns jax.distributed subprocess workers (localhost coordinator, Gloo
CPU collectives, 2 virtual devices per process so per-process shard
stacking is exercised) running the production distributed_fast_search,
and asserts byte-equality of the rank-0 merged output with

  * the committed reference-binary golden (top_b=1500: selection
    untruncated, full -fast parity), and
  * a single-process run at top_b=4 (truncation + tie-break semantics
    across a real process boundary).

No reference counterpart exists (the reference is single-node,
src/runthreads.cpp:4-17); the single-process fast_search output is the
parity oracle.
"""

import os
import socket
import subprocess
import sys
import tempfile

import pytest

from conftest import GOLDEN, TEST_DATA

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(nproc, top_b, scratch):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["RESEEK_TEST_DATA"] = TEST_DATA
    env.pop("JAX_NUM_PROCESSES", None)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(p), str(nproc), str(port),
         scratch, str(top_b)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for p in range(nproc)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, (
            f"worker failed rc={p.returncode}\n"
            f"stdout:\n{out.decode()}\nstderr:\n{err.decode()}")
    with open(os.path.join(scratch, "merged.tsv")) as f:
        return f.read()


def test_two_process_matches_reference_golden():
    with tempfile.TemporaryDirectory() as d:
        merged = _run_workers(nproc=2, top_b=1500, scratch=d)
    with open(os.path.join(GOLDEN, "fast_q10_q100.tsv")) as f:
        assert merged == f.read()


def test_two_process_cli():
    """The CLI surface (search --fast --nprocs/--procid/--coord) drives
    the same distributed path; rank 0's --output equals the golden."""
    ref = TEST_DATA
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    port = _free_port()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "hits.tsv")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "reseek_tpu.cli", "search",
             os.path.join(ref, "q10.bca"), "--db",
             os.path.join(ref, "q100.bca"), "--fast",
             "--output", out if p == 0 else os.path.join(d, f"o{p}"),
             "--nprocs", "2", "--procid", str(p),
             "--coord", f"localhost:{port}", "--scratch", d],
            env=env, cwd=os.path.dirname(HERE),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for p in range(2)]
        for p in procs:
            o, e = p.communicate(timeout=600)
            assert p.returncode == 0, e.decode()
        with open(out) as f, \
                open(os.path.join(GOLDEN, "fast_q10_q100.tsv")) as g:
            assert f.read() == g.read()


def test_two_process_truncated_topb_matches_single():
    with tempfile.TemporaryDirectory() as d2:
        two = _run_workers(nproc=2, top_b=4, scratch=d2)
    with tempfile.TemporaryDirectory() as d1:
        one = _run_workers(nproc=1, top_b=4, scratch=d1)
    assert two == one
    assert two.count("\n") > 0  # top_b=4 still yields rows


def test_distributed_resume_skips_completed_shard(tmp_path):
    """resume=True: a shard whose rows.<pid> checkpoint already exists
    skips stage 2 and its file is used verbatim in the merge (atomic
    tmp+rename completion semantics, SURVEY §5 resumable scan)."""
    import io

    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.parallel.multihost import distributed_fast_search
    from reseek_tpu.search.driver import SearchOptions

    ref = TEST_DATA
    queries = read_bca(os.path.join(ref, "q10.bca"))[:3]
    options = SearchOptions(columns=parse_columns("std"),
                            max_evalue=10.0, mode="fast")
    sentinel = "SENTINEL\tROW\t0\n"
    (tmp_path / "rows.0").write_text(sentinel)
    buf = io.StringIO()
    distributed_fast_search(queries, os.path.join(ref, "q100.bca"),
                            options, buf, scratch_dir=str(tmp_path),
                            resume=True)
    assert buf.getvalue() == sentinel  # stage 2 skipped, file reused

    # without resume the checkpoint is overwritten by real rows
    buf2 = io.StringIO()
    distributed_fast_search(queries, os.path.join(ref, "q100.bca"),
                            options, buf2, scratch_dir=str(tmp_path))
    assert "SENTINEL" not in buf2.getvalue()
    assert buf2.getvalue().count("\n") > 0
