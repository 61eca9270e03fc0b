"""Smoke test of the search engine on NVIDIA GPUs, through the entry points
a user calls (reseek_tpu.cli.main and reseek_tpu/search/driver.py), at
real sizes, with every CUDA kernel compared against its plain reference.

    python chip_smoke.py                  one card, the phases below
    python chip_smoke.py --four-cards     four cards: only the multi-device
                                          paths and what they are compared
                                          with
    python chip_smoke.py --compare-plain  one card: also all-vs-alls of 100
                                          and 1,024 chains on XLA's plain
                                          versions of the kernels, each one
                                          off in turn

One-card phases (inputs made from --seed out of tests/golden/q100.cal and
tests/golden/sepq_set.cal, Gaussian replicas, reseek_tpu/benchmarks/
replicas.py):
  kernels   each CUDA kernel compiled at the engine's bucket edges and
            batch sizes, compared once with its plain JAX reference
            (exactly), memory_analysis() printed, both timed
  parity    q100 all-vs-all --sensitive through the CLI on the default
            engine (it must be the device engine), byte-identical to the
            host engine; the q10 chains give the rows of q10_sens.tsv
  allvsall  1,024 chains --sensitive (Mu-filter kernel, traceback kernel,
            host MKF path for the long chains beside them), rows checked
            against the host aligner on a seeded sample of 2,000 pairs
  fast      100 queries vs a 10,000-chain DB (-fast, device stage 2),
            byte-identical to the host engine

Exits non-zero, printing no result, if there is no GPU or any phase
fails.  The last line of standard output is the JSON result.  Data is
written under .smoke/ (git-ignored).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(HERE, ".smoke")
GOLDEN = os.path.join(HERE, "tests", "golden")
COLUMNS = "query+target+qlo+qhi+tlo+thi+dpscore+lddt+newts+evalue+cigar"
EDGES = (128, 256, 512, 1024)  # device buckets of --sensitive (mkfl 600)

_compile_s = [0.0]


def _on_duration(event: str, duration: float, **_kw) -> None:
    if event.startswith("/jax/core/compile/"):
        _compile_s[0] += duration


@contextlib.contextmanager
def phase(name: str):
    """Times a phase: wall seconds, and apart from them the seconds JAX
    spent tracing, lowering and compiling in it."""
    import jax
    info: dict = {}
    t0, c0 = time.perf_counter(), _compile_s[0]
    yield info
    jax.effects_barrier()
    wall = time.perf_counter() - t0
    comp = _compile_s[0] - c0
    stats = jax.devices()[0].memory_stats() or {}
    extra = "".join(f", {k} {v}" for k, v in info.items())
    print(f"phase {name}: wall {wall:.3f} s, compile {comp:.3f} s, "
          f"run {wall - comp:.3f} s{extra}, "
          f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
          flush=True)


def gpu_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def native_libraries(cuda: bool = True) -> None:
    """Build (or find) the five host libraries and the CUDA kernels for
    this machine; fail unless every one loads."""
    from reseek_tpu import native_build
    from reseek_tpu.align import mkf_native
    from reseek_tpu.encoder import native as enc_native
    from reseek_tpu.ops import lddt, sw_cuda, sw_native
    from reseek_tpu.search import prefilter
    libs = {"prefilter": prefilter._lib(), "dssenc": enc_native._lib(),
            "sw": sw_native._lib(), "lddt": lddt._lib(),
            "mkf": mkf_native._lib()}
    missing = sorted(k for k, v in libs.items() if v is None)
    if missing:
        raise RuntimeError(f"native libraries not loaded: {missing}")
    if cuda:
        sw_cuda.register()
    for name, info in sorted(native_build.LOADED.items()):
        print(f"native {name}: {'built' if info['built'] else 'cached'} "
              f"{os.path.relpath(info['path'], HERE)}")
    print(f"native host libraries loaded: {len(libs)}/5")


def _timeit(fn, *args, reps: int = 3) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / reps


def _encoded_base(params):
    from reseek_tpu.benchmarks.replicas import golden_chains
    from reseek_tpu.search.driver import _encode_all
    return _encode_all(golden_chains(), params, with_self_rev=False)


def kernel_phase(seed: int) -> None:
    """Each kernel at the engine's real widths vs its plain reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from reseek_tpu.constants import ALPHA_SIZES, DSSParams
    from reseek_tpu.ops import sw_cuda
    from reseek_tpu.ops.postalign_jax import walk_traceback_batch
    from reseek_tpu.ops.smx_jax import flat_layout, smx_batch_gather
    from reseek_tpu.ops.sw_jax import sw_traceback_batch
    from reseek_tpu.ops.sw_sweep import mu_smx_onehot, sw_score_sweep
    from reseek_tpu.search.engine import (PAD_BYTE, STAGE3_CELLS,
                                          _batch_shape, _codes_slice,
                                          _mu_matrix_padded, _smx_onehot,
                                          stage1_block_dims)

    params = DSSParams.create("sensitive")
    ecs = _encoded_base(params)
    rng = np.random.default_rng(seed)
    mumx = jnp.asarray(_mu_matrix_padded())
    o, e = -float(params.para_mu_gap_open), -float(params.para_mu_gap_ext)

    # (a) Mu filter: fwd + rev batch of one stage-1 block per edge
    mu_kernel = jax.jit(lambda a, b: sw_cuda.mu_sw_scores_cuda(
        a, b, mumx, o, e))
    mu_plain = jax.jit(lambda a, b: sw_score_sweep(mu_smx_onehot(
        a.astype(jnp.int32), b.astype(jnp.int32), mumx), o, e))
    for le in EDGES:
        ca, cb = stage1_block_dims(le, le, 1 << 20, 1 << 20)
        n = 2 * ca * cb
        fit = [x for x in ecs if len(x) <= le]
        a = np.full((n, le), 36, np.uint8)
        b = np.full((n, le), 36, np.uint8)
        for k, (i, j) in enumerate(rng.integers(0, len(fit), (n, 2))):
            mi, mj = fit[i].mu_letters, fit[j].mu_letters
            a[k, :len(mi)] = mi[::-1] if k % 2 else mi
            b[k, :len(mj)] = mj
        a, b = jnp.asarray(a), jnp.asarray(b)
        compiled = mu_kernel.lower(a, b).compile()
        print(f"kernel mu {le}x{le} B={n} memory_analysis: "
              f"{compiled.memory_analysis()}")
        got, want = np.asarray(compiled(a, b)), np.asarray(mu_plain(a, b))
        if not np.array_equal(got, want):
            raise AssertionError(f"mu kernel != sweep at {le}: "
                                 f"{int((got != want).sum())} of {n}")
        t_k, t_p = _timeit(compiled, a, b), _timeit(mu_plain, a, b)
        print(f"kernel mu {le}x{le} B={n}: equal to plain sweep; "
              f"cuda {t_k * 1e3:.3f} ms, plain XLA {t_p * 1e3:.3f} ms")

    # (c) traceback: one stage-3 chunk per edge
    sizes = tuple(ALPHA_SIZES[f] for f in params.features)
    offsets, d, w = flat_layout(params.features, params.weights)
    w = jnp.asarray(w)
    offs = jnp.asarray(offsets.astype(np.int32))
    meta = sw_cuda.align_meta(sizes)
    go, ge = float(params.gap_open), float(params.gap_ext)

    def aln_kernel(pa, pb):
        return sw_cuda.sw_align_cuda(
            sw_cuda.profile_codes(pa, sizes, PAD_BYTE),
            sw_cuda.profile_codes(pb, sizes, PAD_BYTE),
            sw_cuda.align_table(w, sizes), meta, len(sizes), go, ge)

    def aln_exact(pa, pb):
        # feature-ordered gather smx: the bit-exact plain reference
        def codes(p):
            p = p.astype(jnp.int32)
            return jnp.where(p == PAD_BYTE, d, p + offs[None, :, None])
        best, bi, bj, tbs = sw_traceback_batch(
            smx_batch_gather(codes(pa), codes(pb), w, None), go, ge)
        return (best, bi, bj) + walk_traceback_batch(tbs, best, bi, bj) \
            + (tbs,)

    def aln_plain(pa, pb):
        # what the device path runs without the kernel (engine plain path)
        idx = jnp.arange(pa.shape[0])
        ca_ = _codes_slice(pa, idx, offs, pa.shape[2], d)
        cb_ = _codes_slice(pb, idx, offs, pb.shape[2], d)
        best, bi, bj, tbs = sw_traceback_batch(_smx_onehot(ca_, cb_, w),
                                               go, ge)
        return walk_traceback_batch(tbs, best, bi, bj)

    aln_kernel = jax.jit(aln_kernel)
    aln_exact = jax.jit(aln_exact)
    aln_plain = jax.jit(aln_plain)
    for le in EDGES:
        n = _batch_shape(1 << 20, le, STAGE3_CELLS)
        fit = [x for x in ecs if len(x) <= le]
        pa = np.full((n, len(sizes), le), PAD_BYTE, np.uint8)
        pb = np.full((n, len(sizes), le), PAD_BYTE, np.uint8)
        for k, (i, j) in enumerate(rng.integers(0, len(fit), (n, 2))):
            pa[k, :, :len(fit[i])] = fit[i].profile
            pb[k, :, :len(fit[j])] = fit[j].profile
        pa, pb = jnp.asarray(pa), jnp.asarray(pb)
        compiled = aln_kernel.lower(pa, pb).compile()
        print(f"kernel align {le}x{le} B={n} memory_analysis: "
              f"{compiled.memory_analysis()}")
        got = [np.asarray(x) for x in compiled(pa, pb)]
        want = [np.asarray(x) for x in aln_exact(pa, pb)]
        names = ("best", "bi", "bj", "lo_a", "lo_b", "plen", "path")
        for nm, g, wnt in zip(names, got, want):
            if not np.array_equal(g, wnt):
                raise AssertionError(f"align kernel {nm} differs at {le}")
        i = np.arange(le)[:, None]
        j = np.arange(le)[None, :]
        cells = want[7][i + j, :, i]          # [le, le, n]
        if not np.array_equal(sw_cuda.unpack_tb(got[7], le, le),
                              np.moveaxis(cells, 2, 0)):
            raise AssertionError(f"align kernel traceback bits differ "
                                 f"at {le}")
        t_k, t_p = _timeit(compiled, pa, pb), _timeit(aln_plain, pa, pb)
        print(f"kernel align {le}x{le} B={n}: scores, best cells, "
              f"traceback bits and paths equal to the plain wavefront; "
              f"cuda {t_k * 1e3:.3f} ms, plain XLA {t_p * 1e3:.3f} ms")

    # the repository's `gpu` tests
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "test_sw_cuda", os.path.join(HERE, "tests", "test_sw_cuda.py"))
    test_sw_cuda = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(test_sw_cuda)
    test_sw_cuda.test_cuda_mu_kernel_matches_sweep(None)
    test_sw_cuda.test_cuda_align_kernel_matches_wavefront(None)
    print("gpu tests: 2 passed")


def _cli_search(args, out: str, log: str):
    from reseek_tpu.cli import main
    if main(list(args) + ["--output", out, "--log", log]) != 0:
        raise RuntimeError(f"search {args} failed")
    m = re.search(r"^Engine (\w+)$", open(log).read(), re.M)
    return open(out).read(), m.group(1)


def _write_q10(path: str) -> None:
    from reseek_tpu.benchmarks.replicas import golden_q10
    from reseek_tpu.io.bca import write_bca
    write_bca(golden_q10(), path)


def parity_phase(expect: str = "device") -> None:
    q100 = os.path.join(GOLDEN, "q100.cal")
    base = ["search", q100, "--sensitive", "--columns", COLUMNS]
    with phase("parity") as info:
        dev, engine = _cli_search(base, os.path.join(SCRATCH, "q100.tsv"),
                                  os.path.join(SCRATCH, "q100.log"))
        print(f"parity: q100 default engine ran: {engine}")
        if engine != expect:
            raise AssertionError(f"default engine {engine}, not {expect}")
        q10 = os.path.join(SCRATCH, "q10.bca")
        _write_q10(q10)
        d10, engine10 = _cli_search(
            ["search", q10, "--sensitive", "--columns", COLUMNS],
            os.path.join(SCRATCH, "q10.tsv"), os.path.join(SCRATCH, "q10.log"))
        info.update(pairs=100 * 101 // 2, rows=dev.count("\n"))
    host, host_engine = _cli_search(base + ["--engine", "host"],
                                    os.path.join(SCRATCH, "q100_host.tsv"),
                                    os.path.join(SCRATCH, "q100_host.log"))
    if host_engine != "host" or dev != host:
        raise AssertionError("q100 rows differ between engines")
    golden = open(os.path.join(GOLDEN, "q10_sens.tsv")).read()
    if engine10 != expect or set(d10.splitlines()) != set(golden.splitlines()):
        raise AssertionError("q10 rows differ from q10_sens.tsv")
    print(f"parity: q100 {dev.count(chr(10))} rows byte-identical to the "
          f"host engine; q10 {d10.count(chr(10))} rows = q10_sens.tsv")


def allvsall_phase(seed: int, n_chains: int = 1024, n_sample: int = 2000,
                   engine: str = "auto", expect: str = "device",
                   label: str = "allvsall") -> None:
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.benchmarks.replicas import golden_chains, replicas
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.search.driver import (SearchDriver, SearchOptions,
                                          _encode_all, self_search)
    params = DSSParams.create("sensitive")
    options = SearchOptions(columns=parse_columns(COLUMNS), max_evalue=10.0,
                            mode="sensitive")
    chains = replicas(golden_chains(), n_chains, seed)
    n = len(chains)
    buf = io.StringIO()
    with phase(label) as info:
        drv = self_search(chains, params, options, buf, engine=engine)
        info.update(pairs=n * (n + 1) // 2, rows=buf.getvalue().count("\n"),
                    engine=drv.engine)
    if drv.engine != expect:
        raise AssertionError(f"engine {drv.engine}, not {expect}")
    if label != "allvsall":
        return
    index = {c.label: i for i, c in enumerate(chains)}
    dev_rows = defaultdict(list)
    for row in buf.getvalue().splitlines():
        q, t = row.split("\t", 2)[:2]
        i, j = index[q], index[t]
        dev_rows[(min(i, j), max(i, j))].append(row)
    rng = np.random.default_rng(seed + 1)
    hit_pairs = sorted(dev_rows)
    pick = rng.choice(len(hit_pairs), min(n_sample // 2, len(hit_pairs)),
                      replace=False)
    sample = {hit_pairs[k] for k in pick}
    while len(sample) < min(n_sample, n * (n + 1) // 2):
        i, j = sorted(int(x) for x in rng.integers(0, n, 2))
        sample.add((i, j))
    ecs = _encode_all(chains, params, with_self_rev=True)

    def host_rows(pair):
        i, j = pair
        out = io.StringIO()
        SearchDriver(params, options, out).align_and_emit(
            ecs[i], ecs[j], both_orientations=(i != j))
        return pair, out.getvalue().splitlines()

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as tp:
        host = dict(tp.map(host_rows, sorted(sample)))
    bad = [p for p in sorted(sample) if host[p] != dev_rows.get(p, [])]
    n_rows = sum(len(v) for v in host.values())
    if bad:
        raise AssertionError(f"{len(bad)} of {len(sample)} sampled pairs "
                             f"differ from the host aligner, e.g. {bad[:3]}")
    print(f"allvsall: {len(sample)} sampled pairs ({len(pick)} with rows, "
          f"{n_rows} rows) byte-identical to the host aligner")


def fast_phase(seed: int, n_db: int = 10_000, n_q: int = 100,
               expect: str = "device") -> None:
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.benchmarks.replicas import (golden_chains, replicas,
                                                write_db)
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.search.driver import SearchOptions, fast_search
    prefix = os.path.join(SCRATCH, f"db{n_db}_s{seed}")
    t0 = time.perf_counter()
    write_db(replicas(golden_chains(), n_db, seed + 2), prefix)
    print(f"fast: wrote {n_db}-chain DB in "
          f"{time.perf_counter() - t0:.3f} s (set-up)")
    queries = golden_chains(("q100.cal",))[:n_q]
    options = SearchOptions(columns=parse_columns("std"), max_evalue=10.0,
                            mode="fast")
    params = DSSParams.create("fast")
    dev = io.StringIO()
    with phase("fast") as info:
        drv = fast_search(queries, prefix + ".bca", params, options, dev,
                          dbmu=prefix + ".mu.fa")
        info.update(pairs=n_q * n_db, rows=dev.getvalue().count("\n"),
                    engine=drv.engine)
    if drv.engine != expect:
        raise AssertionError(f"-fast stage 2 ran on {drv.engine}")
    host = io.StringIO()
    t0 = time.perf_counter()
    fast_search(queries, prefix + ".bca", params, options, host,
                dbmu=prefix + ".mu.fa", engine="host")
    print(f"fast: host engine {time.perf_counter() - t0:.3f} s")
    if dev.getvalue() != host.getvalue():
        raise AssertionError("-fast rows differ between engines")
    print(f"fast: {dev.getvalue().count(chr(10))} rows byte-identical to "
          f"the host engine")


def compare_plain(seed: int, n_chains: int = 1024) -> None:
    """The all-vs-all phase with each kernel replaced by its plain JAX
    version, in the order kernels, plain Mu, plain traceback, both plain,
    then back (a-b-c-d-d-c-b-a), so each variant runs once more after
    its compilation; the phase line of each run gives its times."""
    from reseek_tpu import device
    variants = [(), ("mu",), ("align",), ("mu", "align")]
    for names in variants + variants[::-1]:
        with device.plain_kernels(*names) if names \
                else contextlib.nullcontext():
            allvsall_phase(seed, n_chains, label=f"allvsall{n_chains}_plain_"
                           + ("+".join(names) or "none"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nprocs_phase(seed: int, n_db: int = 2000, nprocs: int = 4,
                 pin: bool = True) -> None:
    """`search --fast --nprocs 4`: four CLI processes, each pinned to one
    card, against the same search in one process.  Runs before this
    process touches JAX, so each child has its card to itself."""
    from reseek_tpu import native_build
    from reseek_tpu.benchmarks.replicas import (golden_chains, replicas,
                                                write_db)
    from reseek_tpu.ops import sw_cuda
    # build once here rather than in every rank
    native_build.build_all_host()
    if pin:
        sw_cuda.library_path()
    prefix = os.path.join(SCRATCH, f"db{n_db}_s{seed}")
    write_db(replicas(golden_chains(), n_db, seed + 2), prefix)
    q100 = os.path.join(GOLDEN, "q100.cal")
    base = [sys.executable, "-m", "reseek_tpu.cli", "search", q100, "--db",
            prefix + ".bca", "--dbmu", prefix + ".mu.fa", "--fast"]
    port = _free_port()
    outs = [os.path.join(SCRATCH, f"np{p}.tsv") for p in range(nprocs)]
    logs = [os.path.join(SCRATCH, f"np{p}.log") for p in range(nprocs)]
    t0 = time.perf_counter()
    procs = []
    try:
        for p in range(nprocs):
            cmd = base + ["--nprocs", str(nprocs), "--procid", str(p),
                          "--coord", f"localhost:{port}", "--scratch",
                          SCRATCH, "--output", outs[p], "--log", logs[p]]
            if pin:
                cmd += ["--local-device-ids", str(p)]
            procs.append(subprocess.Popen(cmd, cwd=HERE))
        rcs = [pr.wait(timeout=900) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    if any(rcs):
        raise RuntimeError(f"--nprocs {nprocs} ranks exited {rcs}")
    engines = [re.search(r"^Engine (\w+)$", open(lg).read(), re.M).group(1)
               for lg in logs]
    print(f"nprocs: {nprocs} processes in {time.perf_counter() - t0:.3f} s, "
          f"stage-2 engines {engines}")
    single = os.path.join(SCRATCH, "np_single.tsv")
    proc = subprocess.run(base + ["--output", single, "--log",
                                  single + ".log"], cwd=HERE)
    if proc.returncode:
        raise RuntimeError("single-process -fast search failed")
    rows = open(outs[0]).read()
    if rows != open(single).read() or not rows:
        raise AssertionError("--nprocs rows differ from one process")
    print(f"nprocs: {rows.count(chr(10))} rows byte-equal to one process")


def mesh_phase(n_dev: int = 4) -> None:
    """The db-axis mesh in one process (engine sharded stage 1/3,
    parallel/topk.py merge) against one device."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.benchmarks.replicas import golden_chains, golden_q10
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.encoder.dss import encode_chain
    from reseek_tpu.parallel.topk import sharded_prefilter_search
    from reseek_tpu.search.driver import (SearchOptions, query_search,
                                          self_search)
    from reseek_tpu.search.prefilter import prefilter_search
    params = DSSParams.create("sensitive")
    options = SearchOptions(columns=parse_columns(COLUMNS), max_evalue=10.0,
                            mode="sensitive")
    # q10: all lengths -> several buckets, multi-block stage-1 plans and
    # (chains >= mkfl) the host MKF merge; queries against q100
    chains = golden_q10()
    db = golden_chains(("q100.cal",))
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("db",))
    with phase("mesh") as info:
        buf_mesh, buf_one = io.StringIO(), io.StringIO()
        self_search(chains, params, options, buf_mesh, engine="device",
                    mesh=mesh)
        self_search(chains, params, options, buf_one, engine="device")
        q_mesh, q_one = io.StringIO(), io.StringIO()
        query_search(chains[:3], db, params, options, q_mesh,
                     engine="device", mesh=mesh)
        query_search(chains[:3], db, params, options, q_one,
                     engine="device")
        q_mu = [encode_chain(c).mu_letters for c in chains]
        t_mu = [encode_chain(c).mu_letters for c in db]
        single = prefilter_search(q_mu, list(enumerate(t_mu)), top_b=4)
        merged = sharded_prefilter_search(q_mu, t_mu, mesh, top_b=4)
        info.update(rows=buf_mesh.getvalue().count("\n"))
    if buf_mesh.getvalue() != buf_one.getvalue():
        raise AssertionError("mesh self-search differs from one device")
    if q_mesh.getvalue() != q_one.getvalue():
        raise AssertionError("mesh query search differs from one device")
    if merged.query_targets != single.query_targets:
        raise AssertionError("sharded top-B merge differs")
    print(f"mesh: {n_dev}-device self search "
          f"({buf_mesh.getvalue().count(chr(10))} rows), query search "
          f"({q_mesh.getvalue().count(chr(10))} rows) and top-B merge "
          f"byte-equal to one device")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--compare-plain", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(SCRATCH, exist_ok=True)

    if args.four_cards:
        # the children need the cards to themselves: no JAX here yet
        n_gpu = gpu_name_power().count("\n") + 1
        if n_gpu < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found {n_gpu}")
        nprocs_phase(args.seed)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX runs on {devices[0].platform}", file=sys.stderr)
        return 2
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    from reseek_tpu.search.engine import configure_jax
    configure_jax()
    print(f"jax {jax.__version__}, {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)
    native_libraries()

    if args.four_cards:
        mesh_phase(4)
    else:
        with phase("kernels"):
            kernel_phase(args.seed)
        parity_phase()
        allvsall_phase(args.seed)
        if args.compare_plain:
            compare_plain(args.seed, 100)
            compare_plain(args.seed)
        fast_phase(args.seed)

    print(gpu_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
