"""Search drivers: all-vs-all self search and query-vs-DB search.

Host reference implementation mirroring DBSearcher semantics
(src/dbsearcher.cpp, src/runself.cpp, src/runquery.cpp): pair enumeration,
E-value acceptance, dual-orientation output rows.  The batched device
engine (reseek_tpu/search/engine.py) produces the same hits from padded
length-bucketed batches.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Iterable, List, Optional, TextIO

from reseek_tpu.align.output import format_row
from reseek_tpu.align.pipeline import (FLT_MAX as _FLT_MAX, AlignResult,
                                       EncodedChain, PairAligner,
                                       encode_for_search)
from reseek_tpu.chain import Chain
from reseek_tpu.constants import DSSParams


@dataclasses.dataclass
class SearchOptions:
    columns: List[str]
    max_evalue: float = 10.0     # DBSearcher::m_MaxEvalue default
    no_self: bool = False
    mode: str = "sensitive"
    global_aln: bool = False     # -global (src/runself.cpp:48-56)
    scores_are_not_evalues: bool = False  # disable the E-value gate
                                          # (src/dbsearcher.cpp:260)
    aln_out: Optional[TextIO] = None      # -aln pretty blocks
                                          # (src/prettyaln.cpp:27-99)
    trace_labels: Optional[tuple] = None  # -label1/-label2 per-pair
                                          # explain (dssaligner.cpp:734-791)


class SearchDriver:
    def __init__(self, params: DSSParams, options: SearchOptions,
                 out: TextIO = sys.stdout):
        import time
        self.params = params
        self.options = options
        self.out = out
        self.aligner = PairAligner(params)
        self.hit_count = 0
        self.processed_pairs = 0
        self.query_count = 0
        self.engine = "host"  # "device" once the device engine ran
        self.t0 = time.time()

    def _reject(self, res: AlignResult) -> bool:
        if self.options.scores_are_not_evalues:
            return False
        return res.evalue > self.options.max_evalue

    def emit(self, res: AlignResult, q: EncodedChain, t: EncodedChain,
             up: bool) -> None:
        if self._reject(res):
            return
        if self.options.no_self and q.label == t.label:
            return
        self.hit_count += 1
        self.out.write(format_row(self.options.columns, res, q, t, up))
        self.out.write("\n")
        if self.options.aln_out is not None:
            from reseek_tpu.align.prettyaln import pretty_aln
            pretty_aln(self.options.aln_out, res, q, t, up)

    def run_stats(self, n_threads: int = 1) -> None:
        """End-of-run stats (DBSearcher::RunStats, src/dbsearcher.cpp:29-56
        + DSSAligner::Stats, src/dssaligner.cpp:1088-1098)."""
        import time

        from reseek_tpu.utils.logger import (get_logger, int_to_str,
                                             secs_to_hhmmss)
        lg = get_logger()
        secs = max(time.time() - self.t0, 1.0)
        pairs_per_sec = self.processed_pairs / secs
        lg.progress_log("\n")
        lg.progress_log("%10.10s  Search time\n" % secs_to_hhmmss(secs))
        if self.options.max_evalue == float("inf"):
            lg.progress_log("%10.10s  Hits\n" % int_to_str(self.hit_count))
        else:
            lg.progress_log("%10.10s  Hits (max E-value %.3g)\n"
                            % (int_to_str(self.hit_count),
                               self.options.max_evalue))
        if self.query_count:
            lg.progress_log("%10.10s  Query chains\n"
                            % int_to_str(self.query_count))
            lg.progress_log("%10.1f  Chains/sec\n"
                            % (self.query_count / secs))
        lg.progress_log("%10.10s  Comparisons/sec\n"
                        % int_to_str(int(pairs_per_sec)))
        if n_threads > 1:
            lg.progress_log(
                "%10.10s  Comparisons/sec/thread (%u threads)\n"
                % (int_to_str(int(pairs_per_sec / n_threads)), n_threads))
        a = self.aligner
        lg.log("Engine %s\n" % self.engine)
        lg.log("DSSAligner::Stats() alns %d, mufil %d/%d %.1f%%\n"
               % (a.n_aligned, a.n_mu_input, a.n_mu_discarded,
                  100.0 * a.n_mu_discarded / a.n_mu_input
                  if a.n_mu_input else 0.0))

    def trace_pair(self, q: EncodedChain, t: EncodedChain) -> None:
        """-label1/-label2 explain mode (AlignQueryTarget_Trace,
        src/dssaligner.cpp:734-791): logs the per-pair routing, filter
        decisions, scores and path prefix for one chain pair."""
        from reseek_tpu.align.mkf import should_use_mkf
        from reseek_tpu.utils.logger import get_logger
        lg = get_logger()
        lg.log("\n______________________________________\n")
        lg.log("A>%s(%u)\n" % (q.label, len(q)))
        lg.log("B>%s(%u)\n" % (t.label, len(t)))
        p = self.params
        if should_use_mkf(q, t, p):
            lg.log("DoMKF()=true\n")
            res = self.aligner.align(q, t)
            lg.log("m_BestChainScore=%d\n" % res.best_chain_score)
            lg.log("AlnFwdScore=%.3g\n" % res.fwd_score)
        else:
            if p.omega > 0:
                lg.log("Omega > 0\n")
                score = self.aligner.mu_filter_score(q, t)
                ok = score >= p.omega
                lg.log("MuFilterScore=%.3g\n" % score)
                lg.log("MuFilterOk=%c\n" % ("T" if ok else "F"))
                if not ok:
                    return
            res = self.aligner.align(q, t, apply_filter=False)
            lg.log("AlnFwdScore=%.3g\n" % res.fwd_score)
        e = res.evalue
        lg.log("EvalueA=%.3g\n" % e if e > 1e5 else "EvalueA=%.1f\n" % e)
        lg.log("Path=(%u)%.10s...\n" % (len(res.path), res.path))

    def align_and_emit(self, q: EncodedChain, t: EncodedChain,
                      both_orientations: bool = True) -> Optional[AlignResult]:
        res = self.aligner.align(q, t)
        if res is None or not res.path:
            return res
        self.emit(res, q, t, True)
        if both_orientations:
            self.emit(res, q, t, False)
        return res


def _fwd_displayed(options: "SearchOptions") -> bool:
    """Whether output will display the raw forward score (dpscore/raw
    columns) — controls the engine's display-boundary recompute check."""
    return any(c in ("dpscore", "raw") for c in options.columns)


def resolve_engine(engine: str, mesh=None) -> str:
    """engine="auto": the device engine on the GPU (or with a mesh), the
    host engine on the CPU (reseek_tpu/device.py)."""
    if engine != "auto":
        return engine
    from reseek_tpu.device import default_engine
    return "device" if mesh is not None else default_engine()


def fast_engine(engine: str, n_cand: int, mesh=None) -> str:
    """Stage-2 engine of the -fast pipeline: "auto" takes the device
    engine only for at least RESEEK_FAST_DEVICE_MIN candidate pairs (the
    device engine pays a per-process warm-up; small candidate sets finish
    sooner on the native host path)."""
    if engine != "auto":
        return engine
    min_dev = int(os.environ.get("RESEEK_FAST_DEVICE_MIN", "20000"))
    if resolve_engine("auto", mesh) == "device" and n_cand >= min_dev:
        return "device"
    return "host"


def self_search(chains: List[Chain], params: DSSParams,
                options: SearchOptions, out: TextIO,
                engine: str = "auto", mesh=None) -> SearchDriver:
    """All-vs-all (src/runself.cpp): pairs (i, j >= i), self pair emitted
    once, other pairs in both orientations.

    engine: "auto" uses the batched device engine on the GPU (see
    resolve_engine), "device" forces it, "host" runs the per-pair path.
    mesh: optional jax.sharding.Mesh; stage-1 pair blocks and survivor
    alignment batches are sharded over its devices (SURVEY §2.8 items
    1-3), with bit-identical results to single-device."""
    engine = resolve_engine(engine, mesh)
    if mesh is not None and (engine != "device" or options.global_aln):
        import warnings
        warnings.warn("self_search: mesh is ignored on the host/global "
                      "path; running single-device", stacklevel=2)
    if options.global_aln:
        return _self_search_global(chains, params, options, out)
    if engine == "device":
        return _self_search_device(chains, params, options, out, mesh=mesh)
    ecs = _encode_all(chains, params, with_self_rev=True)
    drv = SearchDriver(params, options, out)
    n = len(ecs)
    drv.query_count = n
    _maybe_trace(drv, ecs, options)
    for i in range(n):
        for j in range(i, n):
            if options.no_self and i == j:
                continue
            drv.processed_pairs += 1
            drv.align_and_emit(ecs[i], ecs[j], both_orientations=(i != j))
    return drv


def _encode_all(chains, params: DSSParams,
                with_self_rev: bool) -> List[EncodedChain]:
    """Encode chains for search; pre-encoded EncodedChains (e.g. loaded
    from an .rsdx artifact, io/artifact.py) pass through with only the
    missing self-rev scores computed (the artifact's -dbmu-and-more role,
    src/search.cpp:96-99)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from reseek_tpu.align.pipeline import FLT_MAX, self_rev_score

    def one(c):
        if isinstance(c, EncodedChain):
            if with_self_rev and c.self_rev_score == FLT_MAX:
                c.self_rev_score = self_rev_score(c, params)
            return c
        return encode_for_search(c, params, with_self_rev=with_self_rev)

    chains = list(chains)
    if len(chains) < 8:
        return [one(c) for c in chains]
    # the native encoder releases the GIL inside its ctypes call, so a
    # thread pool uses all host cores (reference: all-core OpenMP encode)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as tp:
        return list(tp.map(one, chains))


def _maybe_trace(drv: SearchDriver, ecs: List[EncodedChain],
                 options: SearchOptions) -> None:
    """-label1/-label2: log the one-pair pipeline trace when both labels
    are present (src/dssaligner.cpp:793-807)."""
    if not options.trace_labels:
        return
    l1, l2 = options.trace_labels
    by_label = {ec.label: ec for ec in ecs}
    if l1 in by_label and l2 in by_label:
        drv.trace_pair(by_label[l1], by_label[l2])


def _self_search_global(chains: List[Chain], params: DSSParams,
                        options: SearchOptions, out: TextIO) -> SearchDriver:
    """-global all-vs-all (src/runself.cpp:48-56 +
    AlignQueryTarget_Global, src/global.cpp:7-33): Mu filter, then global
    Viterbi with free terminal gaps; no E-value is computed, so rows are
    only emitted with scores_are_not_evalues."""
    from reseek_tpu.ops.nw import nw_align
    from reseek_tpu.ops.substmx import build_smx
    ecs = [encode_for_search(c, params, with_self_rev=False)
           for c in chains]
    drv = SearchDriver(params, options, out)
    n = len(ecs)
    for i in range(n):
        for j in range(i, n):
            if options.no_self and i == j:
                continue
            q, t = ecs[i], ecs[j]
            if params.omega > 0 and not drv.aligner.mu_filter(q, t):
                continue
            smx = build_smx(params, q.profile, t.profile)
            score, path = nw_align(smx)
            if not path:
                continue
            res = AlignResult(query=q.label, target=t.label,
                              fwd_score=0.0, lo_a=0, lo_b=0, path=path,
                              global_score=score)
            n_m = path.count("M")
            res.hi_a = res.lo_a + n_m + path.count("D") - 1
            res.hi_b = res.lo_b + n_m + path.count("I") - 1
            res.ids = n_m
            res.gaps = len(path) - n_m
            drv.emit(res, q, t, True)
            if i != j:
                drv.emit(res, q, t, False)
    return drv


def _self_search_device(chains: List[Chain], params: DSSParams,
                        options: SearchOptions, out: TextIO,
                        mesh=None) -> SearchDriver:
    """Batched all-vs-all on the sorted-DB rectangular device pipeline
    (engine.DeviceSelfSearch); long-chain (MKF-routed) pairs run on the
    host path for reference parity."""
    import math
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from reseek_tpu.align.pipeline import self_rev_score
    from reseek_tpu.search.engine import DeviceSelfSearch, configure_jax
    configure_jax()
    ecs = _encode_all(chains, params, with_self_rev=False)
    have_selfrev = all(ec.self_rev_score != _FLT_MAX for ec in ecs)
    pipe = DeviceSelfSearch(ecs, params, with_rev_profiles=False,
                            mesh=mesh)

    drv = SearchDriver(params, options, out)
    drv.engine = "device"
    n = len(ecs)
    drv.query_count = n
    drv.processed_pairs = n * (n + 1) // 2
    _maybe_trace(drv, ecs, options)
    lens = np.array([len(ec) for ec in ecs])
    long_set = [int(j) for j in np.flatnonzero(lens >= params.mkfl)]
    # pairs with max length >= mkfl are excluded from the device path and
    # aligned on the host MKF route (PairAligner routes MKF vs full SW
    # itself); this host work runs in a thread pool CONCURRENTLY with the
    # device stages (the native MKF kernel releases the GIL)
    long_pairs = []
    seen = set()
    for j in long_set:
        for i in range(n):
            a, b = (i, j) if i <= j else (j, i)
            if (a, b) not in seen:
                seen.add((a, b))
                long_pairs.append((a, b))
    # leave one core for the main thread: the device stages' wall time
    # is dominated by host-side dispatch/fetch, which starves when the
    # overlap pool saturates every core
    pool = ThreadPoolExecutor(
        max_workers=max(1, min(32, (os.cpu_count() or 4) - 1)))
    try:
        sr_futs = {}
        if not have_selfrev:
            # self-rev on the host thread pool (native exact SW kernel,
            # ops/sw_native.py; long chains take the MKF quirk path inside
            # self_rev_score) — bit-exact everywhere, no device compile,
            # overlapped with the device stage-1 filter below
            sr_futs = {i: pool.submit(self_rev_score, ecs[i], params)
                       for i, ec in enumerate(ecs)
                       if ec.self_rev_score == _FLT_MAX}
        survivors = pipe.stage1_survivors()
        for i, f in sr_futs.items():
            ecs[i].self_rev_score = f.result()
        # all self-rev scores are now known -> long-pair alignments can
        # finish (TS needs both chains' self-rev); they overlap with the
        # stage-3 survivor alignment below
        mkf_futs = [(a, b, pool.submit(drv.aligner.align, ecs[a], ecs[b]))
                    for a, b in long_pairs]
        # with the E-gate off, rows without E-values are emitted, so
        # sub-MinFwdScore pairs still need their paths (no prepass)
        need_all = (options.scores_are_not_evalues
                    or math.isinf(options.max_evalue))
        by_pair = pipe.align_survivors(
            survivors, need_all_paths=need_all,
            evalue_gate=None if need_all else options.max_evalue,
            fwd_displayed=_fwd_displayed(options))
        for a, b, f in mkf_futs:
            res = f.result()
            if res is not None and res.path:
                by_pair[(a, b)] = res
    finally:
        pool.shutdown(wait=True)
    # the muscore column is not produced by the bitmask stage-1; backfill
    # it for emitted pairs from the host filter (same saturation rules)
    if "muscore" in options.columns:
        for (i, j), res in by_pair.items():
            if res.mu_score == 0.0 and not (lens[i] >= params.mkfl
                                            or lens[j] >= params.mkfl):
                res.mu_score = drv.aligner.mu_filter_score(ecs[i], ecs[j])
    # emit in the reference's single-thread order: (i, j >= i) ascending,
    # Up row then Down row (src/runself.cpp:53-66)
    for (i, j) in sorted(by_pair):
        if options.no_self and i == j:
            continue
        res = by_pair[(i, j)]
        q, t = ecs[i], ecs[j]
        drv.emit(res, q, t, True)
        if i != j:
            drv.emit(res, q, t, False)
    return drv


def query_search(queries: Iterable[Chain], db_chains,
                 params: DSSParams, options: SearchOptions,
                 out: TextIO, engine: str = "auto",
                 mesh=None, chunk_size: Optional[int] = None
                 ) -> SearchDriver:
    """Query-vs-DB scan (src/runquery.cpp, note the role inversion: each
    streamed chain becomes the 'A' side, the loaded set is scanned as
    targets, output orientation flipped back).

    `db_chains` is a chain list, any iterable, or a PATH (streamed).
    The DB side is processed in chunks of `chunk_size` (default 4096 or
    $RESEEK_QUERY_CHUNK), so memory stays proportional to the query set
    plus one chunk regardless of DB size — the reference's streaming
    behavior (src/runquery.cpp:31-79).

    engine="device" batches each chunk's rectangle through the device
    engine (Mu filter + SW + LDDT staged like the self search); long
    (MKF-routed) pairs run on the host thread pool concurrently.  mesh
    shards the stage-2/3 pair batches over its devices (bit-equal
    output)."""
    engine = resolve_engine(engine, mesh)
    if mesh is not None and engine != "device":
        import warnings
        warnings.warn("query_search: mesh is ignored on the host path; "
                      "running single-device", stacklevel=2)
    if isinstance(db_chains, str):
        from reseek_tpu.io.reader import iter_chains
        db_iter = (c for c in iter_chains(db_chains) if len(c) > 0)
    else:
        db_iter = iter(db_chains)
    if engine == "device":
        if chunk_size is None:
            chunk_size = int(os.environ.get("RESEEK_QUERY_CHUNK", "4096"))
        return _query_search_device(list(queries), db_iter, params,
                                    options, out, mesh=mesh,
                                    chunk_size=chunk_size)
    # role inversion (src/search.cpp:39-60 + src/runquery.cpp:31-79): the
    # QUERY file is loaded in memory, the -db side is streamed as the
    # DSSAligner 'A' side, and output orientation is flipped back
    q_ecs = _encode_all(list(queries), params, with_self_rev=True)
    drv = SearchDriver(params, options, out)
    from reseek_tpu.align.pipeline import self_rev_score
    for tc in db_iter:
        t = (tc if isinstance(tc, EncodedChain)
             else encode_for_search(tc, params))
        if t.self_rev_score == _FLT_MAX:
            t.self_rev_score = self_rev_score(t, params)
        drv.query_count += 1
        for q in q_ecs:
            drv.processed_pairs += 1
            res = drv.aligner.align(t, q)
            if res is None or not res.path:
                continue
            drv.emit(res, t, q, False)
    return drv


def _query_search_device(queries: List[Chain], db_iter,
                         params: DSSParams, options: SearchOptions,
                         out: TextIO, mesh=None,
                         chunk_size: int = 4096) -> SearchDriver:
    """Query-vs-DB on the batched device engine, DB side chunked: per
    chunk, one sorted rectangular pipeline over queries + chunk targets,
    pair set staged through the Mu filter, score and fused
    traceback+LDDT kernels; long pairs on the host MKF thread pool,
    overlapped with device compute.  Memory is O(queries + chunk)."""
    import itertools
    import math
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from reseek_tpu.align.pipeline import self_rev_score
    from reseek_tpu.search.engine import DeviceSelfSearch, configure_jax
    configure_jax()
    q_ecs = _encode_all(queries, params, with_self_rev=False)
    nq = len(q_ecs)

    drv = SearchDriver(params, options, out)
    drv.engine = "device"
    need_all = (options.scores_are_not_evalues
                or math.isinf(options.max_evalue))
    pool = ThreadPoolExecutor(
        max_workers=max(1, min(32, (_os.cpu_count() or 4) - 1)))
    try:
        # query self-rev once, before the chunk loop
        sr_futs = {i: pool.submit(self_rev_score, q_ecs[i], params)
                   for i, ec in enumerate(q_ecs)
                   if ec.self_rev_score == _FLT_MAX}
        for i, f in sr_futs.items():
            q_ecs[i].self_rev_score = f.result()

        # chunk N+1's encode runs on the worker pool WHILE chunk N's
        # device stages execute (ProfileLoader-style overlap,
        # src/profileloader.cpp:50-60); the DB iterator is consumed
        # serially because the next encode is only submitted after the
        # previous one resolves
        def encode_chunk():
            chunk = list(itertools.islice(db_iter, chunk_size))
            if not chunk:
                return None
            return _encode_all(chunk, params, with_self_rev=False)

        pending = pool.submit(encode_chunk)
        first_chunk = True
        while True:
            t_ecs = pending.result()
            if t_ecs is None:
                break
            pending = pool.submit(encode_chunk)
            ecs = q_ecs + t_ecs
            nt = len(t_ecs)
            pipe = DeviceSelfSearch(ecs, params, with_rev_profiles=False,
                                    mesh=mesh)
            if first_chunk:
                _maybe_trace(drv, ecs, options)
                first_chunk = False
            drv.query_count += nt
            drv.processed_pairs += nq * nt
            lens = np.array([len(ec) for ec in ecs])

            sr_futs = {i: pool.submit(self_rev_score, ecs[i], params)
                       for i, ec in enumerate(ecs)
                       if ec.self_rev_score == _FLT_MAX}

            # pair rectangle with the role inversion of src/runquery.cpp:
            # A side = db chain (index nq+ti in this chunk), B = query
            qi, ti = np.meshgrid(np.arange(nq), np.arange(nt),
                                 indexing="ij")
            pairs = np.stack([nq + ti.ravel(), qi.ravel()], axis=1)
            is_long = (lens[pairs[:, 0]] >= params.mkfl) \
                | (lens[pairs[:, 1]] >= params.mkfl)
            long_pairs = pairs[is_long]
            dev_pairs = pairs[~is_long]

            if params.omega > 0 and len(dev_pairs):
                mu = pipe.stage1_scores(dev_pairs)
                dev_pairs = dev_pairs[mu >= params.omega]

            for i, f in sr_futs.items():
                ecs[i].self_rev_score = f.result()
            mkf_futs = [(int(a) - nq, int(b),
                         pool.submit(drv.aligner.align, ecs[a], ecs[b]))
                        for a, b in long_pairs]

            dev_results = pipe.align_survivors(
                dev_pairs, need_all_paths=need_all,
                evalue_gate=None if need_all else options.max_evalue,
                fwd_displayed=_fwd_displayed(options))
            by_pair = {(a - nq, b): r
                       for (a, b), r in dev_results.items() if r.path}
            for t_i, q_i, f in mkf_futs:
                res = f.result()
                if res is not None and res.path:
                    by_pair[(t_i, q_i)] = res
            # reference single-thread row order: per db chain in stream
            # order, each vs the loaded query set, orientation flipped
            # back (src/runquery.cpp:31-79)
            for t_i in range(nt):
                for q_i in range(nq):
                    res = by_pair.get((t_i, q_i))
                    if res is not None:
                        drv.emit(res, ecs[nq + t_i], ecs[q_i], False)
    finally:
        pool.shutdown(wait=True)
    return drv


def fast_search(queries: List[Chain], db, params: DSSParams,
                options: SearchOptions, out: TextIO,
                dbmu: Optional[str] = None,
                engine: str = "auto", mesh=None,
                prefilter_mode: Optional[str] = None) -> SearchDriver:
    """Big-DB prefilter pipeline (-fast -db, src/search.cpp:62-112):
    (1) Mu k-mer two-hit prefilter streams the whole DB and keeps the
    top-1500 targets per query; (2) only surviving targets are re-read
    (random access for .bca) and aligned with SENSITIVE parameters
    (PostMuFilter, src/postmufilter.cpp:116-208; one output row per hit).

    `db` is a path (streamed; memory stays proportional to the query set
    plus the survivor set) or an in-memory chain list.  `dbmu` names a
    Mu-letter FASTA of the DB so stage 1 skips DB encoding entirely
    (reference -dbmu, src/search.cpp:96-99).

    engine="device" routes the stage-2 alignment of survivors through
    the batched device pipeline (threaded target encode, device self-rev +
    Mu filter + fused SW/LDDT; host MKF thread pool for long pairs) —
    the device analog of PostMuFilter's parallel ChainBag scan.  "host"
    keeps the serial per-pair loop.  Output rows are identical."""
    from reseek_tpu.constants import DSSParams as _P
    from reseek_tpu.encoder.dss import encode_chain
    from reseek_tpu.search.prefilter import prefilter_search

    sens = _P.create("sensitive")
    # encode queries ONCE with sensitive params (Mu letters are
    # param-independent, so the prefilter reuses these encodes)
    q_ecs = _encode_all(queries, sens, with_self_rev=False)
    q_mu = [ec.mu_letters for ec in q_ecs]

    db_is_path = isinstance(db, str)
    n_targets = 0

    def target_mu_stream():
        nonlocal n_targets
        if dbmu is not None:
            from reseek_tpu.io.mufasta import iter_mu_fasta
            for i, (_label, letters) in enumerate(iter_mu_fasta(dbmu)):
                n_targets = i + 1
                yield i, letters
        elif db_is_path:
            from reseek_tpu.io.reader import iter_chains
            i = 0
            for c in iter_chains(db):
                if len(c) == 0:
                    continue
                n_targets = i + 1
                yield i, encode_chain(c).mu_letters
                i += 1
        else:
            n_targets = len(db)
            for i, c in enumerate(db):
                yield i, (c.mu_letters if isinstance(c, EncodedChain)
                          else encode_chain(c).mu_letters)

    pf = prefilter_search(q_mu, target_mu_stream(), mode=prefilter_mode)

    drv = SearchDriver(sens, options, out)
    drv.query_count = len(q_ecs)
    t2q = pf.target_to_queries()
    tidxs = sorted(t2q)

    # survivor chains, in ascending target-index order
    def survivor_chains():
        if db_is_path and db.lower().endswith(".bca"):
            # re-read by index, like PostMuFilter's BCAData::ReadChain
            # (src/postmufilter.cpp:164)
            from reseek_tpu.io.bca import BCAReader
            with BCAReader(db) as r:
                for tidx in tidxs:
                    yield tidx, r.read_chain(tidx)
        elif db_is_path:
            # formats without random access: one more sequential pass
            from reseek_tpu.io.reader import iter_chains
            idx = 0
            want = set(tidxs)
            for c in iter_chains(db):
                if len(c) == 0:
                    continue
                if idx in want:
                    yield idx, c
                idx += 1
        else:
            for tidx in tidxs:
                yield tidx, db[tidx]

    n_cand = sum(len(v) for v in t2q.values())
    engine = fast_engine(engine, n_cand, mesh)
    drv.engine = engine
    if engine == "device":
        _fast_align_device(drv, q_ecs, survivor_chains(), t2q, sens,
                           options, mesh=mesh)
    else:
        _fast_align_host(drv, q_ecs, survivor_chains(), t2q, sens)
    drv.processed_pairs = len(q_ecs) * n_targets
    return drv


def _fast_align_host(drv: SearchDriver, q_ecs: List[EncodedChain],
                     survivor_iter, t2q, sens: DSSParams) -> None:
    """Stage 2 on the native host kernels, parallel over targets like the
    reference's PostMuFilter ChainBag scan (src/postmufilter.cpp:116-208):
    each worker encodes its target, computes its self-rev and aligns it
    against the listed queries (native SW/MKF/LDDT release the GIL);
    emission stays in ascending-target order."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from reseek_tpu.align.pipeline import PairAligner, self_rev_score

    for ec in q_ecs:
        if ec.self_rev_score == _FLT_MAX:
            ec.self_rev_score = self_rev_score(ec, sens)

    def process(item):
        tidx, c = item
        t_ec = (c if isinstance(c, EncodedChain)
                else encode_for_search(c, sens))
        if t_ec.self_rev_score == _FLT_MAX:
            t_ec.self_rev_score = self_rev_score(t_ec, sens)
        pa = PairAligner(sens)  # per-task: no shared-counter races
        rows = []
        for qi in t2q[tidx]:
            res = pa.align(q_ecs[qi], t_ec)
            if res is not None and res.path:
                rows.append((qi, res))
        return t_ec, rows, pa

    n_workers = min(32, (os.cpu_count() or 2))
    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        for t_ec, rows, pa in pool.map(process, survivor_iter):
            drv.aligner.n_aligned += pa.n_aligned
            drv.aligner.n_mu_input += pa.n_mu_input
            drv.aligner.n_mu_discarded += pa.n_mu_discarded
            for qi, res in rows:
                drv.emit(res, q_ecs[qi], t_ec, True)


def _fast_align_emit(drv: SearchDriver, q_ecs: List[EncodedChain],
                     t_ec: EncodedChain, q_indices) -> None:
    for qi in q_indices:
        res = drv.aligner.align(q_ecs[qi], t_ec)
        if res is None or not res.path:
            continue
        drv.emit(res, q_ecs[qi], t_ec, True)


def _fast_align_device(drv: SearchDriver, q_ecs: List[EncodedChain],
                       survivor_iter, t2q, sens: DSSParams,
                       options: SearchOptions, mesh=None) -> None:
    """Stage 2 of the fast pipeline on the batched device engine
    (PostMuFilter's parallel ChainBag scan, src/postmufilter.cpp:116-208,
    re-cast as device batches): surviving targets are processed in
    chunks (memory O(queries + chunk), like the reference's streaming
    scan); per chunk, one combined DeviceSelfSearch over queries +
    chunk targets runs the Mu filter -> fused SW/LDDT on device, long
    (MKF-routed) pairs on the host thread pool.  Emission order matches
    the host path: per target ascending, its listed queries in order,
    up=True rows."""
    import itertools
    import math
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from reseek_tpu.align.pipeline import self_rev_score
    from reseek_tpu.search.engine import DeviceSelfSearch, configure_jax
    configure_jax()

    chunk_size = int(os.environ.get("RESEEK_FAST_CHUNK", "4096"))
    nq = len(q_ecs)
    need_all = (options.scores_are_not_evalues
                or math.isinf(options.max_evalue))
    pool = ThreadPoolExecutor(
        max_workers=max(1, min(32, (_os.cpu_count() or 4) - 1)))
    try:
        sr_futs = {i: pool.submit(self_rev_score, q_ecs[i], sens)
                   for i, ec in enumerate(q_ecs)
                   if ec.self_rev_score == _FLT_MAX}
        for i, f in sr_futs.items():
            q_ecs[i].self_rev_score = f.result()

        # prefetch: chunk N+1's target encode overlaps chunk N's device
        # stages (the iterator is consumed serially — the next chunk is
        # only submitted once the previous result is taken)
        def encode_chunk():
            chunk = list(itertools.islice(survivor_iter, chunk_size))
            if not chunk:
                return None
            return ([tidx for tidx, _ in chunk],
                    _encode_all([c for _, c in chunk], sens,
                                with_self_rev=False))

        pending = pool.submit(encode_chunk)
        while True:
            got = pending.result()
            if got is None:
                break
            pending = pool.submit(encode_chunk)
            t_order, t_ecs = got
            tpos = {tidx: k for k, tidx in enumerate(t_order)}
            ecs = list(q_ecs) + list(t_ecs)
            pipe = DeviceSelfSearch(ecs, sens, with_rev_profiles=False,
                                    mesh=mesh)
            lens = np.array([len(ec) for ec in ecs])

            # candidate pairs (query side = A, reference orientation of
            # PostMuFilter's AlignBags)
            pairs = np.array([(qi, nq + tpos[tidx])
                              for tidx in t_order for qi in t2q[tidx]],
                             np.int64).reshape(-1, 2)
            is_long = ((lens[pairs[:, 0]] >= sens.mkfl)
                       | (lens[pairs[:, 1]] >= sens.mkfl))

            # self-rev for the chunk's targets, overlapped with the
            # device Mu filter below
            sr_futs = {i: pool.submit(self_rev_score, ecs[i], sens)
                       for i, ec in enumerate(ecs)
                       if ec.self_rev_score == _FLT_MAX}

            dev_pairs = pairs[~is_long]
            mu_vals = {}
            if sens.omega > 0 and len(dev_pairs):
                mu = pipe.stage1_scores(dev_pairs)
                if "muscore" in options.columns:
                    mu_vals = {(int(a), int(b)): float(v)
                               for (a, b), v in zip(dev_pairs, mu)}
                dev_pairs = dev_pairs[mu >= sens.omega]

            for i, f in sr_futs.items():
                ecs[i].self_rev_score = f.result()

            mkf_futs = [(int(a), int(b),
                         pool.submit(drv.aligner.align, ecs[a], ecs[b]))
                        for a, b in pairs[is_long]]
            by_pair = pipe.align_survivors(
                dev_pairs, need_all_paths=need_all,
                evalue_gate=None if need_all else options.max_evalue,
                fwd_displayed=_fwd_displayed(options))
            for a, b, f in mkf_futs:
                res = f.result()
                if res is not None and res.path:
                    by_pair[(a, b)] = res
            for key, v in mu_vals.items():
                if key in by_pair:
                    by_pair[key].mu_score = v

            for tidx in t_order:
                t_ec = t_ecs[tpos[tidx]]
                for qi in t2q[tidx]:
                    res = by_pair.get((qi, nq + tpos[tidx]))
                    if res is not None and res.path:
                        drv.emit(res, q_ecs[qi], t_ec, True)
    finally:
        pool.shutdown(wait=True)
