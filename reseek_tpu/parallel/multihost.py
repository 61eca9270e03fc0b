"""Multi-host deployment orchestration (SURVEY §2.8 items 2-3).

The reference is single-node (std::thread only); scaling past one host
here follows the standard JAX multi-controller recipe:

  1. every host runs the same program and calls `init_distributed()`
     (jax.distributed — coordinator address/rank from env or args);
  2. each host loads only ITS contiguous shard of the target DB
     (`host_shard_bounds`), encodes it locally (native encoder), and
     scans it with the native prefilter;
  3. per-query top-B candidate lists merge with the device collective in
     reseek_tpu/parallel/topk.py (all_gather + top_k over the global
     mesh, RankedScoresBag tie-break), so every host ends up with the
     identical global selection;
  4. stage-2 alignment of the survivors that live in the host's shard
     runs locally; process 0 concatenates row files (hits are emitted
     per target in ascending global index, so a simple ordered merge of
     per-host outputs reproduces the single-host row order).

All four steps are implemented by `distributed_fast_search` below and
exposed as `search ... -fast -nprocs N -procid I -coord HOST:PORT` in the
CLI (`--local-device-ids` pins a process to its card on a multi-card
host; chip_smoke.py --four-cards runs four such processes).  The tests
exercise the full path with REAL process boundaries on the CPU backend:
tests/test_multihost.py spawns 2 jax.distributed subprocesses
(localhost coordinator, Gloo collectives) and asserts byte-equality of
process 0's merged output with the single-process fast_search output;
tests/test_topk.py asserts mesh-vs-single selection parity on the
8-virtual-device mesh.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[List[int]] = None
                     ) -> Tuple[int, int]:
    """Initialize jax.distributed (no-op for a single process).  Returns
    (process_id, num_processes).  local_device_ids restricts this process
    to the given local devices (one card per process on a multi-card
    host)."""
    import jax
    if num_processes is None or num_processes <= 1:
        return 0, 1
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    if jax.process_count() != num_processes:
        raise RuntimeError(f"jax.distributed joined {jax.process_count()} "
                           f"processes, expected {num_processes}")
    return jax.process_index(), jax.process_count()


def host_shard_bounds(n_targets: int, process_id: int,
                      num_processes: int) -> Tuple[int, int]:
    """Contiguous [lo, hi) target range owned by this host.  Contiguity
    matters: the top-B merge's tie-break relies on shards covering
    ascending global index ranges (parallel/topk.py)."""
    bounds = np.linspace(0, n_targets, num_processes + 1).astype(np.int64)
    return int(bounds[process_id]), int(bounds[process_id + 1])


def global_mesh(axis: str = "db"):
    """1-axis mesh over every device of every process (the canonical
    multi-host layout: one shard per device, devices grouped by process
    in jax.devices() order so per-process shard ranges are contiguous)."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()), (axis,))


def _mesh_shard_ranges(mesh, n_targets: int):
    """[(mesh_pos, lo, hi)] global target range per mesh device, plus the
    subset owned by THIS process (ascending mesh position)."""
    import jax
    n_dev = mesh.devices.size
    bounds = np.linspace(0, n_targets, n_dev + 1).astype(np.int64)
    allr = [(k, int(bounds[k]), int(bounds[k + 1])) for k in range(n_dev)]
    pid = jax.process_index()
    local = [r for r, d in zip(allr, mesh.devices.flat)
             if d.process_index == pid]
    return allr, local


def distributed_fast_search(queries, db, options, out,
                            scratch_dir: str, dbmu: Optional[str] = None,
                            top_b: int = 1500, prefilter_mode=None,
                            engine: str = "auto", mesh=None,
                            resume: bool = False):
    """End-to-end multi-host -fast search (SURVEY §2.8 items 2-4; no
    reference counterpart — the reference is single-node,
    src/runthreads.cpp:4-17).  Every process runs this same function:

      1. each process scans the target sub-shards owned by its mesh
         devices with the native prefilter (stage 1, global indices);
      2. per-query top-B lists merge with the device collective
         (parallel/topk.merge_topk_distributed) — every process ends up
         with the identical global selection;
      3. each process aligns the survivors living in its own shard
         against the (replicated) queries with SENSITIVE parameters
         (PostMuFilter semantics, src/postmufilter.cpp:116-208), writing
         rows to scratch_dir/rows.<pid>;
      4. after a global barrier, process 0 concatenates the row files in
         process order into `out` — shards cover ascending contiguous
         target ranges and rows are emitted per target ascending, so the
         concatenation reproduces the single-process row order exactly
         (byte-equality asserted in tests/test_multihost.py).

    `db` is a .bca path (random-access stage-2 re-reads, like the
    reference's BCAData::ReadChain) or an in-memory chain list.  `dbmu`
    names a Mu-letter FASTA so stage 1 skips DB encoding (-dbmu).
    `resume=True` makes completed shards restartable: per-host row
    files are written atomically (tmp + rename), so after a partial
    failure re-running the same command skips every shard whose
    rows.<pid> already exists.  Returns this process's SearchDriver
    (row counts cover its shard)."""
    import os

    import jax

    from reseek_tpu.constants import DSSParams
    from reseek_tpu.parallel.topk import (merge_topk_distributed,
                                          pad_topk_lists)
    from reseek_tpu.search.driver import (SearchDriver, _encode_all,
                                          _fast_align_device,
                                          _fast_align_host, fast_engine)
    from reseek_tpu.search.prefilter import MuPrefilter, PrefilterResult

    if mesh is None:
        mesh = global_mesh()
    axis = mesh.axis_names[0]
    pid = jax.process_index()

    sens = DSSParams.create("sensitive")
    q_ecs = _encode_all(list(queries), sens, with_self_rev=False)
    q_mu = [ec.mu_letters for ec in q_ecs]
    nq = len(q_ecs)

    db_is_path = isinstance(db, str)
    if db_is_path:
        from reseek_tpu.io.bca import BCAReader
        with BCAReader(db) as r:
            n_targets = len(r)
    else:
        n_targets = len(db)

    if dbmu is not None:
        from reseek_tpu.io.mufasta import iter_mu_fasta
        all_mu = [m for _l, m in iter_mu_fasta(dbmu)]

        def shard_mu(lo, hi):
            return all_mu[lo:hi]
    else:
        from reseek_tpu.encoder.dss import encode_chain

        def shard_mu(lo, hi):
            if db_is_path:
                from reseek_tpu.io.bca import BCAReader
                with BCAReader(db) as r:
                    return [encode_chain(r.read_chain(t)).mu_letters
                            for t in range(lo, hi)]
            return [(c.mu_letters if hasattr(c, "mu_letters")
                     else encode_chain(c).mu_letters) for c in db[lo:hi]]

    # 1-2: per-device shard scans + collective global top-B merge
    _allr, local = _mesh_shard_ranges(mesh, n_targets)
    loc_sv, loc_ti = [], []
    for _k, lo, hi in local:
        pf = MuPrefilter(q_mu, top_b=top_b, mode=prefilter_mode,
                         ascii_roundtrip=True)
        mus = [np.asarray(m, np.uint8) for m in shard_mu(lo, hi)]
        if mus:
            pf.add_targets(mus, list(range(lo, hi)))
        sv, ti = pad_topk_lists(pf.finish().query_targets, nq, top_b)
        loc_sv.append(sv)
        loc_ti.append(ti)
    merged = PrefilterResult(query_targets=merge_topk_distributed(
        mesh, axis, loc_sv, loc_ti, top_b))

    # 3: stage-2 alignment of the survivors in THIS process's ranges
    proc_lo = local[0][1]
    proc_hi = local[-1][2]
    t2q = {t: qs for t, qs in merged.target_to_queries().items()
           if proc_lo <= t < proc_hi}
    tidxs = sorted(t2q)

    def survivor_chains():
        if db_is_path:
            from reseek_tpu.io.bca import BCAReader
            with BCAReader(db) as r:
                for t in tidxs:
                    yield t, r.read_chain(t)
        else:
            for t in tidxs:
                yield t, db[t]

    # per-host row files double as RESTART CHECKPOINTS (SURVEY §5:
    # "persistent artifacts act as stage checkpoints... resumable
    # per-shard scan"): rows are written to a .tmp and renamed only on
    # completion, so a completed shard is exactly "rows.<pid> exists".
    # With resume=True a host whose shard already completed skips its
    # stage-2 work entirely and goes straight to the barrier.
    rows_fn = os.path.join(scratch_dir, f"rows.{pid}")
    if resume and os.path.exists(rows_fn):
        drv = SearchDriver(sens, options, open(os.devnull, "w"))
        drv.query_count = nq
    else:
        tmp_fn = rows_fn + ".tmp"
        with open(tmp_fn, "w") as rows_out:
            drv = SearchDriver(sens, options, rows_out)
            drv.query_count = nq
            n_cand = sum(len(v) for v in t2q.values())
            drv.engine = fast_engine(engine, n_cand)
            if drv.engine == "device":
                _fast_align_device(drv, q_ecs, survivor_chains(), t2q,
                                   sens, options)
            else:
                _fast_align_host(drv, q_ecs, survivor_chains(), t2q,
                                 sens)
        os.replace(tmp_fn, rows_fn)
    drv.processed_pairs = nq * (proc_hi - proc_lo)

    # 4: barrier, then ordered concatenation on process 0
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("reseek_rows_done")
    if pid == 0 and out is not None:
        for p in range(jax.process_count()):
            with open(os.path.join(scratch_dir, f"rows.{p}")) as f:
                out.write(f.read())
    return drv


def distributed_prefilter(query_mu, target_mu_shard, shard_lo: int,
                          mesh, axis: str = "db", top_b: int = 1500,
                          mode=None, ascii_roundtrip: bool = True):
    """This host's prefilter scan over its shard + the global collective
    merge.  target_mu_shard holds the Mu letters of targets
    [shard_lo, shard_lo + len) only; the returned PrefilterResult holds
    the GLOBAL per-query top-B (identical on every host).

    With one process and an n-device mesh, the shard is subdivided
    across the mesh devices (the same path a multi-host run takes with
    one device per host)."""
    from reseek_tpu.parallel.topk import PAD_SCORE, merge_topk_sharded
    from reseek_tpu.search.prefilter import MuPrefilter, PrefilterResult

    n_dev = mesh.devices.size
    nq = len(query_mu)
    nt = len(target_mu_shard)
    bounds = np.linspace(0, nt, n_dev + 1).astype(np.int64)
    shard_scores, shard_tidx = [], []
    for d in range(n_dev):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        pf = MuPrefilter(query_mu, top_b=top_b, mode=mode,
                         ascii_roundtrip=ascii_roundtrip)
        mus = [np.asarray(m, np.uint8) for m in target_mu_shard[lo:hi]]
        if mus:
            pf.add_targets(mus, list(range(shard_lo + lo, shard_lo + hi)))
        res = pf.finish()
        sv = np.full((nq, top_b), PAD_SCORE, np.int32)
        ti = np.full((nq, top_b), np.int32(2**31 - 1), np.int32)
        for qi, lst in enumerate(res.query_targets):
            for k, (t, s) in enumerate(lst[:top_b]):
                sv[qi, k] = s
                ti[qi, k] = t
        shard_scores.append(sv)
        shard_tidx.append(ti)
    merged = merge_topk_sharded(mesh, axis, shard_scores, shard_tidx,
                                top_b)
    return PrefilterResult(query_targets=merged)
