"""Batched device search engine.

Design rules:
  - fetch only compact score/path arrays from the device, never
    substitution or traceback tensors, and batch the fetches
  - upload the DB once; per-batch index vectors and LDDT coords are small
  - few fixed compiled shapes (length buckets, one batch size per bucket)
    and a persistent compilation cache, so warm-up stays bounded

Pipeline stages (pair pipeline of src/dssaligner.cpp over batches):
  stage 1  Mu filter:  fwd+rev 36-letter SW and Omega gating on device
  stage 2  full SW score (bit-exact gathered substitution matrix)
  stage 3  traceback alignment: SW + on-device backward walk -> lo/path
  stage 4  LDDT on device from uploaded aligned-column coords; TS/E host
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from reseek_tpu import device
from reseek_tpu.align.pipeline import AlignResult, EncodedChain
from reseek_tpu.constants import ALPHA_SIZES, DSSParams, StatSig
from reseek_tpu.data.tables import get_tables

DEFAULT_BUCKETS = (96, 192, 384, 768, 1536, 3072)
CELL_BUDGET = 1 << 26  # B * L * L cells per device batch (to be tuned on
                       # the H100)
PAD_BYTE = 255         # profile pad marker in device uint8 arrays


def configure_jax() -> None:
    """Enable the persistent compilation cache: where
    JAX_COMPILATION_CACHE_DIR says (JAX reads it itself), else at the
    fixed <repo>/.jax_cache."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        cache_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


MAX_BATCH = 2048  # pairs per batch cap (to be tuned on the H100)


def batch_size_for(bucket: int) -> int:
    return max(1, min(MAX_BATCH, CELL_BUDGET // (bucket * bucket)))


@functools.lru_cache(maxsize=None)
def _kernels():
    """Square-bucket stage kernels on the plain JAX wavefront
    (ops/sw_jax.py; bit-identical to ops/sw_np.py)."""
    import jax
    import jax.numpy as jnp
    from reseek_tpu.ops.postalign_jax import lddt_batch, walk_traceback_batch
    from reseek_tpu.ops.sw_jax import sw_score_batch, sw_traceback_batch
    from reseek_tpu.ops.sw_sweep import mu_smx_onehot as mu_smx

    def stage1_mu(mu_db, mu_rev_db, idx_a, idx_b, mumx, omega_fwd,
                  bucket, open_, ext):
        a = mu_db[idx_a][:, :bucket].astype(jnp.int32)
        ar = mu_rev_db[idx_a][:, :bucket].astype(jnp.int32)
        b = mu_db[idx_b][:, :bucket].astype(jnp.int32)
        fwd = sw_score_batch(mu_smx(a, b, mumx), open_, ext)
        rev = sw_score_batch(mu_smx(ar, b, mumx), open_, ext)
        # parasail saturation semantics (see MU_SAT_* notes below)
        fwd = jnp.where(fwd > np.float32(250.0), np.float32(777.0), fwd)
        rev = jnp.where(rev > np.float32(250.0), np.float32(255.0), rev)
        return jnp.where(fwd < omega_fwd, np.float32(0.0), fwd - rev)

    def stage2_full(prof_a_db, prof_b_db, idx_a, idx_b, w, offsets,
                    pad_code, bucket, open_, ext):
        ca = _codes_slice(prof_a_db, idx_a, offsets, bucket, pad_code)
        cb = _codes_slice(prof_b_db, idx_b, offsets, bucket, pad_code)
        return sw_score_batch(_smx_onehot(ca, cb, w), open_, ext)

    def stage3_align(prof_db, idx_a, idx_b, w, offsets, pad_code, bucket,
                     open_, ext):
        ca = _codes_slice(prof_db, idx_a, offsets, bucket, pad_code)
        cb = _codes_slice(prof_db, idx_b, offsets, bucket, pad_code)
        best, bi, bj, tbs = sw_traceback_batch(_smx_onehot(ca, cb, w),
                                               open_, ext)
        lo_a, lo_b, plen, path_rev = walk_traceback_batch(tbs, best, bi, bj)
        return best, lo_a, lo_b, plen, path_rev

    def stage4_lddt(cq, ct, valid, ncols):
        return lddt_batch(cq, ct, valid, ncols)

    return {
        "stage1_mu": jax.jit(
            stage1_mu,
            static_argnames=("omega_fwd", "bucket", "open_", "ext")),
        "stage2_full": jax.jit(
            stage2_full,
            static_argnames=("pad_code", "bucket", "open_", "ext")),
        "stage3_align": jax.jit(
            stage3_align,
            static_argnames=("pad_code", "bucket", "open_", "ext")),
        "stage4_lddt": jax.jit(stage4_lddt),
    }


def _mu_matrix_padded() -> np.ndarray:
    m = np.full((37, 37), np.float32(-9e9) / 2, np.float32)
    m[:36, :36] = get_tables().mu_score_mx_int8.astype(np.float32)
    return m


class DeviceDB:
    """Encoded chains resident on device.

    Host keeps EncodedChain list (coords, labels, profiles); the device
    holds uint8 profile/Mu arrays padded to a single Lmax, gathered and
    sliced per batch on device.
    """

    def __init__(self, ecs: List[EncodedChain], params: DSSParams,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 with_rev_profiles: bool = True):
        import jax.numpy as jnp
        from reseek_tpu.encoder.dss import encode_chain
        from reseek_tpu.ops.smx_jax import flat_layout

        self.ecs = ecs
        self.params = params
        offsets, d, w = flat_layout(params.features, params.weights)
        self.offsets = jnp.asarray(offsets.astype(np.int32))
        self.pad_code = int(d)
        self.w = jnp.asarray(w)
        self.mumx = jnp.asarray(_mu_matrix_padded())

        lens = np.array([len(ec) for ec in ecs])
        lmax = int(lens.max()) if len(lens) else 1
        if lmax > buckets[-1]:
            # chains longer than the largest preset bucket (possible in
            # verysensitive mode, where MKF routing is off) get a final
            # bucket rounded up to 256 — never silently truncated
            self.lmax = -(-lmax // 256) * 256
        else:
            self.lmax = bucket_for(lmax, buckets)
        self.buckets = tuple(b for b in buckets if b <= self.lmax)
        if not self.buckets or self.buckets[-1] < self.lmax:
            self.buckets = tuple(self.buckets) + (self.lmax,)

        n = len(ecs)
        nf = len(params.features)
        prof = np.full((n, nf, self.lmax), PAD_BYTE, np.uint8)
        mu = np.full((n, self.lmax), 36, np.uint8)
        mu_rev = np.full((n, self.lmax), 36, np.uint8)
        for i, ec in enumerate(ecs):
            L = min(len(ec), self.lmax)
            prof[i, :, :L] = ec.profile[:, :L]
            mu[i, :L] = ec.mu_letters[:L]
            mu_rev[i, :L] = ec.mu_letters[:L][::-1]
        self.prof = jnp.asarray(prof)
        self.mu = jnp.asarray(mu)
        self.mu_rev = jnp.asarray(mu_rev)

        self.prof_rev = None
        if with_rev_profiles:
            prof_rev = np.full((n, nf, self.lmax), PAD_BYTE, np.uint8)
            for i, ec in enumerate(ecs):
                L = min(len(ec), self.lmax)
                rp = encode_chain(ec.chain.reversed()).profile(params)
                prof_rev[i, :, :L] = rp[:, :L]
            self.prof_rev = jnp.asarray(prof_rev)


class BatchedEngine:
    def __init__(self, db: DeviceDB):
        self.db = db
        self.params = db.params
        self.k = _kernels()

    # -- batching ------------------------------------------------------
    def _bucketed(self, pairs: np.ndarray
                  ) -> Iterator[Tuple[int, np.ndarray, int, np.ndarray]]:
        if len(pairs) == 0:
            return
        lens = np.array([len(ec) for ec in self.db.ecs])
        maxlen = np.minimum(np.maximum(lens[pairs[:, 0]], lens[pairs[:, 1]]),
                            self.db.lmax)
        edges = np.asarray(self.db.buckets)
        pb = edges[np.minimum(np.searchsorted(edges, maxlen),
                              len(edges) - 1)]
        for b in sorted(set(pb.tolist())):
            rows_all = np.flatnonzero(pb == b)
            bs = batch_size_for(b)
            for kk in range(0, len(rows_all), bs):
                rows = rows_all[kk: kk + bs]
                chunk = pairs[rows]
                n = len(chunk)
                if n < bs:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], bs - n, axis=0)])
                yield b, chunk, n, rows

    # -- stages --------------------------------------------------------
    def mu_filter_scores(self, pairs: np.ndarray) -> np.ndarray:
        """Filter value per pair: 0 if fwd < OmegaFwd else fwd - rev
        (src/parasail_mu.cpp:120-161).  Single fetch at the end."""
        import jax.numpy as jnp
        p = self.params
        o, e = -float(p.para_mu_gap_open), -float(p.para_mu_gap_ext)
        chunks = []
        rows_list = []
        for bucket, chunk, n, rows in self._bucketed(pairs):
            sc = self.k["stage1_mu"](
                self.db.mu, self.db.mu_rev,
                jnp.asarray(chunk[:, 0]), jnp.asarray(chunk[:, 1]),
                self.db.mumx, float(p.omega_fwd), bucket, o, e)
            chunks.append(sc[:n])
            rows_list.append(rows)
        if not chunks:
            return np.zeros(0, np.float32)
        allsc = np.asarray(jnp.concatenate(chunks))  # one fetch
        out = np.zeros(len(pairs), np.float32)
        out[np.concatenate(rows_list)] = allsc
        return out

    def full_scores(self, pairs: np.ndarray,
                    b_side_rev: bool = False) -> np.ndarray:
        """Stage-2 SW scores; with b_side_rev the target profile array is
        the reversed-chain encodes (used for self-reversal scores)."""
        import jax.numpy as jnp
        p = self.params
        prof_b = self.db.prof_rev if b_side_rev else self.db.prof
        chunks = []
        rows_list = []
        for bucket, chunk, n, rows in self._bucketed(pairs):
            sc = self.k["stage2_full"](
                self.db.prof, prof_b,
                jnp.asarray(chunk[:, 0]), jnp.asarray(chunk[:, 1]),
                self.db.w, self.db.offsets, self.db.pad_code, bucket,
                float(p.gap_open), float(p.gap_ext))
            chunks.append(sc[:n])
            rows_list.append(rows)
        if not chunks:
            return np.zeros(0, np.float32)
        allsc = np.asarray(jnp.concatenate(chunks))
        out = np.zeros(len(pairs), np.float32)
        out[np.concatenate(rows_list)] = allsc
        return out

    def self_rev_scores(self) -> np.ndarray:
        """GetSelfRevScore per chain (src/alignpair.cpp:7-25), batched."""
        n = len(self.db.ecs)
        pairs = np.stack([np.arange(n), np.arange(n)], axis=1)
        return self.full_scores(pairs, b_side_rev=True)

    def full_alignments(self, pairs: np.ndarray) -> List[AlignResult]:
        """Stage 3+4: paths on device, LDDT on device, TS/P/E on host."""
        import jax
        import jax.numpy as jnp
        from reseek_tpu.ops.postalign_jax import PD, PI, PM
        p = self.params
        results: List[Optional[AlignResult]] = [None] * len(pairs)
        per_batch = []
        for bucket, chunk, n, rows in self._bucketed(pairs):
            best, lo_a, lo_b, plen, path_rev = self.k["stage3_align"](
                self.db.prof, jnp.asarray(chunk[:, 0]),
                jnp.asarray(chunk[:, 1]), self.db.w, self.db.offsets,
                self.db.pad_code, bucket,
                float(p.gap_open), float(p.gap_ext))
            per_batch.append((bucket, chunk, n, rows, best, lo_a, lo_b,
                              plen, path_rev))
        # batch all device fetches into one device_get
        fetched = jax.device_get([b[4:] for b in per_batch])

        code_char = {PM: "M", PD: "D", PI: "I"}
        lddt_jobs = []
        for (bucket, chunk, n, rows, *_), \
                (best, lo_a, lo_b, plen, path_rev) in zip(per_batch,
                                                          fetched):
            batch_results = []
            m_bucket = bucket  # max aligned columns
            cq = np.zeros((len(chunk), m_bucket, 3), np.float32)
            ct = np.zeros((len(chunk), m_bucket, 3), np.float32)
            valid = np.zeros((len(chunk), m_bucket), bool)
            ncols = np.zeros(len(chunk), np.int32)
            for kk in range(n):
                qi, ti = int(chunk[kk, 0]), int(chunk[kk, 1])
                q, t = self.db.ecs[qi], self.db.ecs[ti]
                res = AlignResult(query=q.label, target=t.label,
                                  fwd_score=float(best[kk]))
                if best[kk] > 0:
                    codes = path_rev[kk, : plen[kk]][::-1]
                    res.path = "".join(code_char[c] for c in codes)
                    res.lo_a = int(lo_a[kk])
                    res.lo_b = int(lo_b[kk])
                    if res.fwd_score >= p.min_fwd_score:
                        is_m = codes == PM
                        adv_a = (codes != PI).astype(np.int64)
                        adv_b = (codes != PD).astype(np.int64)
                        pos_a = res.lo_a + np.cumsum(adv_a) - adv_a
                        pos_b = res.lo_b + np.cumsum(adv_b) - adv_b
                        pq = pos_a[is_m]
                        pt = pos_b[is_m]
                        m = len(pq)
                        cq[kk, :m] = q.chain.coords[pq]
                        ct[kk, :m] = t.chain.coords[pt]
                        valid[kk, :m] = True
                        ncols[kk] = m
                batch_results.append(res)
            lddt_dev = self.k["stage4_lddt"](
                jnp.asarray(cq), jnp.asarray(ct), jnp.asarray(valid),
                jnp.asarray(ncols))
            lddt_jobs.append((batch_results, chunk, n, rows, lddt_dev))

        lddt_fetched = jax.device_get([j[4] for j in lddt_jobs])
        for (batch_results, chunk, n, rows, _), lddt in zip(lddt_jobs,
                                                            lddt_fetched):
            for kk in range(n):
                res = batch_results[kk]
                qi, ti = int(chunk[kk, 0]), int(chunk[kk, 1])
                q, t = self.db.ecs[qi], self.db.ecs[ti]
                if res.path and res.fwd_score >= self.params.min_fwd_score:
                    _finish_from_lddt(res, q, t, self.params,
                                      float(lddt[kk]))
                results[rows[kk]] = res
        return results


def _finish_from_lddt(res: AlignResult, q: EncodedChain, t: EncodedChain,
                      p: DSSParams, lddt: float) -> None:
    """TS/P/E from a precomputed LDDT, float32 order of
    src/dssaligner.cpp:852-904."""
    from reseek_tpu.align.pipeline import FLT_MAX, _ts_value
    n_m = res.path.count("M")
    n_d = res.path.count("D")
    n_i = res.path.count("I")
    res.hi_a = res.lo_a + n_m + n_d - 1
    res.hi_b = res.lo_b + n_m + n_i - 1
    res.ids = n_m
    res.gaps = n_d + n_i
    res.lddt = lddt
    sa, sb = q.self_rev_score, t.self_rev_score
    if sa != FLT_MAX and sb != FLT_MAX:
        rev_dp = np.float32(np.float32(sa) + np.float32(sb)) / np.float32(2)
    else:
        rev_dp = np.float32(0.0)
    res.ts = float(_ts_value(np.float32(res.lddt),
                             np.float32(res.fwd_score), rev_dp,
                             len(q), len(t)))
    res.pvalue = StatSig.pvalue(res.ts)
    res.evalue = StatSig.evalue(res.ts)
    res.qual = StatSig.qual(res.ts)


# Back-compat alias used by engine tests / finishers
def finish_result(res: AlignResult, q: EncodedChain, t: EncodedChain,
                  p: DSSParams) -> None:
    from reseek_tpu.align.pipeline import _path_positions
    from reseek_tpu.ops.lddt import lddt_mu_fast
    if res.fwd_score < p.min_fwd_score:
        return
    pos_q, pos_t = _path_positions(res.lo_a, res.lo_b, res.path)
    lddt = lddt_mu_fast(q.chain.coords, t.chain.coords, pos_q, pos_t)
    _finish_from_lddt(res, q, t, p, lddt)


# ---------------------------------------------------------------------------
# Sorted-DB rectangular-bucket device pipeline (the production self-search).
#
# The square-bucket BatchedEngine above pads every pair to
# [maxbucket, maxbucket] and uploads explicit index vectors; at all-vs-all
# scale that wastes 2-8x the cells and the host<->device traffic.  This
# pipeline instead:
#   - sorts chains by length once, so each length bucket is a contiguous
#     range and pair batches are generated ON DEVICE from range scalars
#     (no index uploads; replaces the work-stealing pair loop of
#     src/runself.cpp:72-99)
#   - buckets pairs rectangularly [la_bucket, lb_bucket] with the shorter
#     side on the sequential axis
#   - stage 1 (Mu filter, src/dssaligner.cpp:619-630 + parasail saturation
#     src/parasail_mu.cpp:135-139) runs the integer-exact Mu kernel
#     (ops/sw_cuda.py on the GPU, the ops/sw_sweep.py scan elsewhere) and
#     returns PACKED BITS (1 bit/pair instead of 4 bytes fetched)
#   - survivors go straight to a fused traceback+LDDT kernel (stage 3):
#     SW with traceback, on-device path walk, aligned-column coordinate
#     gather and LDDT, so only compact per-pair arrays are fetched
#   - TS/P-value/E-value finish vectorized on host in reference float32
#     order (src/dssaligner.cpp:852-904)
# ---------------------------------------------------------------------------

# Cell budgets sizing the per-launch device batches (to be tuned on the
# H100).  Env-overridable so the CPU backend can shrink peak memory: on
# the plain path the dominant transient is the [B, L, L] f32 substitution
# tensor plus its skewed copy, ~8 bytes/cell; the CUDA traceback kernel
# keeps ~1 byte/cell of traceback bits.
STAGE1_CELLS = int(os.environ.get("RESEEK_STAGE1_CELLS", str(1 << 28)))
STAGE2_CELLS = int(os.environ.get("RESEEK_STAGE2_CELLS", str(1 << 27)))
STAGE3_CELLS = int(os.environ.get("RESEEK_STAGE3_CELLS", str(1 << 26)))
# Stage 2 (score-only prepass) uses the row-sweep kernel, whose float
# summation order differs from the reference wavefront by at most ~1e-3
# on real profiles; the guard band keeps every pair that could exactly
# pass MinFwdScore in stage 3, where the bit-exact kernel re-gates.
STAGE2_GUARD = np.float32(0.5)


def _E_PREPASS_MIN() -> int:
    """Survivor count above which align_survivors runs the E-bound
    score-only prepass; 0 (the default) disables it: its LDDT<=1 bound
    is too loose when forward scores are high (homolog-dense sets), so
    the extra full-profile sweep is rarely recovered.  Kept opt-in
    (RESEEK_E_PREPASS_MIN=N) for sparse-hit workloads where most
    survivors fail the E-gate on fwd alone; byte-parity is
    regression-tested with the prepass forced on."""
    return int(os.environ.get("RESEEK_E_PREPASS_MIN", "0"))
EDGE_SET = (128, 256, 512, 1024, 2048, 4096, 8192)
MU_SAT_LIMIT = 250.0      # parasail 8-bit: saturated iff score > 250
MU_SAT_SCORE = 777.0      # forced FWD score on saturation
MU_SAT_REV_SCORE = 255.0  # saturated REV keeps parasail's clamp (see
                          # align/pipeline.py MU_SAT_REV_SCORE note)


def _edges_for(params: DSSParams, lmax: int) -> Tuple[int, ...]:
    """Bucket edges: EDGE_SET trimmed to lmax.  All edges are powers of two
    >= 128, so the compiled shape set stays small; the device/host
    (full-SW vs MKF) routing boundary is NOT an edge — the
    sorted-by-length layout makes the device-eligible chains a contiguous
    PREFIX (clamped per bucket via dev_end), so misaligned mkfl values
    never force a misaligned kernel shape."""
    edges = sorted(e for e in EDGE_SET if e < lmax * 2)
    while edges and edges[-1] < lmax:
        edges.append(edges[-1] * 2)
    if not edges:
        edges = [-(-max(lmax, 8) // 128) * 128]
    out = []
    for e in edges:
        out.append(e)
        if e >= lmax:
            break
    return tuple(out)


def _batch_shape(n: int, le: int, cells: int, multiple: int = 1,
                 le_b: Optional[int] = None) -> int:
    """Per-launch batch size: the cell budget capped, but no larger than
    the next power of two >= n (so small jobs don't pad to huge compiled
    shapes; shape count per edge stays O(log)).  le_b gives the second
    edge of a rectangular shape (default: square)."""
    cap = max(8, cells // (le * (le_b if le_b is not None else le)))
    p = 8
    while p < n:
        p *= 2
    bs = min(cap, p)
    return -(-bs // multiple) * multiple


def shard_map_compat(f, mesh, in_specs, out_specs):
    """jax.shard_map with replication checking off (its check_vma cannot
    type the outputs of foreign-function calls inside shard_map)."""
    from jax import shard_map
    return shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                     check_vma=False)


def stage1_block_dims(lea: int, leb: int, na: int, nb: int
                      ) -> Tuple[int, int]:
    """(ca, cb) chains per stage-1 pair block for bucket edges lea x leb
    and bucket ranges of na x nb chains: powers of two within the
    STAGE1_CELLS budget, clamped to the ranges (the Mu kernel's batch is
    2 * ca * cb pairs, fwd and rev)."""
    budget = max(256, STAGE1_CELLS // (lea * leb))
    ca = 8
    while ca < min(64, na, budget):
        ca *= 2
    cb = 8
    while cb < min(512, nb, max(8, budget // ca)):
        cb *= 2
    return ca, cb


def _packbits_device(mask):
    """bool [..., M] -> uint8 [..., M//8] (M multiple of 8)."""
    import jax.numpy as jnp
    shape = mask.shape[:-1] + (mask.shape[-1] // 8, 8)
    w = jnp.asarray(np.array([1, 2, 4, 8, 16, 32, 64, 128], np.int32))
    b = mask.reshape(shape).astype(jnp.int32)
    return jnp.sum(b * w, axis=-1).astype(jnp.uint8)


def _stage1_body(lea: int, leb: int, ca: int, cb: int, open_: float,
                 ext: float, omega_fwd: float, omega: float, kernels: bool):
    """One (ca x cb) pair block of the self-search Mu filter; pair indices
    generated on device from range scalars.  The A side pads to its own
    bucket's edge and the B side to its (>=) bucket's edge —
    RECTANGULAR DP when the buckets differ (padding letter 36 scores
    NEG/2 and cannot change the integer-exact DP best).  Returns packed
    pass bits [ca*cb//8]."""
    import jax.numpy as jnp
    from reseek_tpu.ops.sw_sweep import mu_sw_scores

    o = np.float32(open_)
    e = np.float32(ext)

    def block(mu, mu_rev, mumx, a0, b0, a1, b1):
        n = mu.shape[0]
        ia = a0 + jnp.arange(ca)
        ib = b0 + jnp.arange(cb)
        va = ia < a1
        vb = ib < b1
        iac = jnp.clip(ia, 0, n - 1)
        ibc = jnp.clip(ib, 0, n - 1)
        idx_a = jnp.repeat(iac, cb)
        idx_b = jnp.tile(ibc, ca)
        a = mu[idx_a][:, :lea].astype(jnp.int32)
        ar = mu_rev[idx_a][:, :lea].astype(jnp.int32)
        b = mu[idx_b][:, :leb].astype(jnp.int32)
        # fwd and rev in one kernel launch ([2B] batch)
        both = mu_sw_scores(jnp.concatenate([a, ar]),
                            jnp.concatenate([b, b]), mumx, o, e, kernels)
        fwd, rev = both[: ca * cb], both[ca * cb:]
        fwd = jnp.where(fwd > MU_SAT_LIMIT, np.float32(MU_SAT_SCORE), fwd)
        rev = jnp.where(rev > MU_SAT_LIMIT,
                        np.float32(MU_SAT_REV_SCORE), rev)
        ok = (fwd >= np.float32(omega_fwd)) & \
            (fwd - rev >= np.float32(omega))
        # valid: in range and unordered pair emitted once (j >= i in
        # sorted index space; cross-bucket ranges are disjoint)
        valid = (jnp.repeat(va, cb) & jnp.tile(vb, ca)
                 & (jnp.repeat(ia, cb) <= jnp.tile(ib, ca)))
        return _packbits_device(ok & valid)

    return block


@functools.lru_cache(maxsize=None)
def _stage1_block_fn_multi(lea: int, leb: int, ca: int, cb: int, k: int,
                           open_: float, ext: float, omega_fwd: float,
                           omega: float, kernels: bool):
    """K stage-1 blocks in ONE dispatch: block starts are [k] vectors and
    lax.map runs the blocks sequentially on device (single dispatch +
    single fetch instead of one per block).  Memory stays one block
    (lax.map, not vmap).  Returns bits [k, ca*cb//8]."""
    import jax
    body = _stage1_body(lea, leb, ca, cb, open_, ext, omega_fwd, omega,
                        kernels)

    def multi(mu, mu_rev, mumx, a0v, b0v, a1v, b1v):
        def one(args):
            a0, b0, a1, b1 = args
            return body(mu, mu_rev, mumx, a0, b0, a1, b1)

        return jax.lax.map(one, (a0v, b0v, a1v, b1v))

    return jax.jit(multi)


@functools.lru_cache(maxsize=None)
def _stage1_block_fn_sharded(mesh, axis: str, lea: int, leb: int,
                             ca: int, cb: int, open_: float, ext: float,
                             omega_fwd: float, omega: float, kernels: bool):
    """Sharded stage-1: each mesh device runs one (ca x cb) block with its
    own (a0, b0) start (SURVEY §2.8 item 2 — DB pair blocks over the mesh
    replace the reference's thread work-stealing, src/runself.cpp:72-99).
    Block starts a0v/b0v are [n_dev] arrays sharded on `axis`; the DB
    arrays are replicated.  Returns bits [n_dev, ca*cb//8]."""
    import jax
    from jax.sharding import PartitionSpec as P
    body = _stage1_body(lea, leb, ca, cb, open_, ext, omega_fwd, omega,
                        kernels)

    def local(mu, mu_rev, mumx, a0v, b0v, a1, b1):
        return body(mu, mu_rev, mumx, a0v[0], b0v[0], a1[0], b1[0])[None]

    sm = shard_map_compat(
        local, mesh,
        in_specs=(P(), P(), P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis))
    return jax.jit(sm)


@functools.lru_cache(maxsize=None)
def _stage3_fn_sharded(mesh, axis: str, le: int, sizes: Tuple[int, ...],
                       open_: float, ext: float, kernels: bool):
    """Data-parallel survivor alignment: the pair batch is sharded on
    `axis`, the DB arrays are replicated; each device runs the identical
    fused kernel on its slice, so results are bit-equal to single-device
    (SURVEY §2.8 — on-chip batch parallelism over the mesh)."""
    import jax
    from jax.sharding import PartitionSpec as P
    body = _stage3_body(le, le, sizes, open_, ext, kernels)

    sm = shard_map_compat(
        body, mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P(axis)))
    return jax.jit(sm)


@functools.lru_cache(maxsize=None)
def _stage1_scores_multi(lea: int, leb: int, k: int, o: float,
                         e: float, kernels: bool):
    """K stage1_scores chunks in one launch (see _stage3_fn_multi)."""
    import jax
    from reseek_tpu.ops.sw_sweep import mu_scores_sweep

    def multi(mu, mu_rev, mumx, ia_k, ib_k):
        return jax.lax.map(
            lambda ab: mu_scores_sweep(mu, mu_rev, ab[0], ab[1], mumx,
                                       lea, leb, o, e, kernels),
            (ia_k, ib_k))

    return jax.jit(multi)


def _rect_edges(ea: np.ndarray, eb: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pair compiled DP shape: RECTANGULAR (A-edge x B-edge) when the
    sides differ by >= 2x — a 100x500 pair in a 512x512 square bucket is
    ~5x padding, and rectangles cut the 1k workload's stage-3 cells to
    ~65% — else the max-edge SQUARE (near-square rectangles would
    multiply compiled shapes for little saving).  RESEEK_RECT=0 forces
    all-square."""
    emax = np.maximum(ea, eb)
    if os.environ.get("RESEEK_RECT", "1") == "0":
        return emax, emax
    rect = emax >= 2 * np.minimum(ea, eb)
    return (np.where(rect, ea, emax).astype(ea.dtype),
            np.where(rect, eb, emax).astype(eb.dtype))


@functools.lru_cache(maxsize=None)
def _stage3_fn_multi(lea: int, leb: int, k: int, sizes: Tuple[int, ...],
                     open_: float, ext: float, kernels: bool):
    """K survivor chunks in ONE dispatch: idx arrays are [k, bs] and
    lax.map runs the fused align+LDDT body chunk-by-chunk on device
    (single dispatch + single fetch instead of one per chunk, which
    matters when stage 3 makes hundreds of chunks).  Memory stays one
    chunk (lax.map, not vmap)."""
    import jax
    body = _stage3_body(lea, leb, sizes, open_, ext, kernels)

    def multi(prof_db, coords_db, idx_a_k, idx_b_k, w, offsets):
        return jax.lax.map(
            lambda ab: body(prof_db, coords_db, ab[0], ab[1], w,
                            offsets),
            (idx_a_k, idx_b_k))

    return jax.jit(multi)


def _codes_slice(prof_db, idx, offsets, bucket: int, pad_code: int):
    """Gather + slice + flat-code profiles: [B, F, bucket] int32."""
    import jax.numpy as jnp
    p = prof_db[idx][:, :, :bucket].astype(jnp.int32)
    return jnp.where(p == PAD_BYTE, pad_code, p + offsets[None, :, None])


def _smx_onehot(codes_a, codes_b, w):
    """S[b,i,j] = sum_f w[ca[b,f,i], cb[b,f,j]] as two one-hot matmuls
    (not bit-exact: HIGHEST precision keeps it within ~1e-6 of the
    feature-ordered f32 adds)."""
    import jax
    import jax.numpy as jnp
    d = w.shape[0]

    def multihot(codes):
        # accumulate per feature to avoid materializing [B, F, L, D]
        out = jax.nn.one_hot(codes[:, 0], d, dtype=jnp.float32)
        for f in range(1, codes.shape[1]):
            out = out + jax.nn.one_hot(codes[:, f], d, dtype=jnp.float32)
        return out

    emb = jax.lax.dot_general(
        multihot(codes_a), w, dimension_numbers=(((2,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)
    return jax.lax.dot_general(
        emb, multihot(codes_b),
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST)


def _stage3_body(la: int, lb: int, sizes: Tuple[int, ...], open_: float,
                 ext: float, kernels: bool):
    """Fused survivor kernel: full-profile SW with traceback, path walk,
    aligned-column compaction, coordinate gather and LDDT.

    kernels=True runs the CUDA traceback kernel (ops/sw_cuda.py: the
    substitution scores are looked up in-kernel in the reference's
    feature order, bit-exact, and the walk runs in-kernel); else the
    plain wavefront (ops/sw_jax.py) over the one-hot-matmul substitution
    tensor and the lax.scan walk (ops/postalign_jax.py)."""
    import jax.numpy as jnp
    from reseek_tpu.ops.postalign_jax import (PD, PI, PM, lddt_batch,
                                              walk_traceback_batch)
    from reseek_tpu.ops.sw_cuda import (align_meta, align_table,
                                        profile_codes, sw_align_cuda)
    from reseek_tpu.ops.sw_jax import sw_traceback_batch

    o = np.float32(open_)
    e = np.float32(ext)
    m_cap = min(la, lb)
    pad_code = sum(sizes)
    meta = align_meta(sizes)

    def align(prof_db, idx_a, idx_b, w, offsets):
        if kernels:
            pa = profile_codes(prof_db[idx_a][:, :, :la], sizes, PAD_BYTE)
            pb = profile_codes(prof_db[idx_b][:, :, :lb], sizes, PAD_BYTE)
            return sw_align_cuda(pa, pb, align_table(w, sizes), meta,
                                 len(sizes), o, e)[:7]
        ca_ = _codes_slice(prof_db, idx_a, offsets, la, pad_code)
        cb_ = _codes_slice(prof_db, idx_b, offsets, lb, pad_code)
        best, bi, bj, tbs = sw_traceback_batch(_smx_onehot(ca_, cb_, w),
                                               o, e)
        return (best, bi, bj) + walk_traceback_batch(tbs, best, bi, bj)

    def run(prof_db, coords_db, idx_a, idx_b, w, offsets):
        best, bi, bj, lo_a, lo_b, plen, path_rev = align(
            prof_db, idx_a, idx_b, w, offsets)

        codes = path_rev  # [B, LA+LB], reversed from the alignment end
        is_m = codes == PM
        adv_a = is_m | (codes == PD)
        adv_b = is_m | (codes == PI)
        exc_a = jnp.cumsum(adv_a, axis=1) - adv_a
        exc_b = jnp.cumsum(adv_b, axis=1) - adv_b
        pos_a = bi[:, None] - exc_a
        pos_b = bj[:, None] - exc_b
        m_cum = jnp.cumsum(is_m, axis=1)
        n_m = m_cum[:, -1]
        rank_fwd = jnp.where(is_m, n_m[:, None] - m_cum, m_cap)
        bidx = jnp.arange(codes.shape[0])[:, None]
        cq_pos = jnp.zeros((codes.shape[0], m_cap + 1), jnp.int32) \
            .at[bidx, rank_fwd].set(pos_a)[:, :m_cap]
        ct_pos = jnp.zeros((codes.shape[0], m_cap + 1), jnp.int32) \
            .at[bidx, rank_fwd].set(pos_b)[:, :m_cap]
        cq = coords_db[idx_a[:, None], cq_pos]
        ct = coords_db[idx_b[:, None], ct_pos]
        valid = jnp.arange(m_cap)[None, :] < n_m[:, None]
        lddt, risky = lddt_batch(cq, ct, valid, n_m.astype(jnp.int32),
                                 with_risky=True)
        # pack per-pair scalars into ONE f32 array and the path codes into
        # ONE 2-bit-packed uint8 array: two fetches per job instead of
        # ten, and 4 path codes per fetched byte (all integer values here
        # are < 2^24, exact in f32; codes are 0..3)
        f32 = jnp.float32
        scal = jnp.stack(
            [best, lo_a.astype(f32), lo_b.astype(f32),
             bi.astype(f32), bj.astype(f32), plen.astype(f32),
             lddt, n_m.astype(f32), risky.astype(f32)], axis=1)
        pr = path_rev.astype(jnp.int32)
        plen4 = -(-pr.shape[1] // 4) * 4
        pr = jnp.pad(pr, ((0, 0), (0, plen4 - pr.shape[1])))
        pr = pr.reshape(pr.shape[0], plen4 // 4, 4)
        shifts = jnp.asarray(np.array([1, 4, 16, 64], np.int32))
        packed = jnp.sum(pr * shifts, axis=2).astype(jnp.uint8)
        return scal, packed

    return run


def _stage2_body(la: int, lb: int, pad_code: int, open_: float, ext: float):
    """Score-only full-profile SW prepass (two-phase stage 3, SURVEY §7
    "score-only everywhere + re-run traceback only for accepted hits").

    Uses the row sweep (ops/sw_sweep.py): LA sequential steps with every
    lane useful, vs LA+LB-1 wavefront steps at <=50% utilization.  Its
    float order differs from the reference by <~1e-3; callers gate with
    STAGE2_GUARD and let the bit-exact stage-3 kernel re-gate."""
    from reseek_tpu.ops.sw_sweep import sw_score_sweep

    o = np.float32(open_)
    e = np.float32(ext)

    def run(prof_a_db, prof_b_db, idx_a, idx_b, w, offsets):
        ca_ = _codes_slice(prof_a_db, idx_a, offsets, la, pad_code)
        cb_ = _codes_slice(prof_b_db, idx_b, offsets, lb, pad_code)
        return sw_score_sweep(_smx_onehot(ca_, cb_, w), o, e)

    return run


@functools.lru_cache(maxsize=None)
def _stage2_fn(le: int, pad_code: int, open_: float, ext: float):
    import jax
    return jax.jit(_stage2_body(le, le, pad_code, open_, ext))


@functools.lru_cache(maxsize=None)
def _stage2_fn_sharded(mesh, axis: str, le: int, pad_code: int,
                       open_: float, ext: float):
    """Data-parallel stage-2 scores: pair batch sharded on `axis`, DB
    replicated; bit-equal to single-device."""
    import jax
    from jax.sharding import PartitionSpec as P
    body = _stage2_body(le, le, pad_code, open_, ext)

    sm = shard_map_compat(
        body, mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(), P()),
        out_specs=P(axis))
    return jax.jit(sm)


def _exact_fwd_score(params: DSSParams, prof_a: np.ndarray,
                     prof_b: np.ndarray) -> float:
    """Bit-exact full-profile SW score on the host (native kernel,
    numpy replica fallback) — the boundary-case recompute path."""
    from reseek_tpu.ops.sw_native import sw_score_profile_native
    v = sw_score_profile_native(params, prof_a, prof_b)
    if v is not None:
        return v
    from reseek_tpu.ops.substmx import build_smx
    from reseek_tpu.ops.sw_np import sw_score
    return sw_score(build_smx(params, prof_a, prof_b),
                    params.gap_open, params.gap_ext)


def _vector_stats(fwd: np.ndarray, lddt: np.ndarray, sa: np.ndarray,
                  sb: np.ndarray, la: np.ndarray, lb: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized TS/P/E in the reference's float32 order
    (src/dssaligner.cpp:883-902 + src/statsig.cpp:27-50)."""
    from reseek_tpu.align.pipeline import FLT_MAX, _ts_value
    from reseek_tpu.constants import SCOP40C_DBSIZE, StatSig
    f32 = np.float32
    have = (sa != FLT_MAX) & (sb != FLT_MAX)
    rev_dp = np.where(have, (sa.astype(f32) + sb.astype(f32)) / f32(2),
                      f32(0.0)).astype(f32)
    ts = _ts_value(lddt.astype(f32), fwd.astype(f32), rev_dp, la, lb)
    tsd = ts.astype(np.float64)
    log10p = np.where(tsd < StatSig.X1, StatSig.M0 * tsd + StatSig.C0,
                      StatSig.M * tsd + StatSig.C)
    p = np.minimum(np.power(10.0, log10p), 1.0)
    return ts, p, p * SCOP40C_DBSIZE


_PATH_CHARS = np.zeros(4, np.uint8)
_PATH_CHARS[1:4] = [ord("M"), ord("D"), ord("I")]


class DeviceSelfSearch:
    """All-vs-all self search on the sorted-DB rectangular pipeline.

    Produces the hit set of src/runself.cpp + src/dssaligner.cpp for all
    pairs below the MKF routing threshold; callers handle long-chain
    (MKF) pairs on the host path and merge.
    """

    def __init__(self, ecs: List[EncodedChain], params: DSSParams,
                 with_rev_profiles: bool = True, mesh=None,
                 mesh_axis: str = "db"):
        import jax.numpy as jnp
        from reseek_tpu.encoder.dss import encode_chain
        from reseek_tpu.ops.smx_jax import flat_layout

        self.ecs = ecs
        self.params = params
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        lens = np.array([len(ec) for ec in ecs], np.int64)
        self.lens = lens
        self.order = np.argsort(lens, kind="stable")
        self.sorted_lens = lens[self.order]
        lmax = int(lens.max()) if len(lens) else 1
        self.edges = _edges_for(params, lmax)
        self.lmaxp = self.edges[-1]
        # bucket index per sorted position; contiguous ranges per bucket
        self.bucket_of = np.searchsorted(np.asarray(self.edges),
                                         self.sorted_lens)
        self.range_of = {}
        for bi in range(len(self.edges)):
            sel = np.flatnonzero(self.bucket_of == bi)
            if len(sel):
                self.range_of[bi] = (int(sel[0]), int(sel[-1]) + 1)
        # device-side routing limit: chains with length < mkfl take the
        # device path; sorted-by-length layout makes them the prefix
        # [0, dev_end) of the sorted index space, so per-bucket device
        # ranges are just clamped at dev_end (length >= mkfl chains route
        # to the host MKF path, src/dssaligner.cpp DoMKF)
        self.dev_end = int(np.searchsorted(self.sorted_lens, params.mkfl))

        offsets, d, w = flat_layout(params.features, params.weights)
        self.offsets = jnp.asarray(offsets.astype(np.int32))
        self.pad_code = int(d)
        self.w = jnp.asarray(w)
        self.mumx = jnp.asarray(_mu_matrix_padded())
        self.sizes = tuple(ALPHA_SIZES[f] for f in params.features)

        n = len(ecs)
        nf = len(params.features)
        L = self.lmaxp
        prof = np.full((n, nf, L), PAD_BYTE, np.uint8)
        mu = np.full((n, L), 36, np.uint8)
        mu_rev = np.full((n, L), 36, np.uint8)
        coords = np.zeros((n, L, 3), np.float32)
        for s, oi in enumerate(self.order):
            ec = ecs[oi]
            ln = min(len(ec), L)
            prof[s, :, :ln] = ec.profile[:, :ln]
            mu[s, :ln] = ec.mu_letters[:ln]
            mu_rev[s, :ln] = ec.mu_letters[:ln][::-1]
            coords[s, :ln] = ec.chain.coords[:ln]
        self.prof = jnp.asarray(prof)
        self.mu = jnp.asarray(mu)
        self.mu_rev = jnp.asarray(mu_rev)
        self.coords = jnp.asarray(coords)
        self.prof_rev = None
        # sorted index of each original index
        self.sorted_of = np.empty(n, np.int64)
        self.sorted_of[self.order] = np.arange(n)
        if with_rev_profiles:
            self.build_rev_profiles()

    def build_rev_profiles(self) -> None:
        """Encode + upload reversed-chain profiles (for self-rev scores).
        Separate from __init__ so drivers can run it concurrently with
        the stage-1 filter (the encode is CPU work; device upload is
        cheap)."""
        import jax.numpy as jnp
        from concurrent.futures import ThreadPoolExecutor

        from reseek_tpu.encoder.dss import encode_chain
        if self.prof_rev is not None:
            return
        params = self.params
        n = len(self.ecs)
        nf = len(params.features)
        L = self.lmaxp
        prof_rev = np.full((n, nf, L), PAD_BYTE, np.uint8)

        def rev_one(s_oi):
            s, oi = s_oi
            ec = self.ecs[oi]
            if len(ec) >= params.mkfl:
                return  # long chains take the host MKF selfrev path
            ln = min(len(ec), L)
            rp = encode_chain(ec.chain.reversed()).profile(params)
            prof_rev[s, :, :ln] = rp[:, :ln]

        with ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as tp:
            list(tp.map(rev_one, enumerate(self.order)))
        self.prof_rev = jnp.asarray(prof_rev)

    def _device_ranges(self):
        """(bucket_index, s0, s1) for each bucket's device-eligible
        (length < mkfl) sorted-index range, clamped at dev_end."""
        out = []
        for bi in range(len(self.edges)):
            if bi not in self.range_of:
                continue
            s0, s1 = self.range_of[bi]
            s1 = min(s1, self.dev_end)
            if s0 < s1:
                out.append((bi, s0, s1))
        return out

    # -- stage 1 on explicit pairs: Mu filter values ---------------------
    def stage1_scores(self, pairs_orig: np.ndarray) -> np.ndarray:
        """Mu filter value per (i, j) original-index pair: 0 if
        fwd < OmegaFwd else fwd - rev, with parasail saturation semantics
        (src/parasail_mu.cpp:120-161).  Integer-exact (matches the host
        mu_filter_score bit-for-bit).  Used by drivers that bring their
        own pair lists (query-vs-DB, fast-pipeline stage 2) instead of
        the all-vs-all block enumeration of stage1_survivors."""
        import jax
        import jax.numpy as jnp
        from reseek_tpu.ops.sw_sweep import mu_scores_sweep
        p = self.params
        out = np.zeros(len(pairs_orig), np.float32)
        if len(pairs_orig) == 0:
            return out
        o, e = -float(p.para_mu_gap_open), -float(p.para_mu_gap_ext)
        kernels = device.kernels("mu")
        edges = np.asarray(self.edges)

        def eof(lv):
            return edges[np.minimum(np.searchsorted(edges, lv),
                                    len(edges) - 1)]

        ra, rb = _rect_edges(eof(self.lens[pairs_orig[:, 0]]),
                             eof(self.lens[pairs_orig[:, 1]]))
        keys = ra.astype(np.int64) * (1 << 20) + rb
        jobs = []
        for key in sorted({int(x) for x in keys}):
            lea, leb = int(key >> 20), int(key & ((1 << 20) - 1))
            rows = np.flatnonzero(keys == key)
            bs = _batch_shape(len(rows), lea, STAGE1_CELLS // 2,
                              le_b=leb)
            # K chunks per launch (lax.map tiers) — same per-dispatch
            # latency amortization as align_survivors
            pend = []
            for kk in range(0, len(rows), bs):
                rr = rows[kk: kk + bs]
                chunk = pairs_orig[rr]
                n = len(chunk)
                if n < bs:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], bs - n, axis=0)])
                pend.append((rr, n, self.sorted_of[chunk[:, 0]],
                             self.sorted_of[chunk[:, 1]]))
            pos = 0
            for ktier in (16, 4, 1):
                fnm = None
                while len(pend) - pos >= ktier:
                    grp = pend[pos: pos + ktier]
                    pos += ktier
                    if fnm is None:
                        fnm = _stage1_scores_multi(lea, leb, ktier, o, e,
                                                   kernels)
                    ia = jnp.asarray(np.stack([g[2] for g in grp]))
                    ib = jnp.asarray(np.stack([g[3] for g in grp]))
                    r = fnm(self.mu, self.mu_rev, self.mumx, ia, ib)
                    jobs.append((r, [(g[0], g[1]) for g in grp]))
        fetched = jax.device_get([r for r, _ in jobs])
        for (fwd_k, rev_k), (_, metas) in zip(fetched, jobs):
            for t, (rr, n) in enumerate(metas):
                fwd = fwd_k[t][:n].copy()
                rev = rev_k[t][:n].copy()
                fwd[fwd > MU_SAT_LIMIT] = MU_SAT_SCORE
                rev[rev > MU_SAT_LIMIT] = MU_SAT_REV_SCORE
                val = fwd - rev
                val[fwd < np.float32(self.params.omega_fwd)] = 0.0
                out[rr] = val
        return out

    # -- stage 2: score-only full-profile SW -----------------------------
    def stage2_scores(self, pairs_orig: np.ndarray,
                      b_side_rev: bool = False,
                      exact: bool = False) -> np.ndarray:
        """Full-profile SW scores for (i, j) original-index pairs.

        Default path is the fast row-sweep kernel (float order differs
        from the reference by <~1e-3 — use with STAGE2_GUARD when gating);
        exact=True runs the bit-exact wavefront score kernel instead
        (needed when the score itself is reported, e.g. self-rev).
        b_side_rev scores against the reversed-chain profiles."""
        import jax
        import jax.numpy as jnp
        p = self.params
        out = np.zeros(len(pairs_orig), np.float32)
        if len(pairs_orig) == 0:
            return out
        prof_b = self.prof_rev if b_side_rev else self.prof
        edges = np.asarray(self.edges)
        be = edges[np.minimum(
            np.searchsorted(edges, np.maximum(self.lens[pairs_orig[:, 0]],
                                              self.lens[pairs_orig[:, 1]])),
            len(edges) - 1)]
        n_dev = self.mesh.devices.size if self.mesh is not None else 1
        k = _kernels() if exact else None
        jobs = []
        for le in sorted({int(x) for x in be}):
            rows = np.flatnonzero(be == le)
            bs = _batch_shape(
                len(rows), le, STAGE2_CELLS,
                n_dev if (self.mesh is not None and not exact) else 1)
            if self.mesh is not None and not exact:
                fn = _stage2_fn_sharded(
                    self.mesh, self.mesh_axis, le, self.pad_code,
                    float(p.gap_open), float(p.gap_ext))
            elif not exact:
                fn = _stage2_fn(le, self.pad_code, float(p.gap_open),
                                float(p.gap_ext))
            for kk in range(0, len(rows), bs):
                rr = rows[kk: kk + bs]
                chunk = pairs_orig[rr]
                n = len(chunk)
                if n < bs:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], bs - n, axis=0)])
                idx_a = jnp.asarray(self.sorted_of[chunk[:, 0]])
                idx_b = jnp.asarray(self.sorted_of[chunk[:, 1]])
                if exact:
                    r = k["stage2_full"](
                        self.prof, prof_b, idx_a, idx_b, self.w,
                        self.offsets, self.pad_code, le,
                        float(p.gap_open), float(p.gap_ext))
                else:
                    r = fn(self.prof, prof_b, idx_a, idx_b,
                           self.w, self.offsets)
                jobs.append((r, rr, n))
        fetched = jax.device_get([r for r, _, _ in jobs])
        for sc, (_, rr, n) in zip(fetched, jobs):
            out[rr] = sc[:n]
        return out

    # -- self-reversal scores (src/alignpair.cpp:7-25), device part ------
    def self_rev_scores_device(self) -> np.ndarray:
        """Scores for chains below mkfl (others: host MKF quirk path);
        returns array indexed by ORIGINAL chain index (NaN where host).
        Runs on the bit-exact stage-2 kernel over the same fixed batch
        shapes as the pair stages (one compiled shape family)."""
        out = np.full(len(self.ecs), np.nan, np.float32)
        idx = []
        for bi, s0, s1 in self._device_ranges():
            idx.extend(self.order[s0:s1].tolist())
        if not idx:
            return out
        pairs = np.stack([np.asarray(idx)] * 2, axis=1)
        out[np.asarray(idx)] = self.stage2_scores(pairs, b_side_rev=True,
                                                  exact=True)
        return out

    # -- stage 1: Mu filter bits over all device pairs -------------------
    def stage1_block_plan(self) -> "Dict[Tuple[int, int, int], list]":
        """Stage-1 launch plan: {(le, ca, cb): [(ba, bb, a1, b1), ...]} —
        every (ca x cb) pair block over the device-eligible bucket ranges,
        grouped by compiled shape.  Blocks from different bucket
        combinations share (le, ca, cb), so one lax.map kernel runs a
        whole group in a single launch.  Block dims clamp to the range
        sizes (pow2) so tiny buckets don't pad to full blocks
        (stage1_block_dims)."""
        groups: Dict[Tuple[int, int, int, int], list] = {}
        dev = self._device_ranges()
        for ai, a0, a1 in dev:
            for bi_, b0, b1 in dev:
                if bi_ < ai:
                    continue
                # rectangular (A-bucket x B-bucket) DP when the buckets
                # differ >= 2x (see _rect_edges); else the B bucket's
                # square — cuts the 1k workload's stage-1 cells ~35%
                lea_a, leb_a = _rect_edges(
                    np.array([self.edges[ai]]),
                    np.array([self.edges[bi_]]))
                lea, leb = int(lea_a[0]), int(leb_a[0])
                ca, cb = stage1_block_dims(lea, leb, a1 - a0, b1 - b0)
                for ba in range(a0, a1, ca):
                    for bb in range(b0, b1, cb):
                        if bb + cb > ba:  # skip below-diagonal blocks
                            groups.setdefault((lea, leb, ca, cb),
                                              []).append(
                                (ba, bb, a1, b1))
        return groups

    def stage1_survivors(self) -> np.ndarray:
        """(i, j) ORIGINAL-index pairs (i <= j) passing the Mu filter, for
        all pairs with both chains below mkfl.  With omega == 0 the filter
        is off and all such pairs survive (src/dssaligner.cpp:819-828)."""
        import jax.numpy as jnp
        p = self.params
        o, e = -float(p.para_mu_gap_open), -float(p.para_mu_gap_ext)
        dev = self._device_ranges()
        pair_chunks = []
        if p.omega <= 0:
            for ai, a0, a1 in dev:
                for bi_, b0, b1 in dev:
                    if bi_ < ai:
                        continue
                    ia, ib = np.meshgrid(np.arange(a0, a1),
                                         np.arange(b0, b1), indexing="ij")
                    keep = ib >= ia
                    pair_chunks.append(
                        np.stack([ia[keep], ib[keep]], axis=1))
        else:
            import jax.numpy as jnp
            n_dev = self.mesh.devices.size if self.mesh is not None else 1
            kernels = device.kernels("mu")
            jobs = []  # (handle, [(ba, bb)] per row, ca, cb)
            groups = self.stage1_block_plan()
            for (lea, leb, ca, cb), starts in groups.items():
                if self.mesh is None:
                    # launch in FIXED k tiers (not pow2-of-count): the
                    # compiled shape set stays identical across workload
                    # sizes, so the persistent compile cache keeps
                    # warmups bounded.  The last sub-64 group pads up to
                    # its tier with a1 = b1 = 0 blocks (every candidate
                    # fails the range check, contributing no pairs).
                    pos = 0
                    while pos < len(starts):
                        for ktier in (64, 16, 4, 1):
                            if (len(starts) - pos >= ktier
                                    or ktier == 1):
                                break
                        grp = starts[pos: pos + ktier]
                        pos += ktier
                        pad = ktier - len(grp)
                        fn = _stage1_block_fn_multi(
                            lea, leb, ca, cb, ktier, o, e,
                            float(p.omega_fwd), float(p.omega), kernels)
                        av = np.array([s[0] for s in grp] + [0] * pad,
                                      np.int32)
                        bv = np.array([s[1] for s in grp] + [0] * pad,
                                      np.int32)
                        a1v = np.array([s[2] for s in grp] + [0] * pad,
                                       np.int32)
                        b1v = np.array([s[3] for s in grp] + [0] * pad,
                                       np.int32)
                        r = fn(self.mu, self.mu_rev, self.mumx,
                               jnp.asarray(av), jnp.asarray(bv),
                               jnp.asarray(a1v), jnp.asarray(b1v))
                        jobs.append((r, [(s[0], s[1]) for s in grp],
                                     ca, cb))
                else:
                    fn = _stage1_block_fn_sharded(
                        self.mesh, self.mesh_axis, lea, leb, ca, cb,
                        o, e, float(p.omega_fwd), float(p.omega), kernels)
                    for g in range(0, len(starts), n_dev):
                        grp = starts[g: g + n_dev]
                        pad = n_dev - len(grp)
                        av = np.array([s[0] for s in grp] + [0] * pad,
                                      np.int32)
                        bv = np.array([s[1] for s in grp] + [0] * pad,
                                      np.int32)
                        a1v = np.array([s[2] for s in grp] + [0] * pad,
                                       np.int32)
                        b1v = np.array([s[3] for s in grp] + [0] * pad,
                                       np.int32)
                        r = fn(self.mu, self.mu_rev, self.mumx,
                               jnp.asarray(av), jnp.asarray(bv),
                               jnp.asarray(a1v), jnp.asarray(b1v))
                        jobs.append((r, [(s[0], s[1]) for s in grp],
                                     ca, cb))
            import jax
            fetched_bits = jax.device_get([r for r, _, _, _ in jobs])
            for bits, (_, grp, ca, cb) in zip(fetched_bits, jobs):
                # bits: [rows, ca*cb//8]
                flat = np.unpackbits(bits[: len(grp)], axis=-1,
                                     bitorder="little")
                for s, (ba, bb) in enumerate(grp):
                    m = flat[s].reshape(ca, cb)
                    ia_r, ib_r = np.nonzero(m)
                    if not len(ia_r):
                        continue
                    pair_chunks.append(
                        np.stack([ba + ia_r, bb + ib_r], axis=1))
        if not pair_chunks:
            return np.zeros((0, 2), np.int64)
        sp = np.concatenate(pair_chunks)
        # map sorted -> original, orient (min, max) by ORIGINAL index (the
        # reference aligns query=i, target=j with i <= j, src/runself.cpp)
        oi = self.order[sp[:, 0]]
        oj = self.order[sp[:, 1]]
        lo = np.minimum(oi, oj)
        hi = np.maximum(oi, oj)
        out = np.stack([lo, hi], axis=1)
        return out[np.lexsort((out[:, 1], out[:, 0]))]

    # -- stage 3: fused align + LDDT on survivors ------------------------
    def align_survivors(self, pairs_orig: np.ndarray,
                        need_all_paths: bool = False,
                        fwd_prefilter: bool = False,
                        evalue_gate: Optional[float] = None,
                        fwd_displayed: bool = True):
        """Full alignment of (i, j) original-index pairs.  Returns a dict
        {(i, j): AlignResult} including only alignments with a path.

        fwd_displayed: whether the caller will DISPLAY the raw forward
        score (dpscore %.4g / raw %.3g columns).  When False, the
        display-boundary check on fwd is skipped, so only gate/stat
        boundaries can trigger the exact native-SW recompute — on
        hit-dense workloads that check dominates the host finish.

        fwd_prefilter enables a two-phase mode (SURVEY §7): a score-only
        prepass drops pairs that cannot reach MinFwdScore (reference gate
        src/dssaligner.cpp:852-860 — such pairs never get an E-value, so
        the E-gate rejects their rows); the fused traceback+LDDT kernel
        runs only on the rest.  Worth it only when survival is sparse:
        on Omega-filtered self-search ~98% of Mu survivors pass
        MinFwdScore (measured on q100), so the prepass would only add a
        pass.  Ignored when need_all_paths (E-gate off: rows without
        E-values are emitted, every path is needed)."""
        import jax.numpy as jnp
        p = self.params
        results: Dict[Tuple[int, int], AlignResult] = {}
        if len(pairs_orig) == 0:
            return results
        if fwd_prefilter and p.min_fwd_score > 0 and not need_all_paths:
            pre = self.stage2_scores(pairs_orig)
            pairs_orig = pairs_orig[
                pre >= np.float32(p.min_fwd_score) - STAGE2_GUARD]
            if len(pairs_orig) == 0:
                return results
        _epm = _E_PREPASS_MIN()
        if (evalue_gate is not None and not need_all_paths
                and _epm > 0 and len(pairs_orig) >= _epm):
            # E-bound prepass: the fused traceback+LDDT kernel costs more
            # per cell than the score-only sweep, and on hit-dense
            # workloads most survivors are later rejected by the E-gate
            # (1k chains: 84,671 -> 13,406).  TS is monotone in both fwd
            # and LDDT, so stats at (sweep_fwd + GUARD, LDDT = 1.0) give
            # a rigorous LOWER bound on any pair's final E-value; pairs
            # whose best-possible E still exceeds the gate can never
            # emit a row and skip the traceback kernel entirely.  The
            # relative margin covers f32 ulp wobble in the stat chain
            # (the 0.5-score guard alone adds ~3e-3 ts slack, >> ulp).
            pre = self.stage2_scores(pairs_orig)
            sa_p = np.array([self.ecs[i].self_rev_score
                             for i in pairs_orig[:, 0]], np.float32)
            sb_p = np.array([self.ecs[j].self_rev_score
                             for j in pairs_orig[:, 1]], np.float32)
            _, _, ev_min = _vector_stats(
                pre + STAGE2_GUARD, np.ones(len(pre), np.float32),
                sa_p, sb_p, self.lens[pairs_orig[:, 0]],
                self.lens[pairs_orig[:, 1]])
            pairs_orig = pairs_orig[
                ev_min <= np.float32(evalue_gate) * np.float32(1.0001)]
            if len(pairs_orig) == 0:
                return results
        from reseek_tpu.ops.sw_cuda import align_supported
        kernels = (device.kernels("align")
                   and align_supported(p.features))
        edges = np.asarray(self.edges)

        def eof(lv):
            return edges[np.minimum(np.searchsorted(edges, lv),
                                    len(edges) - 1)]

        ea = eof(self.lens[pairs_orig[:, 0]])
        eb = eof(self.lens[pairs_orig[:, 1]])
        if self.mesh is not None:
            # mesh path keeps max-edge squares (one sharded shape/edge)
            ra = rb = np.maximum(ea, eb)
        else:
            ra, rb = _rect_edges(ea, eb)
        keys = ra.astype(np.int64) * (1 << 20) + rb
        n_dev = self.mesh.devices.size if self.mesh is not None else 1
        jobs = []
        for key in sorted({int(x) for x in keys}):
            lea, leb = key >> 20, key & ((1 << 20) - 1)
            le = max(lea, leb)
            rows = np.flatnonzero(keys == key)
            bs = _batch_shape(len(rows), lea, STAGE3_CELLS,
                              n_dev if self.mesh is not None else 1,
                              le_b=leb)
            if self.mesh is not None:
                fn = _stage3_fn_sharded(
                    self.mesh, self.mesh_axis, le, self.sizes,
                    float(p.gap_open), float(p.gap_ext), kernels)
                for kk in range(0, len(rows), bs):
                    rr = rows[kk: kk + bs]
                    chunk = pairs_orig[rr]
                    n = len(chunk)
                    if n < bs:
                        chunk = np.concatenate(
                            [chunk,
                             np.repeat(chunk[-1:], bs - n, axis=0)])
                    idx_a = jnp.asarray(self.sorted_of[chunk[:, 0]])
                    idx_b = jnp.asarray(self.sorted_of[chunk[:, 1]])
                    r = fn(self.prof, self.coords, idx_a, idx_b,
                           self.w, self.offsets)
                    jobs.append((r, [(rr, chunk[:n])]))
            else:
                # single device: K chunks per dispatch via lax.map tiers
                # (the tiers keep their values; to be tuned on the H100)
                pend = []
                for kk in range(0, len(rows), bs):
                    rr = rows[kk: kk + bs]
                    chunk = pairs_orig[rr]
                    n = len(chunk)
                    if n < bs:
                        chunk = np.concatenate(
                            [chunk,
                             np.repeat(chunk[-1:], bs - n, axis=0)])
                    pend.append((rr, chunk[:n],
                                 self.sorted_of[chunk[:, 0]],
                                 self.sorted_of[chunk[:, 1]]))
                pos = 0
                for ktier in (16, 4, 1):
                    fnm = None
                    while len(pend) - pos >= ktier:
                        grp = pend[pos: pos + ktier]
                        pos += ktier
                        if fnm is None:
                            fnm = _stage3_fn_multi(
                                int(lea), int(leb), ktier, self.sizes,
                                float(p.gap_open), float(p.gap_ext),
                                kernels)
                        ia = jnp.asarray(np.stack([g[2] for g in grp]))
                        ib = jnp.asarray(np.stack([g[3] for g in grp]))
                        r = fnm(self.prof, self.coords, ia, ib,
                                self.w, self.offsets)
                        jobs.append((r, [(g[0], g[1]) for g in grp]))
        # one batched fetch for every job's packed outputs
        import jax
        fetched = jax.device_get([r for r, _ in jobs])
        flat = []
        for (scal_all, packed_all), (_, metas) in zip(fetched, jobs):
            if scal_all.ndim == 2:  # sharded per-chunk launch
                flat.append((scal_all, packed_all) + metas[0])
            else:                   # stacked multi-chunk launch
                for t, (rr_t, chunk_t) in enumerate(metas):
                    flat.append((scal_all[t], packed_all[t], rr_t,
                                 chunk_t))
        for scal, packed, rr, chunk in flat:
            best, lo_a, lo_b, hi_a, hi_b, plen, lddt, n_m, risky = (
                scal[:, 0], scal[:, 1].astype(np.int64),
                scal[:, 2].astype(np.int64), scal[:, 3].astype(np.int64),
                scal[:, 4].astype(np.int64), scal[:, 5].astype(np.int64),
                scal[:, 6], scal[:, 7].astype(np.int64),
                scal[:, 8].astype(bool))
            # unpack the 2-bit path codes (4 per byte, little-end first)
            pk = packed.astype(np.uint8)
            path_rev = np.empty((pk.shape[0], pk.shape[1] * 4), np.uint8)
            path_rev[:, 0::4] = pk & 3
            path_rev[:, 1::4] = (pk >> 2) & 3
            path_rev[:, 2::4] = (pk >> 4) & 3
            path_rev[:, 3::4] = (pk >> 6) & 3
            n = len(rr)
            sa = np.array([self.ecs[i].self_rev_score for i in chunk[:, 0]],
                          np.float32)
            sb = np.array([self.ecs[j].self_rev_score for j in chunk[:, 1]],
                          np.float32)
            la_v = self.lens[chunk[:, 0]]
            lb_v = self.lens[chunk[:, 1]]
            # display-band check: device values may carry tiny
            # non-boundary rounding (LDDT: device sqrt/division and sum
            # order <~3e-7; FWD: on the plain path the one-hot
            # HIGHEST-precision smx matmul deviates <~1e-6 relative from
            # the feature-ordered f32 adds, the CUDA kernel is exact).
            # Recompute on host any pair
            # whose displayed/gated values could change within the bands
            # (exact host kernels: native SW + native LDDT).
            # two independent recompute flags, each priced separately:
            #   lddt_rec — device LDDT near a threshold/display boundary
            #              -> exact native LDDT (~0.3 ms/pair)
            #   fwd_rec  — device one-hot-smx FWD near a display or
            #              MinFwdScore gate boundary -> exact native SW
            #              (~2 ms/pair; rare — ts is ~1e-3 sensitive per
            #              unit fwd, so the fband almost never spans a
            #              %.3g boundary)
            lddt_rec = risky[:n].copy()
            fwd_rec = np.zeros(n, bool)
            band = np.float32(1e-6)
            fband = (np.float32(2e-5)
                     * np.maximum(np.abs(best[:n]), np.float32(1.0)))
            tsl_lo, pvl_lo, evl_lo = _vector_stats(
                best[:n], np.maximum(lddt[:n] - band, 0),
                sa, sb, la_v, lb_v)
            tsl_hi, pvl_hi, evl_hi = _vector_stats(
                best[:n], lddt[:n] + band, sa, sb, la_v, lb_v)
            tsf_lo, pvf_lo, evf_lo = _vector_stats(
                best[:n] - fband, lddt[:n], sa, sb, la_v, lb_v)
            tsf_hi, pvf_hi, evf_hi = _vector_stats(
                best[:n] + fband, lddt[:n], sa, sb, la_v, lb_v)
            # MinFwdScore gate boundary (src/dssaligner.cpp:852-860)
            fwd_rec |= (np.abs(best[:n] - np.float32(p.min_fwd_score))
                        <= fband)
            # E-gate fast reject: ts is increasing in both fwd and lddt,
            # so stats at (best+fband, lddt+band) bound the smallest
            # E-value any in-band exact value could produce; pairs whose
            # best-case E still exceeds the caller's emit gate can never
            # produce a row — skip their stats, recomputes and display
            # checks entirely (the emitter rejects res without E).
            skip = np.zeros(n, bool)
            if evalue_gate is not None:
                _, _, ev_hh = _vector_stats(
                    best[:n] + fband, lddt[:n] + band, sa, sb,
                    la_v, lb_v)
                skip = ev_hh > evalue_gate
            for kk in range(n):
                if skip[kk]:
                    continue
                if ("%.3g" % pvl_lo[kk] != "%.3g" % pvl_hi[kk]
                        or "%.3g" % evl_lo[kk] != "%.3g" % evl_hi[kk]
                        or "%.3g" % tsl_lo[kk] != "%.3g" % tsl_hi[kk]
                        or "%.4g" % np.float32(lddt[kk] - band)
                        != "%.4g" % np.float32(lddt[kk] + band)):
                    lddt_rec[kk] = True
                if ("%.3g" % pvf_lo[kk] != "%.3g" % pvf_hi[kk]
                        or "%.3g" % evf_lo[kk] != "%.3g" % evf_hi[kk]
                        or "%.3g" % tsf_lo[kk] != "%.3g" % tsf_hi[kk]):
                    fwd_rec[kk] = True
                elif fwd_displayed and (
                        # dpscore %.4g / raw %.3g display boundaries
                        # (align/output.py:140-142)
                        "%.4g" % np.float32(best[kk] - fband[kk])
                        != "%.4g" % np.float32(best[kk] + fband[kk])
                        or "%.3g" % np.float32(best[kk] - fband[kk])
                        != "%.3g" % np.float32(best[kk] + fband[kk])):
                    fwd_rec[kk] = True
            ts, pv, ev = _vector_stats(best[:n], lddt[:n], sa, sb,
                                       la_v, lb_v)
            for kk in range(n):
                if best[kk] <= 0 or skip[kk]:
                    # no alignment, or best-case E already above the emit
                    # gate: the emitter would reject the row either way,
                    # so skip even the path decode / result construction
                    continue
                i, j = int(chunk[kk, 0]), int(chunk[kk, 1])
                codes = path_rev[kk, :plen[kk]][::-1]
                path = _PATH_CHARS[codes].tobytes().decode()
                res = AlignResult(
                    query=self.ecs[i].label, target=self.ecs[j].label,
                    fwd_score=float(best[kk]), lo_a=int(lo_a[kk]),
                    lo_b=int(lo_b[kk]), path=path)
                gate_fwd = np.float32(best[kk])
                if fwd_rec[kk]:
                    gate_fwd = np.float32(_exact_fwd_score(
                        p, self.ecs[i].profile, self.ecs[j].profile))
                    res.fwd_score = float(gate_fwd)
                if gate_fwd >= p.min_fwd_score:
                    res.hi_a = int(hi_a[kk])
                    res.hi_b = int(hi_b[kk])
                    res.ids = int(n_m[kk])
                    res.gaps = int(plen[kk]) - int(n_m[kk])
                    if lddt_rec[kk] or fwd_rec[kk]:
                        lddt_val = np.float32(lddt[kk])
                        if lddt_rec[kk]:
                            from reseek_tpu.align.pipeline import \
                                _path_positions
                            from reseek_tpu.ops.lddt import lddt_mu_fast
                            pos_q, pos_t = _path_positions(
                                res.lo_a, res.lo_b, path)
                            lddt_val = np.float32(lddt_mu_fast(
                                self.ecs[i].chain.coords,
                                self.ecs[j].chain.coords, pos_q, pos_t))
                        tse, pve, eve = _vector_stats(
                            np.float32([gate_fwd]),
                            np.float32([lddt_val]),
                            sa[kk:kk + 1], sb[kk:kk + 1],
                            la_v[kk:kk + 1], lb_v[kk:kk + 1])
                        res.lddt = float(lddt_val)
                        res.ts = float(tse[0])
                        res.pvalue = float(pve[0])
                        res.evalue = float(eve[0])
                    else:
                        res.lddt = float(lddt[kk])
                        res.ts = float(ts[kk])
                        res.pvalue = float(pv[kk])
                        res.evalue = float(ev[kk])
                    res.qual = StatSig.qual(res.ts)
                results[(i, j)] = res
        return results


def batched_self_search(ecs: List[EncodedChain], params: DSSParams,
                        max_evalue: float = 10.0,
                        db: Optional[DeviceDB] = None,
                        skip_pair=None,
                        skipped: Optional[list] = None,
                        kept_pairs: Optional[list] = None
                        ) -> List[AlignResult]:
    """All-vs-all via the staged device pipeline (pair emitted once).

    skip_pair(i, j) -> True routes a pair away from the device engine
    (collected into `skipped`, e.g. for the host MKF long-chain path).
    When kept_pairs is given it receives the (i, j) tuple of each
    returned result, in result order."""
    if db is None:
        db = DeviceDB(ecs, params, with_rev_profiles=False)
    eng = BatchedEngine(db)
    n = len(ecs)
    iu = np.triu_indices(n)
    pairs = np.stack(iu, axis=1).astype(np.int64)
    if skip_pair is not None:
        mask = np.array([skip_pair(int(i), int(j)) for i, j in pairs])
        if skipped is not None:
            skipped.extend((int(i), int(j)) for i, j in pairs[mask])
        pairs = pairs[~mask]
    if params.omega > 0:
        mu = eng.mu_filter_scores(pairs)
        pairs = pairs[mu >= params.omega]
    if len(pairs) == 0:
        return []
    fwd = eng.full_scores(pairs)
    pairs = pairs[fwd >= params.min_fwd_score]
    if len(pairs) == 0:
        return []
    results = eng.full_alignments(pairs)
    out = []
    for pr, r in zip(pairs, results):
        if r is not None and r.path and r.evalue <= max_evalue:
            out.append(r)
            if kept_pairs is not None:
                kept_pairs.append((int(pr[0]), int(pr[1])))
    return out
