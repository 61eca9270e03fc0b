"""Command-line interface.

Covers the reference's user-facing command surface (README.md:29-105,
src/cmds.h): convert, search (self / query-vs-DB / prefiltered), alignpair,
pdb2ss, bca_stats, plus encode utilities.

Usage:  python -m reseek_tpu <command> [args]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np


def _add_mode_args(p: argparse.ArgumentParser) -> None:
    g = p.add_mutually_exclusive_group()
    g.add_argument("--fast", action="store_true")
    g.add_argument("--sensitive", action="store_true")
    g.add_argument("--verysensitive", action="store_true")


def _mode_from_args(args, default: Optional[str] = None) -> str:
    if args.fast:
        return "fast"
    if args.sensitive:
        return "sensitive"
    if args.verysensitive:
        return "verysensitive"
    if default is None:
        raise SystemExit("Must set --fast, --sensitive or --verysensitive")
    return default


def cmd_convert(args) -> int:
    """Format conversion with the reference's chain filters
    (src/convert.cpp:110-199: -reverse, -flip, label set, -minchainlength,
    -subsample N keeps every Nth input chain)."""
    from reseek_tpu.encoder.dss import encode_chain, feature_string
    from reseek_tpu.io.bca import BCAWriter
    from reseek_tpu.io.cal import write_cal
    from reseek_tpu.io.reader import read_chains

    label_set = None
    if args.labels:
        with open(args.labels) as f:
            label_set = {line.strip().upper() for line in f if line.strip()}

    from reseek_tpu.chain import Chain
    chains = []
    for i, c in enumerate(read_chains(args.input), 1):
        if args.reverse:
            # in-place Reverse() keeps the label (src/pdbchain.cpp:470-483)
            c = Chain(c.label, c.seq[::-1], c.coords[::-1].copy())
        if args.flip:
            c = c.flipped()
        if label_set is not None and c.label.upper() not in label_set:
            continue
        if args.minchainlength and len(c) < args.minchainlength:
            continue
        if args.subsample and i % args.subsample != 0:
            continue
        chains.append(c)
    if args.bca:
        with BCAWriter(args.bca) as w:
            for c in chains:
                w.write_chain(c)
    if args.cal:
        with open(args.cal, "w") as f:
            write_cal(chains, f)
    if args.fasta:
        from reseek_tpu.io.mufasta import seq_to_fasta
        with open(args.fasta, "w") as f:
            for c in chains:
                seq_to_fasta(f, c.label, c.seq)
    if args.pdb:
        # multi-PDB: MODEL/TITLE/ENDMDL per chain (src/convert.cpp:169-182)
        from reseek_tpu.io.pdb import write_pdb
        with open(args.pdb, "w") as f:
            for k, c in enumerate(chains):
                f.write("MODEL%10u\n" % k)
                f.write("TITLE     %s\n" % (c.label or "_blank_%u" % k))
                write_pdb(c, f)
                f.write("ENDMDL\n")
    if args.feature_fasta:
        from reseek_tpu.io.mufasta import seq_to_fasta
        with open(args.feature_fasta, "w") as f:
            for c in chains:
                seq_to_fasta(f, c.label,
                             feature_string(encode_chain(c), args.alpha))
    if args.index:
        from reseek_tpu.io.artifact import write_artifact
        modes = [m for m in args.index_modes.split(",") if m]
        write_artifact(args.index, chains, modes=modes,
                       progress=lambda i, n: print(
                           f"\rindexed {i}/{n} chains", end="",
                           file=sys.stderr))
        print(file=sys.stderr)
    print(f"{len(chains)} chains converted", file=sys.stderr)
    return 0


def _read_chains_or_artifact(path: str, params):
    """A .rsdx path loads pre-encoded chains (skipping all DSS work);
    anything else parses structures (src/search.cpp:96-99 -dbmu role)."""
    from reseek_tpu.io.artifact import is_artifact, load_artifact
    from reseek_tpu.io.reader import read_chains
    if is_artifact(path):
        return load_artifact(path, params, mode=params.mode)
    return read_chains(path)


def cmd_search(args) -> int:
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.reader import read_chains
    from reseek_tpu.search.driver import (SearchOptions, query_search,
                                          self_search)

    mode = _mode_from_args(args)
    if args.params:
        params = DSSParams.from_tsv(args.params)
        params.mode = mode
    elif args.paramstr:
        params = DSSParams.from_param_str(args.paramstr)
        params.mode = mode
    else:
        params = DSSParams.create(mode)
    if args.omega is not None:
        params.omega = args.omega
    if args.minfwdscore is not None:
        params.min_fwd_score = args.minfwdscore
    # positive-penalty convention on the command line (reference usage.h)
    if args.gapopen is not None:
        params.gap_open = -abs(args.gapopen)
    if args.gapext is not None:
        params.gap_ext = -abs(args.gapext)
    # NOTE: like the reference binary, -dbsize is accepted but the E-value
    # always uses SCOP40c_DBSIZE=8340 (src/statsig.h:3; the only consumer
    # of -dbsize is cmd_postmufilter's assert, src/postmufilter.cpp:317)

    from reseek_tpu.utils.logger import open_log
    lg = open_log(args.log)

    columns = parse_columns(args.columns)
    max_e = args.evalue if args.evalue is not None else (
        float("inf") if mode == "verysensitive" else 10.0)
    trace = ((args.label1, args.label2)
             if args.label1 and args.label2 else None)
    options = SearchOptions(columns=columns, max_evalue=max_e,
                            no_self=args.noself, mode=mode,
                            global_aln=args.global_aln,
                            scores_are_not_evalues=args.scores_are_not_evalues,
                            trace_labels=trace)

    out = open(args.output, "w") if args.output else sys.stdout
    aln = open(args.aln, "w") if args.aln else None
    options.aln_out = aln
    try:
        chains = _read_chains_or_artifact(args.input, params)
        if args.db and mode == "fast" and args.nprocs > 1:
            # multi-host pipeline: every host runs this same command with
            # its own --procid; rank 0 writes the merged output
            # (parallel/multihost.py steps 1-4)
            import os as _os
            import tempfile
            from reseek_tpu.parallel.multihost import (
                distributed_fast_search, init_distributed)
            pf_mode = ("idxq" if args.idxq
                       else "idxt" if args.idxt else None)
            pid, _n = init_distributed(
                coordinator=args.coord
                or _os.environ.get("JAX_COORDINATOR_ADDRESS"),
                num_processes=args.nprocs,
                process_id=args.procid if args.procid is not None
                else int(_os.environ.get("JAX_PROCESS_ID", "0")),
                local_device_ids=(
                    [int(x) for x in args.local_device_ids.split(",")]
                    if args.local_device_ids else None))
            scratch = args.scratch or (
                _os.path.dirname(_os.path.abspath(args.output))
                if args.output else tempfile.gettempdir())
            drv = distributed_fast_search(
                chains, args.db, options, out if pid == 0 else None,
                scratch_dir=scratch, dbmu=args.dbmu,
                prefilter_mode=pf_mode, resume=args.resume,
                engine=args.engine)
        elif args.db and mode == "fast":
            from reseek_tpu.search.driver import fast_search
            pf_mode = ("idxq" if args.idxq
                       else "idxt" if args.idxt else None)
            drv = fast_search(chains, args.db, params, options, out,
                              dbmu=args.dbmu, engine=args.engine,
                              prefilter_mode=pf_mode)
        elif args.db:
            from reseek_tpu.io.artifact import is_artifact
            # plain structure files stream (memory O(queries + chunk),
            # src/runquery.cpp); .rsdx artifacts load pre-encoded
            db_chains = (_read_chains_or_artifact(args.db, params)
                         if is_artifact(args.db) else args.db)
            drv = query_search(chains, db_chains, params, options, out,
                               engine=args.engine)
        else:
            drv = self_search(chains, params, options, out,
                              engine=args.engine)
        drv.run_stats(n_threads=max(1, args.threads))
    finally:
        if args.output:
            out.close()
        if aln:
            aln.close()
    return 0


def cmd_align_bag(args) -> int:
    """-align_bag (src/align_bag.cpp:49-94): align exactly one chain
    from each of two files through the MKF bag path (sensitive, UsePara
    off, Omega 0) and print the pretty alignment."""
    from reseek_tpu.align.mkf import align_mkf
    from reseek_tpu.align.pipeline import encode_for_search
    from reseek_tpu.align.prettyaln import pretty_aln
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.reader import read_chains

    params = DSSParams.create("sensitive")
    params.use_para = False
    params.omega = 0.0
    qs = read_chains(args.input)
    ts = read_chains(args.input2)
    if len(qs) != 1 or len(ts) != 1:
        raise SystemExit("align-bag needs exactly one chain per file")
    q = encode_for_search(qs[0], params)
    t = encode_for_search(ts[0], params)
    res = align_mkf(q, t, params)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        if not res.path:
            print("No alignment found", file=sys.stderr)
        else:
            pretty_aln(out, res, q, t, True)
    finally:
        if args.output:
            out.close()
    return 0


def cmd_daliscore_tsv(args) -> int:
    """-daliscore_tsv (src/daliscore_tsv.cpp:28-93): recompute DALI Z
    for each row of a DALI-format TSV (9 fields; gapped rows in fields
    8/9) and print `Zin Z labelQ labelR` per pair."""
    import numpy as np
    from reseek_tpu.benchmarks.msa import dali_score, dali_z
    from reseek_tpu.io.reader import read_chains

    by_label = {c.label: c for c in read_chains(args.input)}
    out = open(args.output, "w") if args.output else sys.stdout

    def aligned_positions(row_q, row_r):
        q = np.frombuffer(row_q.encode("ascii"), np.uint8)
        r = np.frombuffer(row_r.encode("ascii"), np.uint8)
        gap_q = (q == ord("-")) | (q == ord("."))
        gap_r = (r == ord("-")) | (r == ord("."))
        pos_q = np.cumsum(~gap_q) - 1
        pos_r = np.cumsum(~gap_r) - 1
        both = ~gap_q & ~gap_r
        return pos_q[both], pos_r[both]

    try:
        with open(args.tsv) as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                if len(fields) != 9:
                    raise SystemExit(
                        f"expected 9 fields, got {len(fields)}")
                lq, lr = fields[0], fields[1]
                zin = float(fields[2])
                cq = by_label.get(lq)
                cr = by_label.get(lr)
                if cq is None or cr is None:
                    raise SystemExit(f"chain not found: {lq} / {lr}")
                pq, pr = aligned_positions(fields[7], fields[8])
                z = dali_z(dali_score(cq, cr, pq, pr), len(cq), len(cr))
                out.write("%.1f %.1f %s %s\n" % (zin, z, lq, lr))
    finally:
        if args.output:
            out.close()
    return 0


def cmd_scop40bit(args) -> int:
    """-scop40bit (src/scop40bit.cpp:6-16): hits TSV + lookup -> binary
    .bit hit dump (benchmark checkpoint artifact)."""
    from reseek_tpu.benchmarks.scop40 import (read_hits_tsv,
                                              read_lookup_doms, write_bit)
    doms = read_lookup_doms(args.lookup)
    idx = {d: i for i, d in enumerate(doms)}
    d1, d2, sc = read_hits_tsv(args.hits)
    keep = [(idx[a], idx[b], s) for a, b, s in zip(d1, d2, sc)
            if a in idx and b in idx]
    write_bit(args.output, len(doms), [k[0] for k in keep],
              [k[1] for k in keep], [k[2] for k in keep])
    print(f"{len(keep)} hits, {len(doms)} doms -> {args.output}",
          file=sys.stderr)
    return 0


def cmd_scop40bit2tsv(args) -> int:
    """-scop40bit2tsv (src/scop40benchroc.cpp:681-723): .bit + lookup ->
    `dom1<TAB>dom2<TAB>%.6g score` rows."""
    from reseek_tpu.benchmarks.scop40 import (_sf, read_bit,
                                              read_dom_scopid,
                                              read_lookup_doms)
    doms = read_lookup_doms(args.lookup)
    scopids = read_dom_scopid(args.lookup)
    # the reference stores "dom/SF" labels (AddDom,
    # src/scop40bench.cpp:176)
    labels = [f"{d}/{_sf(scopids[d])}" for d in doms]
    n_doms, d1, d2, sc = read_bit(args.bit)
    if n_doms != len(doms):
        raise SystemExit(f"dom count mismatch: .bit {n_doms}, "
                         f"lookup {len(doms)}")
    with open(args.output, "w") as out:
        for a, b, s in zip(d1, d2, sc):
            out.write("%s\t%s\t%.6g\n" % (labels[a], labels[b], s))
    print(f"{len(d1)} hits", file=sys.stderr)
    return 0


def cmd_scop40bit_roc(args) -> int:
    """-scop40bit_roc (src/scop40benchroc.cpp:788-802): SEPQ/ROC report
    from a .bit dump."""
    from reseek_tpu.benchmarks.scop40 import (Scop40Eval, read_bit,
                                              read_dom_scopid,
                                              read_lookup_doms)
    doms = read_lookup_doms(args.lookup)
    n_doms, d1, d2, sc = read_bit(args.bit)
    if n_doms != len(doms):
        raise SystemExit("dom count mismatch")
    ev = Scop40Eval(read_dom_scopid(args.lookup),
                    scores_are_evalues=not args.scores_are_not_evalues)
    res = ev.evaluate((doms[a], doms[b], float(s))
                      for a, b, s in zip(d1, d2, sc))
    print(res.summary())
    return 0


def cmd_scop40bench_tsv(args) -> int:
    """-scop40bench_tsv (src/scop40benchroc.cpp:772-786): SEPQ/ROC
    report from a hits TSV + lookup."""
    from reseek_tpu.benchmarks.scop40 import (Scop40Eval,
                                              read_dom_scopid,
                                              read_hits_tsv)
    d1, d2, sc = read_hits_tsv(args.hits)
    ev = Scop40Eval(read_dom_scopid(args.lookup),
                    scores_are_evalues=not args.scores_are_not_evalues)
    res = ev.evaluate(zip(d1, d2, (float(s) for s in sc)))
    print(res.summary())
    return 0


def cmd_postmufilter(args) -> int:
    """-postmufilter (src/postmufilter.cpp:303-326): standalone stage 2
    of the fast pipeline — read a prefilter TSV (the prefilter-mu
    output: `prefilter<TAB>n` header then `tidx<TAB>nQ<TAB>q1 q2 ...`),
    re-read surviving targets from the .bca and align them against the
    query set with SENSITIVE parameters, emitting one row per hit."""
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.bca import BCAReader
    from reseek_tpu.io.reader import read_chains
    from reseek_tpu.search.driver import (SearchDriver, SearchOptions,
                                          _encode_all, _fast_align_host)

    sens = DSSParams.create("sensitive")
    queries = read_chains(args.input)
    t2q = {}
    with open(args.filin) as f:
        header = f.readline().split()
        if not header or header[0] != "prefilter":
            raise SystemExit(f"{args.filin}: not a prefilter TSV")
        for line in f:
            parts = [int(x) for x in line.split()]
            t2q[parts[0]] = parts[2: 2 + parts[1]]
    options = SearchOptions(
        columns=parse_columns(args.columns),
        max_evalue=args.evalue if args.evalue is not None else 10.0,
        mode="sensitive")
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        drv = SearchDriver(sens, options, out)
        q_ecs = _encode_all(queries, sens, with_self_rev=False)

        def survivors():
            # filter-TSV line order (the reference scans lines in order)
            with BCAReader(args.db) as r:
                for tidx in t2q:
                    yield tidx, r.read_chain(tidx)

        _fast_align_host(drv, q_ecs, survivors(), t2q, sens)
    finally:
        if args.output:
            out.close()
    return 0


def cmd_gunzip_lines(args) -> int:
    """-gunzip_lines (src/gzipfileio.cpp): gunzip to text lines."""
    import gzip
    with gzip.open(args.input, "rt") as f:
        lines = [ln.rstrip("\r\n") for ln in f]
    if args.output:
        with open(args.output, "w") as out:
            for ln in lines:
                out.write(ln + "\n")
    return 0


def cmd_musubstmx(args) -> int:
    """-musubstmx (src/mumx.cpp:33-172): emit the 36x36 Mu matrix as C
    source tables (float, int-rounded, 2x int-rounded) in the
    reference's fprintf layout.  (The reference command derives the
    matrix from g_ScoreMxs2[SS3/NENSS3/RENDist4], which are never
    initialized — it segfaults; the shipped matrix in mumx_data.cpp is
    the authoritative data, so that is what this prints.)"""
    import numpy as np
    from reseek_tpu.data.tables import get_tables

    t = get_tables()
    mu = t.mu_score_mx.astype(np.float32)

    def half_down(x):
        # the shipped int table rounds exact halves DOWN
        # (-0.5 -> -1, 0.5 -> 0 in mumx_data.cpp)
        return int(np.ceil(x - 0.5))

    int_tabs = (("Mu", t.mu_score_mx_int8),
                ("Mu_x2", np.vectorize(half_down)(2.0 * mu)))
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        out.write("\nfloat ScoreMx_Mu[36][36] = {\n")
        for i in range(36):
            out.write("  {")
            for j in range(36):
                out.write(" %5.2ff," % mu[i, j])
            out.write("  }, // %u\n" % i)
        out.write("};\n")
        for name, tab in int_tabs:
            out.write("\n\nint IntScoreMx_%s[36][36] = {\n" % name)
            for i in range(36):
                out.write("  {")
                for j in range(36):
                    out.write(" %3d," % int(tab[i, j]))
                out.write("  }, // %u\n" % i)
            out.write("};\n")
    finally:
        if args.output:
            out.close()
    return 0


def cmd_alignselfrev(args) -> int:
    """-alignselfrev (src/alignselfrev.cpp:5-49): align every chain
    against its own reversal with full SW (sensitive, UsePara off,
    Omega 0, self-rev scores unset so RevDPScore = 0) and print the
    standard TSV row per chain."""
    from reseek_tpu.align.output import format_row, parse_columns
    from reseek_tpu.align.pipeline import (EncodedChain, PairAligner,
                                           encode_for_search)
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.encoder.dss import encode_chain, mu_kmers
    from reseek_tpu.io.reader import read_chains

    params = DSSParams.create("sensitive")
    params.use_para = False
    params.omega = 0.0
    cols = parse_columns("std")
    pa = PairAligner(params)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for c in read_chains(args.input):
            q = encode_for_search(c, params, with_self_rev=False)
            rev = c.reversed()
            rev.label = c.label  # reference keeps the chain's label
            rev_enc = encode_chain(rev)
            t = EncodedChain(chain=rev, enc=rev_enc,
                             profile=rev_enc.profile(params),
                             mu_letters=rev_enc.mu_letters,
                             mu_kmers=mu_kmers(rev_enc.mu_letters,
                                               params.mkf_pattern))
            res = pa.align_no_accel(q, t)
            out.write(format_row(cols, res, q, t, True))
            out.write("\n")
    finally:
        if args.output:
            out.close()
    return 0


def cmd_mu_mapping(args) -> int:
    """-mu_mapping (src/mu_mapping.cpp:7-44): table of the 36 Mu letters
    decomposed into their sub-feature letters (Mu = SS3 + 3*NENSS3 +
    9*RENDist4, src/dss.cpp:629-644).  (The reference command itself
    dies on an assert — GetFeatureChar on sub-alphabet sizes — so there
    is no binary golden; this prints the working table.)"""
    chars = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghij"
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        out.write("Mu\tSS3\tNENSS3\tRENDist4\n")
        for letter in range(36):
            ss3 = letter % 3
            nenss3 = (letter // 3) % 3
            rendist4 = letter // 9
            out.write("%c\t%c\t%c\t%c\n" % (chars[letter], chars[ss3],
                                            chars[nenss3],
                                            chars[rendist4]))
    finally:
        if args.output:
            out.close()
    return 0


def cmd_lddt_msa_foldmason(args) -> int:
    """-lddt_msa_foldmason (src/lddt_msa_foldmason.cpp:6-30): whole-MSA
    foldmason LDDT."""
    import os as _os
    from reseek_tpu.benchmarks.msa import lddt_foldmason
    from reseek_tpu.io.reader import read_chains

    chains = read_chains(args.input)
    name = _os.path.splitext(_os.path.basename(args.msa))[0]
    _msa, core_mask, matched, maps = _msta_setup(args.msa, chains,
                                                 args.core)
    lddt = lddt_foldmason(matched, maps, core_mask)
    line = "LDDT_fm=%.4f\tMSA=%s\n" % (lddt, name)
    if args.output:
        with open(args.output, "w") as f:
            f.write(line)
    print(line, end="", file=sys.stderr)
    return 0


def _batch_msa_cmd(args, metric: str) -> int:
    """Shared body of lddt-msas / daliscore-msas
    (src/lddt_msas.cpp:6-80, src/daliscore_msas.cpp:6-63)."""
    import os as _os

    from reseek_tpu.benchmarks.msa import (dali_score, dali_z,
                                           lddt_msa_pair)
    from reseek_tpu.io.reader import read_chains

    chains = read_chains(args.input)
    with open(args.accs) as f:
        accs = [ln.strip() for ln in f if ln.strip()]
    testdir = args.testdir.rstrip("/") + "/"
    out = open(args.output, "w") if args.output else sys.stdout
    total = 0.0
    n_found = 0
    try:
        for acc in accs:
            fn = testdir + acc
            if not _os.path.exists(fn):
                out.write(f"missing_aln={fn}\n")
                continue
            n_found += 1
            msa, core_mask, matched, maps = _msta_setup(fn, chains,
                                                        args.core)
            v_sum = 0.0
            np_pairs = 0
            for i in range(len(msa)):
                for j in range(i + 1, len(msa)):
                    if i not in matched or j not in matched:
                        continue
                    ci, cj = matched[i], matched[j]
                    np_pairs += 1
                    if metric == "lddt":
                        v_sum += lddt_msa_pair(ci, cj, maps[i], maps[j])
                    else:
                        both = (maps[i] >= 0) & (maps[j] >= 0)
                        v_sum += dali_z(
                            dali_score(ci, cj, maps[i][both],
                                       maps[j][both]),
                            len(ci), len(cj))
            v = v_sum / np_pairs if np_pairs else 0.0
            total += v
            if metric == "lddt":
                out.write("aln=%s\tLDDT_mu=%.4f" % (fn, v))
                if args.core:
                    out.write("\tnr_core_cols=%u" % int(core_mask.sum()))
            else:
                out.write("aln=%s\tZ=%.1f" % (fn, v))
                if args.core:
                    out.write("\tnr_core=%u" % int(core_mask.sum()))
            out.write("\n")
        mean = total / n_found if n_found else 0.0
        if metric == "lddt":
            out.write("testdir=%s\tavg_LDDT_mu=%.4f\n" % (testdir, mean))
        else:
            out.write("testdir=%s\tZ=%.1f\n" % (testdir, mean))
    finally:
        if args.output:
            out.close()
    return 0


def cmd_lddt_msas(args) -> int:
    """-lddt_msas: batch MSA LDDT_mu over an accession list."""
    return _batch_msa_cmd(args, "lddt")


def cmd_daliscore_msas(args) -> int:
    """-daliscore_msas: batch MSA DALI Z over an accession list.
    (The reference's cmd_daliscore_msas has an inverted success check —
    `if (Ok) Die(...)`, src/daliscore_msas.cpp:40-41 — so the binary
    cannot actually run it; this implements the evident intent, with
    row formats matching its fprintf strings.)"""
    return _batch_msa_cmd(args, "dali")


def cmd_mmseqs_index_dump(args) -> int:
    """-mmseqs_index_dump (src/mmseqs_index_dump.cpp:21-96): dump an
    MMseqs2/Foldseek hits DB (prefix + .index + .dbtype) as text —
    `index\\t<pos>\\t<len>` per record then its lines, non-printing bytes
    shown as '@'."""
    import os as _os
    prefix = args.prefix
    with open(prefix + ".dbtype", "rb") as f:
        dbtype = f.read()
    if len(dbtype) != 4:
        raise SystemExit(f"{prefix}.dbtype: expected 4 bytes")
    print("0x%04x  %s.dbtype" % (int.from_bytes(dbtype, "little"),
                                 prefix), file=sys.stderr)
    out = open(args.output, "w") if args.output else None
    recnr = hitcount = nonprint = 0
    nextpos = 0
    with open(prefix, "rb") as fhits, open(prefix + ".index") as fidx:
        for line in fidx:
            recidx, recpos, reclen = (int(x) for x in line.split("\t"))
            if recidx != recnr or recpos != nextpos or reclen <= 0:
                raise SystemExit(
                    f"bad index record {recnr}: {line.strip()}")
            recnr += 1
            nextpos += reclen
            fhits.seek(recpos)
            buf = fhits.read(reclen)
            if buf[-1] != 0:
                raise SystemExit(f"record {recidx} not NUL-terminated")
            if out is not None:
                out.write(f"index\t{recpos}\t{reclen}\n")
                for b in buf[:-1]:
                    c = chr(b)
                    if c == "\n":
                        out.write("\n")
                        hitcount += 1
                    elif c.isprintable() or c == "\t":
                        out.write(c)
                    else:
                        nonprint += 1
                        out.write("@")
                out.write("\n")
    if out is not None:
        out.close()
    if nextpos != _os.path.getsize(prefix):
        print("warning: index does not cover the hits file "
              f"({nextpos} != {_os.path.getsize(prefix)})",
              file=sys.stderr)
    print(f"{recnr} records, {hitcount} hits, {nonprint} "
          "non-printing bytes", file=sys.stderr)
    return 0


def cmd_create_foldseekdb(args) -> int:
    """-create_foldseekdb (src/create_foldseekdb.cpp:17-170): write a
    Foldseek-format database from structures + a 3Di FASTA (byte-level
    format parity incl. the packed int16-delta C-alpha codec)."""
    from reseek_tpu.io.foldseek import write_foldseek_db
    from reseek_tpu.io.mufasta import iter_fasta
    from reseek_tpu.io.reader import read_chains

    chains = read_chains(args.input)
    seqs_3di = {label.split()[0]: seq
                for label, seq in iter_fasta(args.tdi)}
    n = write_foldseek_db(chains, seqs_3di, args.output, dupes=args.n)
    print(f"{n} entries -> {args.output}", file=sys.stderr)
    return 0


def cmd_convert_foldseekdb(args) -> int:
    """-convert_foldseekdb (src/convert_foldseekdb.cpp:140-267): parse a
    Foldseek database back to aa FASTA, 3Di FASTA and/or .cal."""
    from reseek_tpu.chain import Chain
    from reseek_tpu.io.cal import write_cal
    from reseek_tpu.io.foldseek import read_foldseek_db

    from reseek_tpu.io.mufasta import seq_to_fasta
    entries = read_foldseek_db(args.prefix)
    if args.fasta:
        with open(args.fasta, "w") as f:
            for label, seq, _s3, _c in entries:
                seq_to_fasta(f, label, seq)
    if args.tdi:
        with open(args.tdi, "w") as f:
            for label, _seq, s3, _c in entries:
                seq_to_fasta(f, label, s3)
    if args.cal:
        chains = [Chain(label, seq, coords)
                  for label, seq, _s3, coords in entries]
        write_cal(chains, args.cal)
    print(f"{len(entries)} entries from {args.prefix}", file=sys.stderr)
    return 0


def cmd_float_feature_bins(args) -> int:
    """-float_feature_bins (src/float_feature_bins.cpp:67-166): from
    trusted pairwise alignments, collect a float feature's values at
    aligned columns, derive quantile bin thresholds per alphabet size,
    and report each size's expected log-odds score plus BIN_T lines
    (the reference writes these to its -log; here to --output/stdout)."""
    import numpy as np
    from reseek_tpu.benchmarks.train import (LogOdds, _aligned_positions,
                                             read_aligned_pairs)
    from reseek_tpu.encoder.dss import float_feature_values
    from reseek_tpu.io.reader import read_chains

    chains = read_chains(args.train_cal)
    by_dom = {c.label.split("/")[0]: c for c in chains}
    pairs = read_aligned_pairs(args.pairs)
    cache = {}

    def vals(c):
        if c.label not in cache:
            cache[c.label] = float_feature_values(c, args.feature)
        return cache[c.label]

    v1, v2 = [], []
    for lq, rq, lr, rr in pairs:
        qc = by_dom[lq.split("/")[0]]
        rc = by_dom[lr.split("/")[0]]
        pq, pr = _aligned_positions(rq, rr)
        vq = vals(qc)[pq]
        vr = vals(rc)[pr]
        ok = np.isfinite(vq) & np.isfinite(vr)
        v1.extend(vq[ok])
        v2.extend(vr[ok])
    v1 = np.asarray(v1)
    v2 = np.asarray(v2)
    values = np.sort(np.concatenate([np.stack([v1, v2], 1).ravel()]))
    if len(values) == 0:
        raise SystemExit("no aligned defined values")
    print("Value range %.3g .. %.3g" % (values[0], values[-1]),
          file=sys.stderr)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        sizes = ([args.alpha_size] if args.alpha_size
                 else [3, 4, 6, 8, 10, 12, 16, 24, 32])
        k_tot = len(values)
        for a in sizes:
            ts = np.array([values[((i + 1) * k_tot) // a]
                           for i in range(a - 1)])
            # DSS::ValueToInt (src/dss.cpp:840-847): first i with
            # value <= Ts[i], else N
            i1 = np.searchsorted(ts, v1, side="left")
            i2 = np.searchsorted(ts, v2, side="left")
            lo = LogOdds(a)
            lo.add_background(i1)
            lo.add_background(i2)
            lo.add_true_pairs(i1, i2)
            mx, expected = lo.log_odds_mx()
            print("%s: AlphaSize %u, ExpectedScore %.4g"
                  % (args.feature, a, expected), file=sys.stderr)
            out.write("\n// %s [%2u] expected score %.4g\n"
                      % (args.feature, a, expected))
            out.write("ALPHA_SIZE(%s, %u);\n" % (args.feature, a))
            out.write("BIN_T_BEGIN(%s);\n" % args.feature)
            for i in range(a - 1):
                out.write("BIN_T(%s, %u, %.4g);\n"
                          % (args.feature, i, ts[i]))
            out.write("BIN_T_END(%s);\n" % args.feature)
    finally:
        if args.output:
            out.close()
    return 0


def cmd_sscluster(args) -> int:
    """-sscluster (src/sscluster.cpp:171-371): k-means over per-residue
    intra-window CA distance vectors (pairs (i, j) in [-2, 2] excluding
    adjacent; +3 extra pairs with --myss3), reporting centroid means and
    the SS-letter correlation per cluster.  Functional equivalent of the
    reference trainer: initialization uses a seeded numpy RNG rather
    than the reference's randu32 stream, so cluster numbering can
    differ; the shipped Conf centroids live in data/tables.npz."""
    import numpy as np
    from reseek_tpu.encoder.dss import _banded_distances, compute_ss
    from reseek_tpu.io.reader import read_chains

    chains = read_chains(args.input)
    k = args.k
    n_max = args.n
    ij = [(min(i, j), max(i, j))
          for i in range(-2, 3) for j in range(i + 1, 3)
          if abs(j - i) != 1]
    if args.myss3:
        ij += [(-3, 3), (0, 3), (-3, 0)]
    m = len(ij)

    from reseek_tpu.encoder.dss import BAND_W
    vs, sss = [], []
    for c in chains:
        L = len(c)
        ss = compute_ss(c.coords, _banded_distances(c.coords, BAND_W))
        ss_chars = "hst~"
        for p in range(3, L - 3):
            v = [float(np.linalg.norm(c.coords[p + i] - c.coords[p + j]))
                 for i, j in ij]
            vs.append(v)
            sss.append(ss_chars[ss[p]] if ss[p] < 4 else "~")
            if len(vs) >= n_max:
                break
        if len(vs) >= n_max:
            break
    x = np.asarray(vs)
    n = len(x)
    rng = np.random.default_rng(args.randseed)
    assign = rng.integers(0, k, n)
    for it in range(100):
        means = np.stack([x[assign == kk].mean(axis=0)
                          if (assign == kk).any()
                          else x[rng.integers(0, n)]
                          for kk in range(k)])
        d = np.linalg.norm(x[:, None, :] - means[None], axis=2)
        new = d.argmin(axis=1)
        changes = int((new != assign).sum())
        assign = new
        print(f"Iter {it}, {changes} changes", file=sys.stderr)
        if changes == 0:
            print("=== CONVERGED ===", file=sys.stderr)
            break
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        sizes = np.bincount(assign, minlength=k)
        order = np.argsort(-sizes, kind="stable")
        out.write("//          " + "".join("  %10s" % f"{i},{j}"
                                           for i, j in ij) + "\n")
        sss = np.asarray(sss)
        for rank, kk in enumerate(order):
            mean = x[assign == kk].mean(axis=0) if sizes[kk] else \
                np.zeros(m)
            out.write("Mean[%3u] " % rank
                      + "".join(" %10.4g" % v for v in mean))
            cnt = {c: int((sss[assign == kk] == c).sum())
                   for c in "hst~"}
            out.write("  size=%.1f%%  h=%d s=%d t=%d ~=%d\n"
                      % (100.0 * sizes[kk] / max(n, 1), cnt["h"],
                         cnt["s"], cnt["t"], cnt["~"]))
    finally:
        if args.output:
            out.close()
    return 0


def cmd_align_bags(args) -> int:
    """MKF-vs-full-SW self-check (reference -align_bags,
    src/align_bag.cpp:97-199): all-vs-all pairs with both chains >= 400
    residues, full sensitive SW (UsePara off, Omega 0) kept at E <= 1,
    re-aligned through the MKF bag path; prints E-value and pctid for
    both and flags PROBLEM rows (bag chain missing at E_sw < 0.01, or
    pctid drop > 5)."""
    from reseek_tpu.align.mkf import align_mkf
    from reseek_tpu.align.output import _pct_id
    from reseek_tpu.align.pipeline import PairAligner, encode_for_search
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.reader import read_chains

    import copy

    import numpy as np
    from reseek_tpu.encoder.dss import encode_chain
    from reseek_tpu.search.engine import _exact_fwd_score

    params = DSSParams.create("sensitive")
    params.use_para = False
    params.omega = 0.0
    chains = read_chains(args.input)
    out = open(args.output, "w") if args.output else sys.stdout
    pa = PairAligner(params)
    # bag side: standard self-rev (MKF quirk for chains >= mkfl, Mu
    # k-mers passed — src/align_bag.cpp:29-31); SW side: the reference
    # passes NO Mu k-mers to GetSelfRevScore (align_bag.cpp:135), so the
    # self-rev there is FULL SW even for long chains
    ecs = [encode_for_search(c, params) for c in chains]
    sw_ecs = []
    for ec in ecs:
        rev_profile = encode_chain(ec.chain.reversed()).profile(params)
        sw_ec = copy.copy(ec)
        sw_ec.self_rev_score = max(
            _exact_fwd_score(params, ec.profile, rev_profile), 0.0)
        sw_ecs.append(sw_ec)
    n_problem = 0
    n_rows = 0

    def e2(v):
        return "%.2e" % np.float32(v)  # reference stores E as float32

    try:
        for a in range(len(ecs)):
            for b in range(a, len(ecs)):
                q, t = ecs[a], ecs[b]
                if len(q) < 400 or len(t) < 400:
                    continue
                res_sw = pa.align_no_accel(sw_ecs[a], sw_ecs[b])
                if res_sw.evalue > 1:
                    continue
                res_bag = align_mkf(q, t, params)
                has_bag = res_bag.best_chain_score > 0
                problem = False
                row = [q.label, t.label, e2(res_sw.evalue)]
                if has_bag:
                    row.append(e2(res_bag.evalue))
                else:
                    if res_sw.evalue < 0.01:
                        problem = True
                    row.append("PROBE")
                pct_sw = _pct_id(res_sw, q, t)
                row.append("%.1f" % pct_sw)
                if has_bag:
                    pct_bag = _pct_id(res_bag, q, t)
                    if pct_sw - pct_bag > 5:
                        problem = True
                    row.append("%.1f" % pct_bag)
                else:
                    row.append("nobag")
                if problem:
                    row.append("PROBLEM")
                    n_problem += 1
                n_rows += 1
                out.write("\t".join(row) + "\n")
    finally:
        if args.output:
            out.close()
    print(f"align-bags: {n_rows} rows, {n_problem} PROBLEM",
          file=sys.stderr)
    return 0


def _msta_setup(msa_path: str, chains, core: bool):
    """Shared MSA setup for the msta commands (DALIScorer::SetMSA,
    src/daliscorer.cpp): rows, core mask, col->pos maps, matched
    chains."""
    from reseek_tpu.benchmarks.msa import (_match_chains, col_to_pos,
                                           core_columns, read_msa_fasta)
    msa = read_msa_fasta(msa_path)
    rows = [r for _, r in msa]
    core_mask = core_columns(rows) if core else None
    matched = _match_chains(msa, chains)
    maps = [col_to_pos(r, core_mask) for r in rows]
    return msa, core_mask, matched, maps


def cmd_msta_score(args) -> int:
    """-msta_score (src/msta_score.cpp:6-97): all-pairs MSA structure
    scores — LDDT_mu (muscle convention), DALI Z, Z15 (R0=15-gated DALI)
    — plus the whole-MSA foldmason LDDT and averages."""
    import os as _os

    import numpy as np
    from reseek_tpu.benchmarks.msa import (dali_score, dali_z,
                                           lddt_foldmason, lddt_msa_pair)
    from reseek_tpu.io.reader import read_chains

    chains = read_chains(args.input)
    name = _os.path.splitext(_os.path.basename(args.msa))[0]
    msa, core_mask, matched, maps = _msta_setup(args.msa, chains,
                                                args.core)
    out = open(args.output, "w") if args.output else sys.stdout
    sum_z = sum_z15 = sum_lddt = 0.0
    n_pairs = 0
    try:
        for i in range(len(msa)):
            for j in range(i + 1, len(msa)):
                l1, l2 = msa[i][0], msa[j][0]
                if i not in matched or j not in matched:
                    out.write(f"{l1}\t{l2}\tERROR_structure_not_found\n")
                    continue
                ci, cj = matched[i], matched[j]
                n_pairs += 1
                lddt_mu = lddt_msa_pair(ci, cj, maps[i], maps[j])
                both = (maps[i] >= 0) & (maps[j] >= 0)
                pq, pt = maps[i][both], maps[j][both]
                z = dali_z(dali_score(ci, cj, pq, pt), len(ci), len(cj))
                z15 = dali_z(dali_score(ci, cj, pq, pt, r0=15.0),
                             len(ci), len(cj))
                sum_z += z
                sum_z15 += z15
                sum_lddt += lddt_mu
                out.write("label1=%s\tlabel2=%s\tLDDT_mu=%.4f\t"
                          "Z=%.3f\tZ15=%.3f\n" % (l1, l2, lddt_mu, z, z15))
        lddt_fm = lddt_foldmason(matched, maps, core_mask)
        mz = sum_z / n_pairs if n_pairs else 0.0
        mz15 = sum_z15 / n_pairs if n_pairs else 0.0
        ml = sum_lddt / n_pairs if n_pairs else 0.0
        out.write("MSA=%s\tLDDT_fm=%.4f\tavg_LDDT_mu=%.4f\t"
                  "avg_Z=%.3f\tavg_Z15=%.3f\n" % (name, lddt_fm, ml, mz,
                                                  mz15))
    finally:
        if args.output:
            out.close()
    return 0


def cmd_msta_scores(args) -> int:
    """-msta_scores (src/msta_scores.cpp:6-113): batch MSA scoring — for
    each accession in the list file, score testdir/<acc> (mean pairwise
    DALI Z and LDDT_mu), then print per-MSA rows and the averages."""
    import os as _os

    from reseek_tpu.benchmarks.msa import (dali_score, dali_z,
                                           lddt_msa_pair)
    from reseek_tpu.io.reader import read_chains

    chains = read_chains(args.input)
    with open(args.accs) as f:
        accs = [ln.strip() for ln in f if ln.strip()]
    testdir = args.testdir.rstrip("/") + "/"
    out = open(args.output, "w") if args.output else sys.stdout
    sum_z = sum_lddt = 0.0
    n_found = 0
    try:
        for acc in accs:
            fn = testdir + acc
            if not _os.path.exists(fn):
                out.write(f"missing_aln={fn}\n")
                continue
            msa, core_mask, matched, maps = _msta_setup(fn, chains,
                                                        args.core)
            if not msa:
                out.write(f"empty_aln={fn}\n")
                continue
            n_found += 1
            z_sum = l_sum = 0.0
            np_pairs = 0
            for i in range(len(msa)):
                for j in range(i + 1, len(msa)):
                    if i not in matched or j not in matched:
                        continue
                    ci, cj = matched[i], matched[j]
                    np_pairs += 1
                    both = (maps[i] >= 0) & (maps[j] >= 0)
                    z_sum += dali_z(
                        dali_score(ci, cj, maps[i][both], maps[j][both]),
                        len(ci), len(cj))
                    l_sum += lddt_msa_pair(ci, cj, maps[i], maps[j])
            z = z_sum / np_pairs if np_pairs else 0.0
            lddt_mu = l_sum / np_pairs if np_pairs else 0.0
            sum_z += z
            sum_lddt += lddt_mu
            out.write("aln=%s\tseqs=%u\tZ=%.3f\tLDDT_mu=%.4f"
                      % (fn, len(msa), z, lddt_mu))
            if args.core:
                out.write("\tnr_core_cols=%u" % int(core_mask.sum()))
            out.write("\n")
        mz = sum_z / n_found if n_found else 0.0
        ml = sum_lddt / n_found if n_found else 0.0
        out.write("testdir=%s\tavg_Z=%.4f\tavg_LDDT_mu=%.4f\n"
                  % (testdir, mz, ml))
    finally:
        if args.output:
            out.close()
    return 0


def cmd_alignpair(args) -> int:
    from reseek_tpu.align.output import format_row
    from reseek_tpu.align.pipeline import PairAligner, encode_for_search
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.reader import read_chains
    from reseek_tpu.ops.kabsch import kabsch_path

    params = DSSParams.create("sensitive")
    params.omega = 0.0  # src/alignpair.cpp:179-185
    qs = read_chains(args.input, save_lines=True)
    ts = read_chains(args.input2, save_lines=True)
    if not qs or not ts:
        raise SystemExit("No chains found")

    pa = PairAligner(params)
    best = None
    for qc in qs:
        q = encode_for_search(qc, params)
        for tc in ts:
            t = encode_for_search(tc, params)
            res = pa.align(q, t, apply_filter=False)
            if best is None or res.fwd_score > best[0].fwd_score:
                best = (res, q, t)
    res, q, t = best
    if args.global_aln:
        from reseek_tpu.ops.nw import nw_align
        from reseek_tpu.ops.substmx import build_smx
        smx = build_smx(params, q.profile, t.profile)
        score, path = nw_align(smx)
        res.fwd_score, res.lo_a, res.lo_b, res.path = score, 0, 0, path
        from reseek_tpu.search.engine import finish_result
        res.hi_a = len(q) - 1
        res.hi_b = len(t) - 1
        finish_result(res, q, t, params)
    if not res.path:
        raise SystemExit("No alignment found")

    cols = ["query", "target", "qlo", "qhi", "tlo", "thi", "pctid",
            "dpscore", "lddt", "newts", "evalue", "cigar"]
    print(format_row(cols, res, q, t, True))

    if args.aln:
        from reseek_tpu.align.output import _row_strings
        ra, rb = _row_strings(res, q, t, True, False)
        with open(args.aln, "w") as f:
            f.write(f"Query   >{q.label}\nTarget  >{t.label}\n\n")
            for k in range(0, len(ra), 80):
                f.write(ra[k:k + 80] + "\n" + rb[k:k + 80] + "\n\n")
            f.write(f"E-value {res.evalue:.3g}  dpscore {res.fwd_score:.4g}"
                    f"  lddt {res.lddt:.4g}\n")
    if args.output:
        t_vec, u, _msd = kabsch_path(q.chain.coords, t.chain.coords,
                                     res.lo_a, res.lo_b, res.path)
        rotated = q.chain.transformed(t_vec, u)
        from reseek_tpu.io.pdb import write_pdb
        with open(args.output, "w") as f:
            write_pdb(rotated, f)
    return 0


def cmd_pdb2ss(args) -> int:
    from reseek_tpu.encoder.dss import encode_chain
    from reseek_tpu.io.reader import read_chains

    for c in read_chains(args.input):
        print(f"{c.label}   SecStr  {encode_chain(c).ss_string}")
    return 0


def cmd_bca_stats(args) -> int:
    from reseek_tpu.io.bca import BCAReader

    with BCAReader(args.input) as r:
        print(f"{len(r):10d}  Chains")
        print(f"{int(r.seq_lengths.sum()):10d}  Residues")
    return 0


def cmd_pdb2mega(args) -> int:
    """Input file for Muscle-3D MSA (src/pdb2mega.cpp): header, per-feature
    freqs + weighted log-odds (lower triangles), then per-residue profile
    letter strings."""
    import numpy as np
    from reseek_tpu.constants import ALPHA_SIZES, AMINO_ALPHABET, DSSParams
    from reseek_tpu.data.tables import get_tables
    from reseek_tpu.encoder.dss import encode_chain
    from reseek_tpu.io.reader import read_chains
    from reseek_tpu.ops.substmx import weighted_matrices

    params = DSSParams.create("fast")
    t = get_tables()
    mats = weighted_matrices(params.features, params.weights)
    chains = read_chains(args.input)
    if args.reverse:
        chains = [c.reversed() for c in chains]
    nf = len(params.features)
    with open(args.output, "w") as f:
        f.write(f"mega\t{nf}\t{len(chains)}\t"
                f"{-params.gap_open:.4g}\t{-params.gap_ext:.4g}\n")
        for i, feat in enumerate(params.features):
            a = ALPHA_SIZES[feat]
            f.write(f"{i}\t{feat}\t{a}\t{params.weights[i]:.6g}\n")
            freqs = t.bg_freqs(feat)
            f.write("freqs" + "".join(f"\t{v:.4g}" for v in freqs[:a])
                    + "\n")
            fm = t.freq_mx(feat)
            for l1 in range(a):
                f.write(str(l1) + "".join(f"\t{fm[l1, l2]:.4g}"
                                          for l2 in range(l1 + 1)) + "\n")
            f.write("logoddsmx\n")
            sm = mats[feat]
            for l1 in range(a):
                c = (AMINO_ALPHABET[l1] if feat == "AA"
                     else chr(ord("a") + l1))
                f.write(f"{l1}\t{c}" + "".join(
                    f"\t{sm[l1, l2]:.4g}" for l2 in range(l1 + 1)) + "\n")
        for ci, chain in enumerate(chains):
            enc = encode_chain(chain)
            prof = enc.profile(params)
            f.write(f"chain\t{ci}\t{chain.label}\t{len(chain)}\n")
            for pos in range(len(chain)):
                srow = []
                for fi, feat in enumerate(params.features):
                    if feat == "AA":
                        srow.append(chain.seq[pos])
                    else:
                        srow.append(chr(ord("A") + int(prof[fi, pos])))
                f.write(f"{ci}\t{pos}\t{''.join(srow)}\n")
    print(f"{len(chains)} chains written", file=sys.stderr)
    return 0


def cmd_scop40bench(args) -> int:
    """All-vs-all SCOP40-style benchmark: self-search then SEPQ/ROC report
    (src/scop40bench.cpp:767, test_scripts/check_scop40.py)."""
    import io
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.benchmarks.scop40 import Scop40Eval, read_dom_scopid
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.reader import read_chains
    from reseek_tpu.search.driver import SearchOptions, self_search

    mode = _mode_from_args(args, default="fast")
    params = DSSParams.create(mode)
    options = SearchOptions(
        columns=parse_columns("query+target+evalue"),
        max_evalue=args.evalue if args.evalue is not None else 10.0,
        mode=mode)
    chains = read_chains(args.input)
    buf = io.StringIO() if not args.output else open(args.output, "w")
    self_search(chains, params, options, buf, engine=args.engine)
    if args.output:
        buf.close()
        hits_f = open(args.output)
    else:
        buf.seek(0)
        hits_f = buf
    ev = Scop40Eval(read_dom_scopid(args.lookup))
    def gen():
        for line in hits_f:
            q, t, e = line.rstrip("\n").split("\t")
            yield q, t, float(e)
    res = ev.evaluate(gen())
    print(res.summary())
    return 0


def cmd_prefilter_mu(args) -> int:
    """-prefilter_mu (src/cmd_prefiltermu.cpp:50-130): Mu k-mer two-hit
    prefilter of a query Mu FASTA against a target Mu FASTA; writes the
    RankedScoresBag TSV (`prefilter<TAB>n` header, then
    `targetIdx<TAB>nQ<TAB>q1 q2 ...` rows, rankedscoresbag.cpp:185-232)."""
    import time

    from reseek_tpu.search.prefilter import prefilter_search, read_mu_fasta
    _qlabels, q_mu = read_mu_fasta(args.input)
    tlabels, t_mu = read_mu_fasta(args.db)
    t0 = time.time()
    # both sides come from Mu FASTA -> both already in g_CharToLetterMu
    # space; no extra query-side swap (unlike the -search pipeline)
    pf = prefilter_search(q_mu, enumerate(t_mu), mode=args.mode,
                          ascii_roundtrip=False)
    secs = max(time.time() - t0, 1e-9)
    print("Seqs/sec         %.3g" % (len(t_mu) / secs), file=sys.stderr)
    t2q = pf.target_to_queries()
    with open(args.output, "w") as f:
        f.write("prefilter\t%u\n" % len(t2q))
        for tidx in sorted(t2q):
            qs = t2q[tidx]
            f.write("%u\t%u" % (tidx, len(qs)))
            for q in qs:
                f.write("\t%u" % q)
            f.write("\n")
    return 0


def cmd_distmx(args) -> int:
    """-distmx (src/distmx.cpp:26-64): all-vs-all self search writing
    `idxA<TAB>idxB<TAB>newts` rows for pairs with E <= max (Up rows only),
    then `maxts`."""
    import io as _io

    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.reader import read_chains
    from reseek_tpu.search.driver import SearchOptions, self_search

    mode = _mode_from_args(args, default="fast")
    params = DSSParams.create(mode)
    chains = read_chains(args.input)
    idx = {c.label: i for i, c in enumerate(chains)}
    opts = SearchOptions(columns=parse_columns("query+target+newts+evalue"),
                         max_evalue=args.evalue
                         if args.evalue is not None else 10.0, mode=mode)
    buf = _io.StringIO()
    self_search(chains, params, opts, buf, engine=args.engine)
    max_ts = float("-inf")
    with open(args.output, "w") as f:
        seen = set()
        for line in buf.getvalue().splitlines():
            q, t, ts, _e = line.split("\t")
            key = (idx[q], idx[t])
            if key in seen:   # Up row only (src/distmx.cpp:28-29)
                continue
            seen.add(key)
            seen.add((key[1], key[0]))
            ts_f = float(ts)
            max_ts = max(max_ts, ts_f)
            f.write("%u\t%u\t%.3f\n" % (idx[q], idx[t], ts_f))
    print("maxts %.3f" % max_ts, file=sys.stderr)
    return 0


def cmd_shuffle(args) -> int:
    """-shuffle (src/shuffle.cpp:5-26): random chain order -> .bca."""
    import random

    from reseek_tpu.io.bca import BCAWriter
    from reseek_tpu.io.reader import read_chains
    chains = read_chains(args.input)
    order = list(range(len(chains)))
    rng = random.Random(args.seed)
    rng.shuffle(order)
    with BCAWriter(args.bca) as w:
        for i in order:
            w.write_chain(chains[i])
    print(f"{len(chains)} chains shuffled", file=sys.stderr)
    return 0


def cmd_split(args) -> int:
    """-split (src/split.cpp:107-130): divide a DB into N .bca splits of
    ceil(count/N) chains each, filenames <prefix><k>.bca."""
    from reseek_tpu.io.bca import BCAWriter
    from reseek_tpu.io.reader import read_chains
    chains = [c for c in read_chains(args.input)
              if len(c) >= max(args.minchainlength, 1)]
    per = -(-len(chains) // args.n)
    print(f"{per} chains/split", file=sys.stderr)
    for k in range(args.n):
        part = chains[k * per: (k + 1) * per]
        if not part:
            break
        with BCAWriter(f"{args.prefix}{k + 1}.bca") as w:
            for c in part:
                w.write_chain(c)
    return 0


def cmd_convert2mu(args) -> int:
    """-convert2mu (src/convert2mu.cpp:7-60): structures -> Mu-letter
    FASTA (streamed)."""
    from reseek_tpu.encoder.dss import encode_chain, feature_string
    from reseek_tpu.io.mufasta import seq_to_fasta
    from reseek_tpu.io.reader import iter_chains
    n = 0
    with open(args.output, "w") as f:
        for c in iter_chains(args.input):
            if len(c) < max(args.minchainlength, 1):
                continue
            seq_to_fasta(f, c.label, feature_string(encode_chain(c), "Mu"))
            n += 1
    print(f"{n} chains converted", file=sys.stderr)
    return 0


def cmd_gunzip(args) -> int:
    """-gunzip (src/gzipfileio.cpp:90-111)."""
    import gzip
    import shutil
    with gzip.open(args.input, "rb") as fin, \
            open(args.output, "wb") as fout:
        shutil.copyfileobj(fin, fout)
    return 0


def cmd_cif2pdb(args) -> int:
    """-cif2pdb (src/cif2pdb.cpp:238): mmCIF -> PDB."""
    from reseek_tpu.io.cif import read_cif
    from reseek_tpu.io.pdb import write_pdb
    chains = list(read_cif(args.input))
    with open(args.output, "w") as f:
        for c in chains:
            write_pdb(c, f)
    print(f"{len(chains)} chains written", file=sys.stderr)
    return 0


def _global_pctid(seq_i: str, seq_j: str) -> float:
    """prepare_query's GetPctId (src/prepare_query.cpp:10-45): BLOSUM62
    global alignment (open -1, ext -0.05, free terminal gaps,
    ViterbiFastMem char overload), identities / columns."""
    import numpy as np
    from reseek_tpu.data.blosum62 import char_subst_mx
    from reseek_tpu.ops.nw import nw_align
    if seq_i == seq_j:
        return 100.0
    m = char_subst_mx()
    a = np.frombuffer(seq_i.encode("latin-1"), np.uint8)
    b = np.frombuffer(seq_j.encode("latin-1"), np.uint8)
    _score, path = nw_align(m[a[:, None], b[None, :]])
    pa = pb = ids = 0
    for c in path:
        if c == "M":
            if seq_i[pa] == seq_j[pb]:
                ids += 1
            pa += 1
            pb += 1
        elif c == "D":
            pa += 1
        else:
            pb += 1
    return (100.0 * ids) / len(path)


def cmd_prepare_query(args) -> int:
    """-prepare_query (src/prepare_query.cpp:48-130): keep up to N query
    chains that are >= minchainlength and < 90% BLOSUM-global-identity
    to an earlier kept chain; status TSV + .bca output.  Like the
    reference, -n is only honored when -minchainlength is given
    (otherwise the cap is 4)."""
    from reseek_tpu.io.bca import BCAWriter
    from reseek_tpu.io.reader import read_chains
    chains = read_chains(args.input)
    min_len = (args.minchainlength if args.minchainlength is not None
               else 1)
    max_chains = (args.n if args.minchainlength is not None else 4)
    kept = []
    n_queries = 0
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for i, c in enumerate(chains):
            out.write(f"{i}\t{c.label}\t{len(c)}")
            if len(c) < min_len:
                out.write("\tshort\n")
                continue
            if n_queries >= max_chains:
                out.write("\ttoomany\n")
                continue
            dup = None
            for j, k in kept:
                if len(k) < min_len:
                    continue
                pct = _global_pctid(c.seq, k.seq)
                if pct >= 90.0:
                    dup = (pct, j)
                    break
            if dup is not None:
                out.write("\t%.1f%%%u\n" % dup)
                continue
            kept.append((i, c))
            n_queries += 1
            out.write("\tquery\n")
    finally:
        if args.output:
            out.close()
    if args.bca:
        with BCAWriter(args.bca) as w:
            for _j, c in kept:
                w.write_chain(c)
    print(f"{len(kept)} queries kept", file=sys.stderr)
    return 0


def cmd_msa_score(args) -> int:
    """-lddt_msa / -daliscore_msa (src/lddt_msa.cpp:10-62,
    src/daliscore_msa.cpp): score every chain pair of an MSA against the
    structures; prints per-pair values and the mean."""
    from reseek_tpu.benchmarks.msa import score_msa
    from reseek_tpu.io.reader import read_chains

    chains = read_chains(args.input)
    rows, mean = score_msa(args.msa, chains, metric=args.metric,
                           core=args.core)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        sum_score = 0.0
        for l1, l2, v in rows:
            if v is None:
                out.write(f"{l1}\t{l2}\tERROR_structure_not_found\n")
            elif args.metric == "lddt":
                out.write("%s\t%s\t%.4f\n" % (l1, l2, v))
            else:
                s, z = v
                sum_score += s
                out.write("%s\t%s\t%.3g\t%.1f\n" % (l1, l2, s, z))
        # summary uses the MSA stem name and, for DALI, the TOTAL score
        # (GetStemName + GetSumScore_Rows, src/daliscore_msa.cpp:25-49) —
        # golden-tested vs the binary on the msta fixture
        name = os.path.splitext(os.path.basename(args.msa))[0]
        if args.metric == "lddt":
            out.write("LDDT=%.4f\tMSA=%s\n" % (mean, name))
        else:
            out.write("Z=%.1f\tScore=%.1f\tMSA=%s\n"
                      % (mean, sum_score, name))
    finally:
        if args.output:
            out.close()
    print("%s mean %.4f over %d pairs"
          % (args.metric, mean, sum(v is not None for _, _, v in rows)),
          file=sys.stderr)
    return 0


def cmd_train_features(args) -> int:
    """-train_features (src/train_features.cpp): count aligned
    feature-pair frequencies from trusted alignments, emit log-odds
    matrices in the WriteLOInt8 layout."""
    from reseek_tpu.benchmarks.train import train_features, write_trained
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.reader import read_chains

    feats = (args.features.split(",") if args.features
             else list(DSSParams.create("sensitive").features))
    chains = read_chains(args.input)
    los = train_features(chains, args.alns, feats)
    with open(args.output, "w") as f:
        write_trained(f, los)
    print(f"{len(feats)} features trained on {len(chains)} chains",
          file=sys.stderr)
    return 0


def cmd_fit_gumbel(args) -> int:
    """Fit Scale*Gumbel(mu, beta) to a histogram file; input format of
    cmd_fit_gumbel (src/gumbel.cpp:253-283): first line `x0<TAB>dx`, then
    one y value per line; ys normalized to sum 1."""
    from reseek_tpu.benchmarks.calibrate import fit_gumbel
    with open(args.input) as f:
        lines = [line.strip() for line in f if line.strip()]
    x0, dx = (float(v) for v in lines[0].split("\t"))
    ys = np.array([float(v) for v in lines[1:]], np.float64)
    ys = ys / ys.sum()
    xs = x0 + dx * np.arange(len(ys))
    mu, beta, scale = fit_gumbel(xs, ys)
    print(f"mu={mu:.6g} beta={beta:.6g} scale={scale:.6g}")
    return 0


def cmd_calibrate(args) -> int:
    """P-value model calibration from an all-vs-all search of a decoy set
    (cmd_calibrate, src/calibrate.cpp:12-60 + src/gumbel.cpp): runs the
    search, histograms the test statistics, fits Gumbel + the two-piece
    log-linear StatSig model, and prints the fitted constants next to the
    shipped ones (src/statsig.cpp:27-44)."""
    import io as _io

    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.benchmarks.calibrate import (fit_gumbel, fit_log_linear,
                                                 gumbel_cdf)
    from reseek_tpu.constants import DSSParams, StatSig
    from reseek_tpu.io.reader import read_chains
    from reseek_tpu.search.driver import SearchOptions, self_search

    mode = _mode_from_args(args, default="fast")
    params = DSSParams.create(mode)
    chains = [c for c in read_chains(args.input) if len(c) >= 1]
    options = SearchOptions(columns=parse_columns("query+target+newts"),
                            max_evalue=float("inf"), mode=mode,
                            scores_are_not_evalues=True)
    buf = _io.StringIO()
    self_search(chains, params, options, buf, engine=args.engine)
    ts_vals = []
    for line in buf.getvalue().splitlines():
        q, t, ts = line.split("\t")
        if q != t:           # self pairs are not decoys
            ts_vals.append(float(ts))
    ts = np.asarray(ts_vals, np.float64)
    if len(ts) < 10:
        raise SystemExit("too few aligned pairs to calibrate")
    # histogram (the reference bins per chain then accumulates; a global
    # TS histogram gives the same fitted curve family)
    nbins = 32
    ys, edges = np.histogram(ts, bins=nbins)
    xs = (edges[:-1] + edges[1:]) / 2
    mu, beta, scale = fit_gumbel(xs, ys / max(ys.sum(), 1))
    fit = fit_log_linear(ts, n_queries=len(chains))
    print(f"gumbel: mu={mu:.6g} beta={beta:.6g}")
    print(f"loglinear: x1={fit.x1:.6g} m0={fit.m0:.6g} c0={fit.c0:.6g} "
          f"m={fit.m:.6g} c={fit.c:.6g}")
    print(f"shipped:   x1={StatSig.X1:.6g} m0={StatSig.M0:.6g} "
          f"c0={StatSig.C0:.6g} m={StatSig.M:.6g} c={StatSig.C:.6g}")
    if args.output:
        with open(args.output, "w") as f:
            f.write("%.6g\t%.6g\n" % (xs[0], xs[1] - xs[0]))
            for y in ys:
                f.write("%d\n" % y)
            f.write("# gumbel mu=%.6g beta=%.6g\n" % (mu, beta))
            f.write("# P(TS>=t) fit: x1=%.6g m0=%.6g c0=%.6g m=%.6g "
                    "c=%.6g\n" % (fit.x1, fit.m0, fit.c0, fit.m, fit.c))
    return 0


def cmd_chains2pdbs(args) -> int:
    """Write each chain to its own PDB file (src/chains2pdbs.cpp)."""
    import os
    from reseek_tpu.io.pdb import write_pdb
    from reseek_tpu.io.reader import read_chains
    os.makedirs(args.outdir, exist_ok=True)
    n = 0
    for c in read_chains(args.input):
        safe = c.label.replace("/", "_")
        with open(os.path.join(args.outdir, safe + ".pdb"), "w") as f:
            write_pdb(c, f)
        n += 1
    print(f"{n} chains written", file=sys.stderr)
    return 0


def cmd_getchains(args) -> int:
    """List chain labels and lengths."""
    from reseek_tpu.io.reader import read_chains
    for c in read_chains(args.input):
        print(f"{c.label}\t{len(c)}")
    return 0


def cmd_tracealn(args) -> int:
    """-tracealn (src/tracealn.cpp:11-89): per-pair pipeline trace of
    every query x target pair in DEFAULT FAST params, logged in the
    reference's exact format (golden-tested vs the reference binary's
    -log output on q10 x q10)."""
    from reseek_tpu.align.mkf import should_use_mkf
    from reseek_tpu.align.pipeline import (FLT_MAX, PairAligner,
                                           encode_for_search)
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.reader import read_chains
    from reseek_tpu.utils.logger import open_log

    lg = open_log(args.log)
    params = DSSParams.create("fast")
    pa = PairAligner(params)
    qs = [encode_for_search(c, params, with_self_rev=True)
          for c in read_chains(args.input)]
    ts = [encode_for_search(c, params, with_self_rev=True)
          for c in read_chains(args.db)]
    for q in qs:
        for t in ts:
            lg.log("\n______________________________________________\n")
            lg.log("Q>%s(%u)\n" % (q.label, len(q)))
            lg.log("T>%s(%u)\n" % (t.label, len(t)))
            lg.log("SelfRevScoreQ=%.1f\n" % q.self_rev_score)
            lg.log("SelfRevScoreT=%.1f\n" % t.self_rev_score)
            res = pa.align(q, t)
            path = res.path if res is not None else ""
            fwd = res.fwd_score if res is not None else 0.0
            e = res.evalue if res is not None else FLT_MAX
            lg.log("Path=(%u)%.10s...\n" % (len(path), path[:10]))
            if e > 1e5:
                lg.log("EvalueA=%.3g\n" % e)
            else:
                lg.log("EvalueA=%.1f\n" % e)
            lg.log("AlnFwdScore=%.3g\n" % fwd)
            do_mkf = should_use_mkf(q, t, params)
            lg.log("DoMKF=%c\n" % ("T" if do_mkf else "F"))
            if do_mkf:
                lg.log("m_MKF.BestChainScore=%d\n"
                       % (res.best_chain_score if res else 0))
                lg.log("m_XDropScore=%.1f\n" % fwd)
            lg.log("Omega=%.1f\n" % params.omega)
            lg.log("DoMuFilter=%c\n" % ("T" if params.omega > 0 else "F"))
            ok = pa.mu_filter(q, t)
            lg.log("MuFilterOk=%c\n" % ("T" if ok else "F"))
    return 0


def cmd_feature_stats(args) -> int:
    """-feature_stats (src/features.cpp:59-71): list the feature registry
    with trained-score-matrix availability (golden vs the binary)."""
    import numpy as np
    from reseek_tpu.constants import ALL_FEATURES
    from reseek_tpu.data.tables import _NPZ
    trained = {k[:-5] for k in np.load(_NPZ).files if k.endswith("_S_ij")}
    for i, name in enumerate(ALL_FEATURES):
        line = "[%2u]  %s" % (i, name)
        if name not in trained:
            line += "  < missing scoremx"
        print(line)
    return 0


def cmd_test_gumbel(args) -> int:
    """-test_gumbel (src/gumbel.cpp:230-251): self-test of the Gumbel
    fitter — generate gumbel(mu=1.3, beta=0.8) on [-5, 20) step 0.1, fit,
    print the recovered parameters.  NOTE: the reference binary's own
    command currently dies upstream on its normalization assert
    (src/gumbel.cpp:122 `feq(Sum, 1)`); this port fixes that and is
    checked by parameter recovery instead of output parity."""
    import numpy as np
    from reseek_tpu.benchmarks.calibrate import fit_gumbel, gumbel_pdf
    xs = np.arange(-5.0, 20.0, 0.1)
    ys = gumbel_pdf(1.3, 0.8, xs)
    mu, beta, scale = fit_gumbel(xs, ys)
    print("FitScale %.3g, FitMu %.3g, FitBeta %.3g" % (scale, mu, beta))
    return 0


def cmd_scop40tsv2bit(args) -> int:
    """-scop40tsv2bit (src/scop40benchroc.cpp:760-770): structures give
    the dom list (labels `dom/cls.fold.sf.fam`), a hits TSV gives scored
    pairs; writes the binary .bit hit dump and prints hit count +
    sensitivity-to-first-FP.  NOTE: the reference binary's own command
    segfaults upstream (SCOP40Bench::LoadDB invoked without search
    params); this port is validated by .bit round-trip + Scop40Eval
    self-consistency instead of output parity."""
    from reseek_tpu.benchmarks.scop40 import Scop40Eval, write_bit
    from reseek_tpu.io.reader import read_chains

    chains = read_chains(args.input)
    doms, dom2scopid = [], {}
    for c in chains:
        dom, _, scopid = c.label.partition("/")
        doms.append(dom)
        dom2scopid[dom] = scopid
    idx = {d: i for i, d in enumerate(doms)}
    score_col = (args.scorefieldnr - 1) if args.scorefieldnr else 2
    d1, d2, sc = [], [], []
    with open(args.hits) as f:
        for line in f:
            fields = line.rstrip("\n").split("\t")
            a = fields[0].partition("/")[0]
            b = fields[1].partition("/")[0]
            if a not in idx or b not in idx:
                raise SystemExit(f"unknown dom in hits: {a} {b}")
            d1.append(idx[a])
            d2.append(idx[b])
            sc.append(float(fields[score_col]))
    if args.output:
        write_bit(args.output, len(doms), d1, d2, sc)
    ev = Scop40Eval(dom2scopid)
    res = ev.evaluate((doms[a], doms[b], s)
                      for a, b, s in zip(d1, d2, sc))
    print(f"{len(d1)} hits, Sens1FP {res.n_first_fp}")
    return 0


def cmd_lddt_bench(args) -> int:
    """-lddt_bench (src/lddt_bench.cpp:14-119): mean GetLDDT_mu_fast over
    all MSA sequence pairs (column maps treat only '-' as gap, matching
    the reference's raw row scan); prints `LDDT=%.4f MSA=%s`.  The
    reference runs 20 timing iterations; the score is iteration-
    independent so one pass is reported (it is a kernel benchmark)."""
    import numpy as np
    from reseek_tpu.benchmarks.msa import read_msa_fasta
    from reseek_tpu.io.reader import read_chains
    from reseek_tpu.ops.lddt import lddt_mu_fast_np

    msa = read_msa_fasta(args.msa)
    chains = {c.label: c for c in read_chains(args.input)}
    name = os.path.splitext(os.path.basename(args.msa))[0]
    total, count = 0.0, 0
    for i in range(len(msa)):
        li, ri = msa[i]
        for j in range(i + 1, len(msa)):
            lj, rj = msa[j]
            if li not in chains or lj not in chains:
                raise SystemExit(f"structure_not_found {li} {lj}")
            p1, p2 = [], []
            a = b = 0
            for c1, c2 in zip(ri, rj):
                if c1 != "-" and c2 != "-":
                    p1.append(a)
                    p2.append(b)
                if c1 != "-":
                    a += 1
                if c2 != "-":
                    b += 1
            total += lddt_mu_fast_np(chains[li].coords, chains[lj].coords,
                                     np.array(p1, np.int64),
                                     np.array(p2, np.int64))
            count += 1
    lddt = total / count if count else 0.0
    print("LDDT=%.4f MSA=%s" % (lddt, name))
    return 0




_MUW_COLORS3 = {"h": "0,150,20", "s": "150,0,50", "t": "250,150,0",
                "~": "150,150,150", "-": "255,255,255"}


def _muw_smooth_s3(s3: list) -> None:
    """SmoothS3 (src/msta_lddtmuw.cpp:159-193): isolated h/s columns take
    their neighbors' class (or '~' when neighbors disagree)."""
    n = len(s3)
    for col in range(n):
        c3 = s3[col]
        if c3 not in ("s", "h"):
            continue
        prev = next_ = None
        for i in range(col - 1, -1, -1):
            if s3[i] not in "-.":
                prev = s3[i]
                break
        for i in range(col + 1, n):
            if s3[i] not in "-.":
                next_ = s3[i]
                break
        if prev is None or next_ is None:
            continue
        if prev != c3 and next_ != c3:
            s3[col] = prev if prev == next_ else "~"


def cmd_msta_lddtmuw(args) -> int:
    """-msta_lddtmuw (src/msta_lddtmuw.cpp:196-325): per-column windowed
    LDDT of an MSA; writes a Jalview BAR_GRAPH annotation colored by the
    SS3 consensus (--lddtmuw-jalview) and/or a PyMOL coloring script for
    one query (--label + --lddtmuw-pymol).  Golden-tested vs the binary
    on the msta fixture."""
    import numpy as np
    from reseek_tpu.benchmarks.msa import lddt_muw_setup
    from reseek_tpu.encoder.dss import (BAND_W, _banded_distances,
                                        compute_ss)
    from reseek_tpu.io.reader import read_chains

    if args.lddtmuw_pymol and not args.label:
        raise SystemExit("--lddtmuw-pymol requires --label")
    chains = read_chains(args.input)
    if len(chains) < 2:
        raise SystemExit(f"need >= 2 structures in {args.input}")
    muw = lddt_muw_setup(args.msa, chains)
    w = args.window
    n_cols = len(muw.msa[0][1]) if muw.msa else 0
    scores = [muw.col_score(col, w) for col in range(n_cols)]

    if args.lddtmuw_jalview:
        # SS3 consensus per column over the SS-mapped MSA rows
        ss_rows = []
        for s, (_label, row) in enumerate(muw.msa):
            if s not in muw.matched:
                continue
            c = muw.matched[s]
            ss = "".join("hst~"[v] for v in compute_ss(
                c.coords, _banded_distances(c.coords, BAND_W)))
            out_row = []
            pos = 0
            for ch in row:
                if ch in "-.":
                    out_row.append(ch)
                else:
                    out_row.append(ss[pos])
                    pos += 1
            ss_rows.append(out_row)
        s3 = []
        for col in range(n_cols):
            counts = {k: 0 for k in "hst~"}
            for r in ss_rows:
                if r[col] in counts:
                    counts[r[col]] += 1
            best, bc = "-", 0
            for k in "hst~":
                if counts[k] > bc:
                    bc = counts[k]
                    best = k
            s3.append(best)
        _muw_smooth_s3(s3)
        with open(args.lddtmuw_jalview, "w") as f:
            f.write("JALVIEW_ANNOTATION\n")
            f.write("BAR_GRAPH\tLDDT-muw\t")
            f.write("|".join("%.3f[%s]" % (scores[col],
                                           _MUW_COLORS3[s3[col]])
                             for col in range(n_cols)))
            f.write("\n")

    if args.label:
        thresholds = [0.1 * k for k in range(1, 10)]

        def get_bin(v):
            for i, t in enumerate(thresholds):
                if v <= t:
                    return i
            return len(thresholds)

        q = next((s for s, (l, _r) in enumerate(muw.msa)
                  if l == args.label), None)
        if q is None:
            raise SystemExit(f"label {args.label} not in MSA")
        row = muw.msa[q][1]
        bins = [get_bin(scores[col]) for col, ch in enumerate(row)
                if ch not in "-."]
        if args.lddtmuw_pymol and bins:
            with open(args.lddtmuw_pymol, "w") as f:
                f.write("select tmp, all\ncolor br0, tmp\n")
                start, cur = 0, bins[0]
                for pos in range(1, len(bins)):
                    if bins[pos] != cur:
                        f.write(f"select tmp, resi {start + 1}-{pos}\n")
                        f.write(f"color br{cur}, tmp\n")
                        start, cur = pos, bins[pos]
                f.write(f"select tmp, resi {start + 1}-{len(bins)}\n")
                f.write(f"color br{cur}, tmp\nselect none\n")
    return 0


def cmd_msta_lddtmuw1(args) -> int:
    """-msta_lddtmuw1 (src/msta_lddtmuw1.cpp:143-239): per-position
    windowed LDDT of one query sequence vs the rest of the MSA, with the
    reference's quirk REPLICATED: the query position (not the column
    index) is passed as the column to GetLDDTMuW1, so positions are
    looked up at column = ungapped query position.  Golden-tested."""
    from reseek_tpu.benchmarks.msa import lddt_muw_setup
    from reseek_tpu.io.reader import read_chains

    chains = read_chains(args.input)
    muw = lddt_muw_setup(args.msa, chains)
    q = next((s for s, (l, _r) in enumerate(muw.msa)
              if l == args.label), None)
    if q is None:
        raise SystemExit(f"label {args.label} not in MSA")
    row = muw.msa[q][1]
    qseq = "".join(ch for ch in row if ch not in "-.").upper()

    def symbol(v):
        if v == 0:
            return " "
        if v < 0.2:
            return "."
        if v < 0.5:
            return ":"
        if v < 0.75:
            return "|"
        return "@"

    out = open(args.output, "w") if args.output else sys.stdout
    try:
        vals = []
        pos_q = 0
        for ch in row:
            if ch in "-.":
                continue
            v = muw.query_score(q, pos_q, args.window)  # quirk: col=pos
            out.write("%u  %c  %.4f\n" % (pos_q, ch, v))
            vals.append(v)
            pos_q += 1
        out.write(qseq + "\n")
        out.write("".join(symbol(v) for v in vals) + "\n")
    finally:
        if args.output:
            out.close()
    return 0


def cmd_mudex(args) -> int:
    """-mudex (src/mudex.cpp:540-599): k-mer index diagnostics over a Mu
    FASTA — dictionary-wide self-score quartiles (exact, via 5-fold
    convolution of the diagonal-score histogram instead of sorting the
    60,466,176-entry array) and the occupancy histogram by max-letter
    multiplicity.  Output matches the reference binary on q100.mu.fa
    (golden-tested)."""
    import numpy as np
    from reseek_tpu.data.tables import get_tables
    from reseek_tpu.search.prefilter import (K_SPAN, OFFSETS,
                                             read_mu_fasta)
    from reseek_tpu.utils.logger import open_log

    lg = open_log(args.log)
    _labels, mus = read_mu_fasta(args.input)

    diag = np.diag(get_tables().mu_prefilter_mx_int8)[:36].astype(np.int64)
    # distribution of SelfScore over the full 36^5 dictionary: 5-fold
    # convolution of the per-letter diagonal histogram
    hist = np.bincount(diag, minlength=int(diag.max()) + 1)
    dist = np.array([1], np.int64)
    for _ in range(5):
        dist = np.convolve(dist, hist)
    n_total = int(dist.sum())
    assert n_total == 36 ** 5
    cum = np.cumsum(dist)
    scores = np.arange(len(dist))

    def at(rank):  # sorted-array index semantics of GetQuarts
        return int(scores[np.searchsorted(cum, rank + 1)])

    total = int((scores * dist).sum())
    mn = int(scores[np.flatnonzero(dist)[0]])
    mx = int(scores[np.flatnonzero(dist)[-1]])
    lg.log("SelfScores: N=%u, Min=%u, LoQ=%u, Med=%u, HiQ=%u, Max=%u, "
           "Avg=%g\n" % (n_total, mn, at(n_total // 4),
                         at(n_total // 2), at(3 * n_total // 4), mx,
                         total / n_total))
    print("Validate OK")

    # occupancy by max letter multiplicity of the UNMASKED spaced k-mers
    # (cmd_mudex builds the index before self-score masking)
    counts = np.zeros(6, np.int64)
    for mu in mus:
        lets = np.asarray(mu, np.int64)
        n = len(lets) - K_SPAN + 1
        if n <= 0:
            continue
        cols = np.stack([lets[o: o + n] for o in OFFSETS])  # [5, n]
        maxmult = np.zeros(n, np.int64)
        for letter in range(36):
            maxmult = np.maximum(maxmult, (cols == letter).sum(axis=0))
        counts += np.bincount(np.maximum(maxmult, 1), minlength=6)
    total_k = int(counts.sum())
    for i in range(1, 6):
        pct = 100.0 * counts[i] / total_k if total_k else 0.0
        print("Max letters [%u] = %u (%.1f%%)" % (i, counts[i], pct))
    return 0


def cmd_daliscore_msas2(args) -> int:
    """-daliscore_msas2 (src/daliscore_msas2.cpp:6-132): A/B-compare two
    test directories of MSAs by total DALI score and mean Z per
    accession.  Output format byte-identical to the reference on the
    msta fixture, INCLUDING its quirks (duplicated z2 field, norm1/norm2
    fields printing the raw scores, and the dead negative-score
    clamping branches are semantics-preserved)."""
    import os as _os

    from reseek_tpu.benchmarks.msa import dali_score, dali_z
    from reseek_tpu.io.reader import read_chains

    chains = read_chains(args.input)
    with open(args.accs) as f:
        accs = [ln.strip() for ln in f if ln.strip()]
    td1 = args.testdir.rstrip("/") + "/"
    td2 = args.testdir2.rstrip("/") + "/"
    out = open(args.output, "w") if args.output else None

    def score_z(fn):
        msa, _core, matched, maps = _msta_setup(fn, chains, args.core)
        total = z_sum = 0.0
        n = 0
        for i in range(len(msa)):
            for j in range(i + 1, len(msa)):
                if i not in matched or j not in matched:
                    continue
                ci, cj = matched[i], matched[j]
                both = (maps[i] >= 0) & (maps[j] >= 0)
                s = dali_score(ci, cj, maps[i][both], maps[j][both])
                total += s
                z_sum += dali_z(s, len(ci), len(cj))
                n += 1
        return total, (z_sum / n if n else 0.0)

    n1 = n2 = ntie = 0
    sum1 = sum2 = sum_z1 = sum_z2 = 0.0
    try:
        for fn in accs:
            s1, z1 = score_z(td1 + fn)
            s2, z2 = score_z(td2 + fn)
            sum_z1 += z1
            sum_z2 += z2
            if s1 == s2:
                ntie += 1
            elif s1 > s2:
                n1 += 1
            else:
                n2 += 1
            # dead clamping branches replicated (daliscore_msas2.cpp:
            # 85-94: the first subtracts zero, the second zeroes s1)
            if s1 < 0:
                s1 = 0.0
            if s2 < 0:
                s2 = 0.0
                s1 = 0.0
            norm1 = s1 / (s1 + s2 + 1)
            norm2 = s2 / (s1 + s2 + 1)
            sum1 += norm1
            sum2 += norm2
            if out is not None:
                out.write("aln=%s\tscore1=%.1f\tscore2=%.1f\tz1=%.1f"
                          "\tz2=%.1f\tz2=%.1f\tnorm1=%.1f\tnorm2=%.1f\n"
                          % (fn, s1, s2, z1, z2, z2, s1, s2))
        n = len(accs)
        if out is not None and n:
            out.write("testdir1=%s\ttestdir2=%s\tn1better=%u"
                      "\tn2better=%u\tntie=%u\tavg1=%.8f\tavg2=%.8f"
                      "\tZ1=%.2f\tZ2=%.2f\n"
                      % (td1, td2, n1, n2, ntie, sum1 / n, sum2 / n,
                         sum_z1 / n, sum_z2 / n))
    finally:
        if out is not None:
            out.close()
    return 0


def cmd_calibrate2(args) -> int:
    """-calibrate2 (src/calibrate2.cpp:55-142): fit the P-value model
    from a labeled all-vs-all benchmark — ROC steps over TS, FP rate
    P(FP | TS >= t) = NFP/NQ^2 for thresholds with NFP in
    [NQ/100, NQ*100], linear fit of TS to -log(P) (f32 LinearFit,
    src/calibrate2.cpp:19-52).  Prints `Linear fit to -log(P) m=.. b=..`
    and the optional 5-column table.

    NOTE: the reference binary's own command dies upstream
    (scop40benchroc.cpp:295 `SIZE(m_TSs) == HitCount` — the TS record
    path is not populated on this code path), so this port is validated
    by self-consistency; when the reference's ROC-step smoothing
    (SmoothROCSteps: <=100 subsampled points under --maxfpr) has too few
    steps, it falls back to the raw in-window steps with a warning
    instead of fitting an empty list (the reference would produce NaN)."""
    import io as _io

    import numpy as np
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.reader import read_chains
    from reseek_tpu.search.driver import SearchOptions, self_search

    params = DSSParams.create("fast")  # DM_DefaultFast
    chains = read_chains(args.input)
    doms = [c.label.partition("/")[0] for c in chains]
    scopids = {c.label.partition("/")[0]: c.label.partition("/")[2]
               for c in chains}
    level = args.benchlevel

    def group(d):
        parts = scopids[d].split(".")
        return ".".join(parts[:3] if level == "sf" else parts[:2])

    nq = len(doms)
    from collections import Counter
    cnt = Counter(group(d) for d in doms)
    nt = sum(k * (k - 1) for k in cnt.values())
    nf = nq * (nq - 1) - nt

    options = SearchOptions(columns=parse_columns("query+target+newts"),
                            max_evalue=10.0, mode="fast")
    buf = _io.StringIO()
    self_search(chains, params, options, buf, engine=args.engine)
    hits = []
    for line in buf.getvalue().splitlines():
        q, t, ts = line.split("\t")
        hits.append((q.partition("/")[0], t.partition("/")[0], float(ts)))

    # GetROCSteps over TS descending (scop40benchroc.cpp:454-513)
    hits.sort(key=lambda h: -h[2])
    steps_ts, steps_ntp, steps_nfp = [], [], []
    cur = hits[0][2] if hits else 0.0
    ntp = nfp = 0
    for q, t, ts in hits:
        if q == t:
            continue
        if ts != cur:
            steps_ts.append(cur)
            steps_ntp.append(ntp)
            steps_nfp.append(nfp)
            cur = ts
        if group(q) == group(t):
            ntp += 1
        else:
            nfp += 1
    steps_ts.append(cur)
    steps_ntp.append(ntp)
    steps_nfp.append(nfp)

    # SmoothROCSteps (scop40benchroc.cpp:393-453): subsample to <=100
    # points below MaxFPR
    max_fpr = args.maxfpr if args.maxfpr is not None else 0.005
    ns = len(steps_ts)
    n = ns - 1
    for i in range(ns):
        if steps_nfp[i] / nf >= max_fpr:
            n = i
            break
    idxs = None
    if ns >= 100 and n >= 200:
        nbins = 100
        idxs = [0] + [(b * n) // nbins for b in range(1, nbins - 1)] \
            + [n - 1]
    else:
        print(f"warning: only {n} ROC steps below FPR {max_fpr:g}; "
              "fitting raw in-window steps (the reference's smoothing "
              "needs >= 200)", file=sys.stderr)
        idxs = list(range(max(n, 1)))

    tss, ps = [], []
    for i in idxs:
        nfp_i = steps_nfp[i]
        if nfp_i < nq // 100:
            continue
        if nfp_i > nq * 100:
            break
        tss.append(np.float32(steps_ts[i]))
        ps.append(np.float32(nfp_i / float(nq * nq)))
    if len(tss) < 2:
        raise SystemExit("too few thresholds in the NFP window to fit")
    mlp = [np.float32(-np.log(p)) for p in ps]

    # LinearFit, f32 accumulation (src/calibrate2.cpp:19-52)
    sx = sx2 = sy = sxy = np.float32(0.0)
    for x, y in zip(tss, mlp):
        sx += x
        sx2 += x * x
        sy += y
        sxy += x * y
    nn = np.float32(len(tss))
    m = np.float32((nn * sxy - sx * sy) / (nn * sx2 - sx * sx))
    b = np.float32(sy / nn - m * (sx / nn))
    print("Linear fit to -log(P) m=%.3g b=%.3g" % (m, b))

    if args.output:
        with open(args.output, "w") as f:
            f.write("TS\tP\tMinusLogP\tMinusLogP_fit\tP_fit\n")
            for x, p, y in zip(tss, ps, mlp):
                yfit = np.float32(m * x + b)
                f.write("%.4g\t%.4g\t%.4g\t%.4g\t%.4g\n"
                        % (x, p, y, yfit, np.float32(np.exp(-yfit))))
    return 0


def cmd_binner(args) -> int:
    """-binner (src/binner.cpp:5-67): histogram a TSV column (optionally
    log10) into N bins; writes histogram / cumulative / reverse-
    cumulative TSVs and prints the QuartsFloat summary, byte-identical
    to the reference (Binner semantics src/binner.h:123-165: clamp to
    [min, max], bin = r*(BinCount-1), mids from BinSize=range/BinCount)."""
    import numpy as np

    field = (args.fieldnr - 1) if args.fieldnr else 0
    vals = []
    with open(args.input) as f:
        for line in f:
            v = np.float32(line.rstrip("\n").split("\t")[field])
            if args.log10:
                v = (np.float32(-20.0) if v < 1e-20
                     else np.float32(np.log10(v)))
            vals.append(v)
    v = np.array(vals, np.float32)
    sv = np.sort(v)
    n = len(sv)
    total = np.float32(0.0)
    for x in sv:
        total += x
    mean = np.float32(total / n) if n else np.float32(0)
    # QuartsFloat::WriteMe(stderr) format (src/quarts.h:99-110; the
    # StdDev field only goes to the log via LogMe)
    print("Min=%.3g, LoQ=%.3g, Med=%.3g, HiQ=%.3g, Max=%.3g, Avg=%.3g"
          % (sv[0], sv[n // 4], sv[n // 2], sv[3 * n // 4], sv[-1],
             mean), file=sys.stderr)

    lo = np.float32(args.minval) if args.minval is not None else sv[0]
    hi = np.float32(args.maxval) if args.maxval is not None else sv[-1]
    bins = args.bins
    rng = np.float32(hi - lo)
    clamped = np.clip(v, lo, hi)
    idx = ((clamped - lo) / rng * np.float32(bins - 1)).astype(np.uint32)
    counts = np.bincount(idx, minlength=bins)
    size = np.float32(rng / np.float32(bins))
    mids = [np.float32(lo + np.float32(b) * size + size / np.float32(2))
            for b in range(bins)]

    def write(path, ns, blank_zero):
        if not path:
            return
        with open(path, "w") as f:
            for b in range(bins):
                nn = int(ns[b])
                if blank_zero and nn == 0:
                    f.write("%u\t%.4g\t\n" % (b, mids[b]))
                else:
                    f.write("%u\t%.4g\t%u\n" % (b, mids[b], nn))

    write(args.output, counts, False)
    write(args.accum, np.cumsum(counts), True)
    write(args.accumrev, np.cumsum(counts[::-1])[::-1], True)
    return 0


def cmd_msa2cmp(args) -> int:
    """-msa2cmp (src/msa2cmp.cpp:51-230): contact-map profile from an
    MSA + structures — header, gap-mapped MSA rows, low-gap profile
    rows, then the mean (lower triangle) / stddev (upper) distance
    matrix over aligned pairs.  Float accumulation follows the
    reference's QuartsFloat exactly (f32 sums over ASCENDING-sorted
    distances, population stddev) so %.3g output is byte-identical."""
    import numpy as np
    from reseek_tpu.benchmarks.msa import read_msa_fasta
    from reseek_tpu.io.reader import read_chains

    msa = read_msa_fasta(args.msa)
    chains = {c.label: c for c in read_chains(args.input)}
    n_seq = len(msa)
    col_to_pos, chain_of = [], []
    for label, row in msa:
        if label not in chains:
            raise SystemExit(f"Label not found in chains >{label}")
        c = chains[label]
        ungapped = sum(1 for ch in row if ch not in "-.")
        if ungapped != len(c):
            raise SystemExit(f"Lengths disagree {ungapped}, {len(c)} "
                             f"> {label}")
        chain_of.append(c)
        ctp, pos = [], 0
        for ch in row:
            if ch in "-.":
                ctp.append(-1)
            else:
                ctp.append(pos)
                pos += 1
        col_to_pos.append(np.array(ctp, np.int64))

    n_cols = len(msa[0][1])
    max_gap = (args.maxgappct / 100.0 if args.maxgappct is not None
               else 0.2)
    prof_cols = []
    for col in range(n_cols):
        gaps = sum(1 for _l, row in msa if row[col] in "-.")
        if gaps / n_seq <= max_gap:
            prof_cols.append(col)
    n_prof = len(prof_cols)
    print("%u chains, %u / %u prof cols (%.1f%%)"
          % (n_seq, n_prof, n_cols,
             100.0 * n_prof / n_cols if n_cols else 0.0),
          file=sys.stderr)

    mean = np.zeros((n_prof, n_prof))
    sdev = np.zeros((n_prof, n_prof))
    for i1 in range(n_prof):
        c1 = prof_cols[i1]
        for i2 in range(i1 + 1, n_prof):
            c2 = prof_cols[i2]
            dists = []
            for s in range(n_seq):
                p1 = col_to_pos[s][c1]
                p2 = col_to_pos[s][c2]
                if p1 >= 0 and p2 >= 0:
                    # PDBChain::GetDist float path as compiled with GCC
                    # FMA contraction: dy*dy rounded, then two fused
                    # multiply-adds, f32 sqrt (src/abcxyz.h:116-126;
                    # same recipe as ops/lddt.py d2mat / fp.py)
                    from reseek_tpu.fp import fma32
                    a = chain_of[s].coords[int(p1)]
                    b = chain_of[s].coords[int(p2)]
                    dx, dy, dz = a[0] - b[0], a[1] - b[1], a[2] - b[2]
                    d2 = fma32(dz, dz, fma32(dx, dx,
                                             np.float32(dy * dy)))
                    dists.append(np.float32(np.sqrt(d2)))
            if dists:
                v = np.sort(np.array(dists, np.float32))
                total = np.float32(0.0)
                for x in v:
                    total += x
                m = np.float32(total / len(v))
                sumd = np.float32(0.0)
                for x in v:
                    d = (x - m) * (x - m)
                    sumd += d
                mean[i1, i2] = mean[i2, i1] = float(m)
                sdev[i1, i2] = sdev[i2, i1] = float(
                    np.sqrt(np.float32(sumd / len(v))))
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        out.write("%u\t%u\t%u\n" % (n_seq, n_cols, n_prof))
        for rows_cols in (range(n_cols), prof_cols):
            for s in range(n_seq):
                seq = chain_of[s].seq
                out.write("%u\t%s\t" % (s, chain_of[s].label))
                out.write("".join(
                    "-" if col_to_pos[s][col] < 0
                    else seq[col_to_pos[s][col]] for col in rows_cols))
                out.write("\n")
        for c1 in range(n_prof):
            out.write("%u" % c1)
            for c2 in range(n_prof):
                if c2 == c1:
                    out.write("\t*")
                elif c1 > c2:
                    out.write("\t%.3g" % mean[c1, c2])
                else:
                    out.write("\t%.3g" % sdev[c1, c2])
            out.write("\n")
    finally:
        if args.output:
            out.close()
    return 0


def cmd_scan_files(args) -> int:
    """-scan_files (src/pdbfilescanner.cpp:138-162): list every structure
    file the scanner finds under a directory / .files list."""
    from reseek_tpu.io.reader import scan_structure_files
    files = scan_structure_files(args.input)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for fn in files:
            out.write(fn + "\n")
    finally:
        if args.output:
            out.close()
    print(f"{len(files)} files total", file=sys.stderr)
    return 0


def cmd_test_xdrop(args) -> int:
    """-test_xdrop (src/test_xdrop.cpp:78-187): x-drop fwd/bwd extension
    self-test on three BLOSUM62 string pairs, byte-identical log output
    to the reference binary (including its display quirks: the Fwd
    alignment is logged one position off its true start, and the merged
    path keeps the seed column both sides)."""
    from reseek_tpu.align.mkf import xdrop_fwd, xdrop_bwd
    from reseek_tpu.data.blosum62 import char_subst_mx
    from reseek_tpu.ops.sw_np import sw_align
    from reseek_tpu.utils.logger import open_log

    lg = open_log(args.log)
    b62 = char_subst_mx()

    def log_aln(a, b, lo_a, lo_b, open_, ext, path):
        if not path:
            return
        pa, pb = lo_a, lo_b
        row_a, row_b = [], []
        score = np.float32(0.0)
        for col, c in enumerate(path):
            if c == "M":
                score += np.float32(b62[ord(a[pa]), ord(b[pb])])
                row_a.append(a[pa]); pa += 1
                row_b.append(b[pb]); pb += 1
            elif c == "D":
                score += np.float32(
                    ext if col and path[col - 1] == "D" else open_)
                row_a.append(a[pa]); pa += 1
                row_b.append("-")
            else:
                score += np.float32(
                    ext if col and path[col - 1] == "I" else open_)
                row_a.append("-")
                row_b.append(b[pb]); pb += 1
        lg.log("\n%s\n%s\nScore %.3g\n"
               % ("".join(row_a), "".join(row_b), score))

    def test(a, b):
        open_, ext, x = -3.0, -1.0, 8.0
        la, lb = len(a), len(b)
        smx = np.empty((la, lb), np.float32)
        for i in range(la):
            for j in range(lb):
                smx[i, j] = b62[ord(a[i]), ord(b[j])]

        def scorer(pa, pb):
            return np.float32(smx[pa, pb])

        lg.log("______________________________SWFast"
               "________________________\n")
        sw_score, lo_a, lo_b, sw_path = sw_align(smx, open_, ext)
        lg.log("SW score = %.3g Path = %s\n" % (sw_score, sw_path))
        log_aln(a, b, lo_a, lo_b, open_, ext, sw_path)
        if len(sw_path) < 8:
            return
        mid_a, mid_b = lo_a, lo_b
        for c in sw_path[: len(sw_path) // 2]:
            if c in "MD":
                mid_a += 1
            if c in "MI":
                mid_b += 1
        lg.log("Mid %u, %u\n" % (mid_a, mid_b))

        lg.log("______________________________Fwd"
               "________________________\n")
        fwd_score, fwd_path = xdrop_fwd(scorer, x, open_, ext,
                                        mid_a + 1, la, mid_b + 1, lb)
        lg.log("FwdScore = %.3g Path = (%u,%u) %s\n"
               % (fwd_score, mid_a + 1, mid_b + 1, fwd_path))
        log_aln(a, b, mid_a, mid_b, open_, ext, fwd_path)  # ref quirk

        lg.log("______________________________Bwd"
               "________________________\n")
        bwd_score, bwd_path = xdrop_bwd(scorer, x, open_, ext,
                                        mid_a, la, mid_b, lb)
        lg.log("BwdScore = %.3g (%u,%u) Path = %s\n"
               % (bwd_score, mid_a, mid_b, bwd_path))
        lolo_a = mid_a + 1 - sum(c in "MD" for c in bwd_path)
        lolo_b = mid_b + 1 - sum(c in "MI" for c in bwd_path)
        log_aln(a, b, lolo_a, lolo_b, open_, ext, bwd_path)
        comb = np.float32(fwd_score) + np.float32(bwd_score) \
            - np.float32(b62[ord(a[mid_a]), ord(b[mid_b])])
        lg.log("FB score %.3g  %s\n" % (comb, bwd_path + fwd_path[1:]))
        lg.log("SW score %.3g  %s\n" % (sw_score, sw_path))

        lg.log("______________________________Merged"
               "________________________\n")
        # MergeFwdBwd (src/mergefwdback.cpp:6-50)
        merged = bwd_path + fwd_path
        hi_a = mid_a + sum(c in "MD" for c in fwd_path) \
            if fwd_path else mid_a
        hi_b = mid_b + sum(c in "MI" for c in fwd_path) \
            if fwd_path else mid_b
        m_lo_a = lolo_a if bwd_path else mid_a + 1
        m_lo_b = lolo_b if bwd_path else mid_b + 1
        lg.log("Merged A %u-%u, B %u-%u, Path %s\n"
               % (m_lo_a, m_lo_b, hi_a, hi_b, merged))
        log_aln(a, b, m_lo_a, m_lo_b, open_, ext, merged)
        lg.log("===================================================="
               "================\n")

    test("DVLGYLRFLTKGERQANLNF", "WVLGLRFLTKGERQANLNF")
    test("DVLGYLRFLTERQANLNF", "WVLGLRFLTKGERQANLNF")
    test("DVLGYLRFLTKGERQANLNF", "WVLGLINSRFLTKGERQANLNF")
    return 0


def cmd_mukmerfilter(args) -> int:
    """-mukmerfilter: obsolete in the reference too
    (src/mukmerfilter2.cpp:29-31 is `Die("Obsolete")`); kept for surface
    parity.  The live MKF machinery is align/mkf.py + the search
    drivers."""
    raise SystemExit("Obsolete")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="reseek-tpu",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("convert", help="convert structures between formats")
    p.add_argument("input")
    p.add_argument("--bca")
    p.add_argument("--cal")
    p.add_argument("--fasta")
    p.add_argument("--feature-fasta", dest="feature_fasta")
    p.add_argument("--alpha", default="Mu")
    p.add_argument("--pdb", help="multi-PDB output (MODEL per chain)")
    p.add_argument("--minchainlength", type=int, default=0)
    p.add_argument("--labels", help="keep only labels listed in this file")
    p.add_argument("--subsample", type=int, default=0,
                   help="keep every Nth input chain")
    p.add_argument("--reverse", action="store_true",
                   help="reverse residue order")
    p.add_argument("--flip", action="store_true",
                   help="negate coordinates (mirror image)")
    p.add_argument("--index", help="write a pre-encoded .rsdx artifact "
                                   "(search loads it with zero DSS work)")
    p.add_argument("--index-modes", default="fast,sensitive",
                   help="modes whose self-rev scores to precompute")
    p.set_defaults(func=cmd_convert)

    p = sub.add_parser("search", help="structure search")
    p.add_argument("input")
    p.add_argument("--db")
    p.add_argument("--dbmu", help="Mu-letter FASTA of the DB: the -fast "
                                  "prefilter skips DB encoding "
                                  "(reference -dbmu, search.cpp:96-99)")
    _add_mode_args(p)
    p.add_argument("--output", "-o")
    p.add_argument("--columns", default="std")
    p.add_argument("--evalue", type=float)
    p.add_argument("--omega", type=float)
    p.add_argument("--minfwdscore", type=float)
    p.add_argument("--gapopen", type=float,
                   help="gap-open penalty (>= 0 convention)")
    p.add_argument("--gapext", type=float,
                   help="gap-extend penalty (>= 0 convention)")
    p.add_argument("--dbsize", type=int,
                   help="accepted for reference compatibility (E-values "
                        "use the fitted SCOP40c constant, like reseek)")
    p.add_argument("--noself", action="store_true")
    p.add_argument("--global", dest="global_aln", action="store_true",
                   help="global (NW) alignment instead of local SW")
    p.add_argument("--scores-are-not-evalues", dest="scores_are_not_evalues",
                   action="store_true",
                   help="disable the E-value output gate")
    p.add_argument("--threads", type=int, default=0,
                   help="host worker threads (0 = all cores)")
    p.add_argument("--log", help="write a log file (reference -log)")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "device", "host"],
                   help="force the batched device engine or the host "
                        "per-pair path (default: device on the GPU, host "
                        "on the CPU)")
    p.add_argument("--idxq", action="store_true",
                   help="force query-neighborhood prefilter indexing "
                        "(reference -idxq, src/muprefilter.cpp:70-80)")
    p.add_argument("--idxt", action="store_true",
                   help="force target-neighborhood prefilter mode "
                        "(reference -idxt)")
    p.add_argument("--params", help="name<TAB>value parameter file "
                                    "(reference -params / FromTsv)")
    p.add_argument("--paramstr", help="AA:0.4_Conf:0.2_... parameter "
                                      "string (FromParamStr)")
    p.add_argument("--aln", help="write pretty alignment blocks "
                                 "(reference -aln)")
    p.add_argument("--label1", help="with --label2: log a full pipeline "
                                    "trace for this chain pair")
    p.add_argument("--label2")
    p.add_argument("--nprocs", type=int, default=1,
                   help="multi-host run: total process count (every host "
                        "runs the same command; requires --fast --db)")
    p.add_argument("--procid", type=int, default=None,
                   help="multi-host run: this process's rank "
                        "(default: $JAX_PROCESS_ID)")
    p.add_argument("--coord", default=None,
                   help="multi-host run: coordinator host:port "
                        "(default: $JAX_COORDINATOR_ADDRESS)")
    p.add_argument("--local-device-ids", dest="local_device_ids",
                   default=None,
                   help="multi-host run: comma list of the local devices "
                        "this process drives (e.g. one card per process "
                        "on a 4-card host; default: all)")
    p.add_argument("--scratch", default=None,
                   help="multi-host run: shared scratch dir for per-host "
                        "row files (default: alongside --output)")
    p.add_argument("--resume", action="store_true",
                   help="multi-host run: skip shards whose row files "
                        "already completed (restart checkpoint)")
    p.set_defaults(func=cmd_search)

    p = sub.add_parser("alignpair", help="align best chain pair of two files")
    p.add_argument("input")
    p.add_argument("--input2", required=True)
    p.add_argument("--aln")
    p.add_argument("--output")
    p.add_argument("--global", dest="global_aln", action="store_true",
                   help="global (NW) alignment with free terminal gaps")
    p.set_defaults(func=cmd_alignpair)

    p = sub.add_parser("align-bag",
                       help="MKF bag alignment of one chain pair "
                            "(reference -align_bag)")
    p.add_argument("input")
    p.add_argument("--input2", required=True)
    p.add_argument("--output")
    p.set_defaults(func=cmd_align_bag)

    p = sub.add_parser("daliscore-tsv",
                       help="recompute DALI Z per row of a DALI TSV "
                            "(reference -daliscore_tsv)")
    p.add_argument("tsv")
    p.add_argument("--input", required=True, help="structures")
    p.add_argument("--output")
    p.set_defaults(func=cmd_daliscore_tsv)

    p = sub.add_parser("scop40bit", help="hits TSV -> binary .bit dump "
                                         "(reference -scop40bit)")
    p.add_argument("hits")
    p.add_argument("--lookup", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(func=cmd_scop40bit)

    p = sub.add_parser("scop40bit2tsv",
                       help=".bit dump -> hits TSV (reference "
                            "-scop40bit2tsv)")
    p.add_argument("bit")
    p.add_argument("--lookup", required=True)
    p.add_argument("--output", required=True)
    p.set_defaults(func=cmd_scop40bit2tsv)

    p = sub.add_parser("scop40bit-roc",
                       help="SEPQ/ROC report from a .bit dump "
                            "(reference -scop40bit_roc)")
    p.add_argument("bit")
    p.add_argument("--lookup", required=True)
    p.add_argument("--scores-are-not-evalues", action="store_true")
    p.set_defaults(func=cmd_scop40bit_roc)

    p = sub.add_parser("scop40bench-tsv",
                       help="SEPQ/ROC report from a hits TSV "
                            "(reference -scop40bench_tsv)")
    p.add_argument("hits")
    p.add_argument("--lookup", required=True)
    p.add_argument("--scores-are-not-evalues", action="store_true")
    p.set_defaults(func=cmd_scop40bench_tsv)

    p = sub.add_parser("postmufilter",
                       help="stage 2 of the fast pipeline from a "
                            "prefilter TSV (reference -postmufilter)")
    p.add_argument("input", help="query structures")
    p.add_argument("--db", required=True, help=".bca database")
    p.add_argument("--filin", required=True,
                   help="prefilter TSV (prefilter-mu output)")
    p.add_argument("--output")
    p.add_argument("--columns", default="std")
    p.add_argument("--evalue", type=float)
    p.set_defaults(func=cmd_postmufilter)

    p = sub.add_parser("gunzip-lines",
                       help="gunzip to text lines (reference "
                            "-gunzip_lines)")
    p.add_argument("input")
    p.add_argument("--output")
    p.set_defaults(func=cmd_gunzip_lines)

    p = sub.add_parser("musubstmx",
                       help="derive + print the Mu substitution matrix "
                            "C tables (reference -musubstmx)")
    p.add_argument("--output")
    p.set_defaults(func=cmd_musubstmx)

    p = sub.add_parser("alignselfrev",
                       help="align each chain against its reversal "
                            "(reference -alignselfrev)")
    p.add_argument("input")
    p.add_argument("--output")
    p.set_defaults(func=cmd_alignselfrev)

    p = sub.add_parser("mu-mapping",
                       help="Mu letter -> sub-feature letters table "
                            "(reference -mu_mapping)")
    p.add_argument("--output")
    p.set_defaults(func=cmd_mu_mapping)

    p = sub.add_parser("lddt-msa-foldmason",
                       help="whole-MSA foldmason LDDT (reference "
                            "-lddt_msa_foldmason)")
    p.add_argument("msa")
    p.add_argument("--input", required=True)
    p.add_argument("--core", action="store_true")
    p.add_argument("--output")
    p.set_defaults(func=cmd_lddt_msa_foldmason)

    p = sub.add_parser("lddt-msas",
                       help="batch MSA LDDT_mu (reference -lddt_msas)")
    p.add_argument("accs")
    p.add_argument("--input", required=True)
    p.add_argument("--testdir", required=True)
    p.add_argument("--core", action="store_true")
    p.add_argument("--output")
    p.set_defaults(func=cmd_lddt_msas)

    p = sub.add_parser("daliscore-msas",
                       help="batch MSA DALI Z (reference -daliscore_msas)")
    p.add_argument("accs")
    p.add_argument("--input", required=True)
    p.add_argument("--testdir", required=True)
    p.add_argument("--core", action="store_true")
    p.add_argument("--output")
    p.set_defaults(func=cmd_daliscore_msas)

    p = sub.add_parser("mmseqs-index-dump",
                       help="dump an MMseqs2/Foldseek hits DB as text "
                            "(reference -mmseqs_index_dump)")
    p.add_argument("prefix")
    p.add_argument("--output")
    p.set_defaults(func=cmd_mmseqs_index_dump)

    p = sub.add_parser("create-foldseekdb",
                       help="write a Foldseek-format DB from structures "
                            "+ 3Di FASTA (reference -create_foldseekdb)")
    p.add_argument("input")
    p.add_argument("--3di", dest="tdi", required=True,
                   help="3Di FASTA (labels must match the chains)")
    p.add_argument("--output", required=True, help="DB path prefix")
    p.add_argument("-n", type=int, default=1,
                   help="duplicate each entry n times (reference -n)")
    p.set_defaults(func=cmd_create_foldseekdb)

    p = sub.add_parser("convert-foldseekdb",
                       help="Foldseek DB -> aa FASTA / 3Di FASTA / .cal "
                            "(reference -convert_foldseekdb)")
    p.add_argument("prefix")
    p.add_argument("--fasta")
    p.add_argument("--3di", dest="tdi")
    p.add_argument("--cal")
    p.set_defaults(func=cmd_convert_foldseekdb)

    p = sub.add_parser("float-feature-bins",
                       help="train float-feature bin thresholds from "
                            "aligned pairs (reference -float_feature_bins)")
    p.add_argument("pairs", help="FASTA of gapped row pairs")
    p.add_argument("--train-cal", required=True,
                   help="structure file with the training chains")
    p.add_argument("--feature", required=True)
    p.add_argument("--alpha-size", type=int)
    p.add_argument("--output")
    p.set_defaults(func=cmd_float_feature_bins)

    p = sub.add_parser("sscluster",
                       help="k-means conformation-letter training "
                            "(reference -sscluster)")
    p.add_argument("input")
    p.add_argument("-k", type=int, required=True)
    p.add_argument("-n", type=int, default=100000)
    p.add_argument("--myss3", action="store_true")
    p.add_argument("--randseed", type=int, default=1)
    p.add_argument("--output")
    p.set_defaults(func=cmd_sscluster)

    p = sub.add_parser("msta-score",
                       help="MSA structure scores: LDDT_mu / DALI Z / "
                            "Z15 per pair + foldmason LDDT (reference "
                            "-msta_score)")
    p.add_argument("msa")
    p.add_argument("--input", required=True,
                   help="structure file with the MSA's chains")
    p.add_argument("--core", action="store_true")
    p.add_argument("--output")
    p.set_defaults(func=cmd_msta_score)

    p = sub.add_parser("msta-scores",
                       help="batch MSA scoring over an accession list "
                            "(reference -msta_scores)")
    p.add_argument("accs")
    p.add_argument("--input", required=True)
    p.add_argument("--testdir", required=True)
    p.add_argument("--core", action="store_true")
    p.add_argument("--output")
    p.set_defaults(func=cmd_msta_scores)

    p = sub.add_parser("align-bags",
                       help="MKF-vs-full-SW self-check (reference "
                            "-align_bags); prints PROBLEM rows")
    p.add_argument("input")
    p.add_argument("--output")
    p.set_defaults(func=cmd_align_bags)

    p = sub.add_parser("pdb2ss", help="print secondary structure strings")
    p.add_argument("input")
    p.set_defaults(func=cmd_pdb2ss)

    p = sub.add_parser("bca-stats", help="print .bca database statistics")
    p.add_argument("input")
    p.set_defaults(func=cmd_bca_stats)

    p = sub.add_parser("pdb2mega", help="write Muscle-3D mega input")
    p.add_argument("input")
    p.add_argument("--output", required=True)
    p.add_argument("--reverse", action="store_true")
    p.set_defaults(func=cmd_pdb2mega)

    p = sub.add_parser("scop40bench",
                       help="all-vs-all benchmark with SEPQ/ROC report")
    p.add_argument("input")
    _add_mode_args(p)
    p.add_argument("--lookup", required=True,
                   help="dom<TAB>scopid truth table")
    p.add_argument("--output")
    p.add_argument("--evalue", type=float)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "device", "host"])
    p.set_defaults(func=cmd_scop40bench)

    p = sub.add_parser("prefilter-mu",
                       help="Mu k-mer prefilter of query vs target "
                            "Mu FASTAs (reference -prefilter_mu)")
    p.add_argument("input", help="query Mu FASTA")
    p.add_argument("--db", required=True, help="target Mu FASTA")
    p.add_argument("--output", required=True)
    p.add_argument("--mode", default=None,
                   choices=[None, "idxq", "idxt", "exact"],
                   help="neighborhood mode (default: reference rule — "
                        "idxq for <=100 queries else idxt)")
    p.set_defaults(func=cmd_prefilter_mu)

    p = sub.add_parser("distmx", help="TS distance matrix (idx pairs)")
    p.add_argument("input")
    _add_mode_args(p)
    p.add_argument("--output", required=True)
    p.add_argument("--evalue", type=float)
    p.add_argument("--engine", default="auto",
                   choices=["auto", "device", "host"])
    p.set_defaults(func=cmd_distmx)

    p = sub.add_parser("shuffle", help="random chain order -> .bca")
    p.add_argument("input")
    p.add_argument("--bca", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.set_defaults(func=cmd_shuffle)

    p = sub.add_parser("split", help="divide a DB into N .bca splits")
    p.add_argument("input")
    p.add_argument("-n", type=int, required=True)
    p.add_argument("--prefix", default="split")
    p.add_argument("--minchainlength", type=int, default=1)
    p.set_defaults(func=cmd_split)

    p = sub.add_parser("convert2mu", help="structures -> Mu FASTA")
    p.add_argument("input")
    p.add_argument("--output", required=True)
    p.add_argument("--minchainlength", type=int, default=1)
    p.set_defaults(func=cmd_convert2mu)

    p = sub.add_parser("gunzip", help="decompress a .gz file")
    p.add_argument("input")
    p.add_argument("--output", required=True)
    p.set_defaults(func=cmd_gunzip)

    p = sub.add_parser("cif2pdb", help="mmCIF -> PDB")
    p.add_argument("input")
    p.add_argument("--output", required=True)
    p.set_defaults(func=cmd_cif2pdb)

    p = sub.add_parser("prepare-query",
                       help="select non-redundant query chains")
    p.add_argument("input")
    p.add_argument("--bca")
    p.add_argument("--output")
    p.add_argument("-n", type=int, default=4)
    p.add_argument("--minchainlength", type=int)
    p.set_defaults(func=cmd_prepare_query)

    for name, metric in (("lddt-msa", "lddt"), ("daliscore-msa", "dali")):
        p = sub.add_parser(name,
                           help=f"score an MSA's chain pairs ({metric})")
        p.add_argument("msa", help="MSA FASTA (gapped rows)")
        p.add_argument("--input", required=True,
                       help="structures for the MSA's chains")
        p.add_argument("--output")
        p.add_argument("--core", action="store_true",
                       help="score core columns only (<=10%%+1 gaps, "
                            "no lowercase)")
        p.set_defaults(func=cmd_msa_score, metric=metric)

    p = sub.add_parser("train-features",
                       help="train per-feature log-odds matrices from "
                            "trusted alignments")
    p.add_argument("input", help="structure file with the training chains")
    p.add_argument("--alns", required=True,
                   help="FASTA of gapped row pairs (2 records = 1 "
                        "trusted alignment)")
    p.add_argument("--output", required=True)
    p.add_argument("--features",
                   help="comma list (default: the search feature set)")
    p.set_defaults(func=cmd_train_features)

    p = sub.add_parser("fit-gumbel",
                       help="fit a Gumbel curve to a histogram file")
    p.add_argument("input")
    p.set_defaults(func=cmd_fit_gumbel)

    p = sub.add_parser("calibrate",
                       help="fit P-value model constants from a decoy "
                            "all-vs-all search")
    p.add_argument("input")
    _add_mode_args(p)
    p.add_argument("--output", help="write the TS histogram + fits")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "device", "host"])
    p.set_defaults(func=cmd_calibrate)

    p = sub.add_parser("chains2pdbs", help="one PDB file per chain")
    p.add_argument("input")
    p.add_argument("--outdir", required=True)
    p.set_defaults(func=cmd_chains2pdbs)

    p = sub.add_parser("getchains", help="list chain labels and lengths")
    p.add_argument("input")
    p.set_defaults(func=cmd_getchains)

    p = sub.add_parser("tracealn",
                       help="per-pair pipeline trace (reference -tracealn)")
    p.add_argument("input")
    p.add_argument("--db", required=True)
    p.add_argument("--log")
    p.set_defaults(func=cmd_tracealn)

    p = sub.add_parser("feature-stats",
                       help="feature registry + trained-matrix status")
    p.add_argument("input", nargs="?", help="ignored (reference arg slot)")
    p.set_defaults(func=cmd_feature_stats)

    p = sub.add_parser("test-gumbel",
                       help="self-test of the Gumbel fitter")
    p.add_argument("input", nargs="?", help="ignored (reference arg slot)")
    p.set_defaults(func=cmd_test_gumbel)

    p = sub.add_parser("scop40tsv2bit",
                       help="hits TSV + structure labels -> .bit dump")
    p.add_argument("hits")
    p.add_argument("--input", required=True,
                   help="structures with dom/scopid labels")
    p.add_argument("--output")
    p.add_argument("--scorefieldnr", type=int,
                   help="1-based score column (default 3)")
    p.set_defaults(func=cmd_scop40tsv2bit)

    p = sub.add_parser("lddt-bench",
                       help="mean fast-LDDT over all MSA pairs")
    p.add_argument("msa")
    p.add_argument("--input", required=True)
    p.add_argument("--missingtestseqok", action="store_true")
    p.set_defaults(func=cmd_lddt_bench)



    p = sub.add_parser("msta-lddtmuw",
                       help="per-column windowed LDDT (Jalview/PyMOL)")
    p.add_argument("msa")
    p.add_argument("--input", required=True)
    p.add_argument("--window", type=int, default=2)
    p.add_argument("--label")
    p.add_argument("--lddtmuw-jalview", dest="lddtmuw_jalview")
    p.add_argument("--lddtmuw-pymol", dest="lddtmuw_pymol")
    p.set_defaults(func=cmd_msta_lddtmuw)

    p = sub.add_parser("mudex", help="Mu k-mer index diagnostics")
    p.add_argument("input", help="Mu-letter FASTA")
    p.add_argument("--log")
    p.set_defaults(func=cmd_mudex)

    p = sub.add_parser("daliscore-msas2",
                       help="A/B-compare two MSA test dirs by DALI Z")
    p.add_argument("accs")
    p.add_argument("--input", required=True)
    p.add_argument("--testdir", required=True)
    p.add_argument("--testdir2", required=True)
    p.add_argument("--core", action="store_true")
    p.add_argument("--missingtestseqok", action="store_true")
    p.add_argument("--output")
    p.set_defaults(func=cmd_daliscore_msas2)

    p = sub.add_parser("calibrate2",
                       help="fit the P-value model from a labeled "
                            "all-vs-all benchmark")
    p.add_argument("input", help="structures with dom/scopid labels")
    p.add_argument("--benchlevel", required=True,
                   choices=["sf", "fold"])
    p.add_argument("--maxfpr", type=float)
    p.add_argument("--output")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "device", "host"])
    p.set_defaults(func=cmd_calibrate2)

    p = sub.add_parser("binner", help="histogram a TSV column")
    p.add_argument("input")
    p.add_argument("--fieldnr", type=int)
    p.add_argument("--bins", type=int, default=32)
    p.add_argument("--minval", type=float)
    p.add_argument("--maxval", type=float)
    p.add_argument("--log10", action="store_true")
    p.add_argument("--output")
    p.add_argument("--accum")
    p.add_argument("--accumrev")
    p.set_defaults(func=cmd_binner)

    p = sub.add_parser("msa2cmp",
                       help="contact-map profile from MSA + structures")
    p.add_argument("msa")
    p.add_argument("--input", required=True)
    p.add_argument("--output")
    p.add_argument("--maxgappct", type=float)
    p.set_defaults(func=cmd_msa2cmp)

    p = sub.add_parser("scan-files",
                       help="list structure files found by the scanner")
    p.add_argument("input")
    p.add_argument("--output")
    p.set_defaults(func=cmd_scan_files)

    p = sub.add_parser("test-xdrop",
                       help="x-drop kernel self-test (reference golden)")
    p.add_argument("input", nargs="?", help="ignored (reference arg slot)")
    p.add_argument("--log")
    p.set_defaults(func=cmd_test_xdrop)

    p = sub.add_parser("mukmerfilter",
                       help="obsolete (matches the reference)")
    p.add_argument("input", nargs="?")
    p.add_argument("--output")
    p.set_defaults(func=cmd_mukmerfilter)

    p = sub.add_parser("msta-lddtmuw1",
                       help="per-position windowed LDDT of one query")
    p.add_argument("msa")
    p.add_argument("--input", required=True)
    p.add_argument("--label", required=True)
    p.add_argument("--window", type=int, default=2)
    p.add_argument("--output")
    p.set_defaults(func=cmd_msta_lddtmuw1)

    return ap


def _reference_style(argv: List[str]) -> List[str]:
    """Accept the reference binary's flag spelling (src/myutils.cpp option
    parser): `reseek -search db.bca -sensitive -output hits.tsv` becomes
    `search db.bca --sensitive --output hits.tsv`.  Triggered only when
    the first argument is -<known command>; single-dash long options are
    rewritten to GNU style, underscores to dashes."""
    cmds = {"convert", "search", "alignpair", "pdb2ss", "pdb2mega",
            "scop40bench", "prefilter-mu", "distmx", "shuffle", "split",
            "convert2mu", "gunzip", "cif2pdb", "prepare-query", "lddt-msa",
            "daliscore-msa", "train-features", "fit-gumbel", "calibrate",
            "chains2pdbs", "getchains", "bca-stats", "align-bags",
            "msta-score", "msta-scores", "float-feature-bins",
            "sscluster", "mmseqs-index-dump", "create-foldseekdb",
            "convert-foldseekdb", "alignselfrev", "mu-mapping",
            "lddt-msa-foldmason", "lddt-msas", "daliscore-msas",
            "gunzip-lines", "musubstmx", "postmufilter", "scop40bit",
            "scop40bit2tsv", "scop40bit-roc", "scop40bench-tsv",
            "daliscore-tsv", "align-bag", "tracealn", "feature-stats",
            "test-gumbel", "scop40tsv2bit", "lddt-bench",
            "msta-lddtmuw", "msta-lddtmuw1", "mudex", "mukmerfilter",
            "scan-files", "test-xdrop", "msa2cmp", "binner", "calibrate2", "daliscore-msas2"}
    if not argv or not argv[0].startswith("-"):
        return argv
    head = argv[0].lstrip("-").replace("_", "-")
    if head not in cmds:
        return argv
    # only rewrite tokens naming a KNOWN option of this subcommand, so
    # option VALUES that begin with '-' (e.g. `-label -foo`, `-evalue -.5`)
    # pass through untouched
    known = _known_options(head)
    out = [head]
    for a in argv[1:]:
        name = a[1:].replace("_", "-") if a.startswith("-") else ""
        if (a.startswith("-") and not a.startswith("--") and len(a) > 2
                and name in known):
            out.append("--" + name)
        else:
            out.append(a)
    return out


import functools


@functools.lru_cache(maxsize=None)
def _known_options(head: str) -> set:
    """Long-option names (without --) of subcommand `head`.  Cached: the
    argparse tree is only built once per process even when main() is
    invoked repeatedly (e.g. from tests)."""
    ap = build_parser()
    for act in ap._subparsers._group_actions:  # type: ignore[union-attr]
        choices = getattr(act, "choices", None)
        if not choices or head not in choices:
            continue
        opts = set()
        for a in choices[head]._actions:
            for s in a.option_strings:
                if s.startswith("--"):
                    opts.add(s[2:])
        return opts
    return set()


def main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    args = build_parser().parse_args(_reference_style(list(argv)))
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
