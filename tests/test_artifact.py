"""Persistent encoded-DB artifact (.rsdx) + streaming/-dbmu fast search."""

import io
import os

import numpy as np
import pytest

from tests.conftest import TEST_DATA

Q10 = os.path.join(TEST_DATA, "q10.bca")
Q100 = os.path.join(TEST_DATA, "q100.bca")


def _search_rows(chains, mode="sensitive", engine="host"):
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.search.driver import SearchOptions, self_search
    params = DSSParams.create(mode)
    opts = SearchOptions(
        columns=parse_columns("query+target+qlo+qhi+evalue+cigar"),
        max_evalue=10.0, mode=mode)
    buf = io.StringIO()
    self_search(chains, params, opts, buf, engine=engine)
    return buf.getvalue().splitlines()


def test_artifact_roundtrip_and_search(tmp_path):
    """Searching from the artifact gives byte-identical rows to searching
    from coordinates, with zero DSS work at load."""
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.artifact import load_artifact, write_artifact
    from reseek_tpu.io.bca import read_bca

    chains = read_bca(Q10)
    art = str(tmp_path / "q10.rsdx")
    write_artifact(art, chains, modes=("sensitive",))

    params = DSSParams.create("sensitive")
    ecs = load_artifact(art, params, mode="sensitive")
    assert [ec.label for ec in ecs] == [c.label for c in chains]
    # profiles in the artifact match a fresh encode bit-for-bit
    from reseek_tpu.align.pipeline import encode_for_search
    fresh = encode_for_search(chains[3], params)
    np.testing.assert_array_equal(ecs[3].profile, fresh.profile)
    np.testing.assert_array_equal(ecs[3].mu_letters, fresh.mu_letters)
    assert ecs[3].self_rev_score == pytest.approx(fresh.self_rev_score)

    rows_coords = _search_rows(chains)
    rows_art = _search_rows(ecs)
    assert rows_art == rows_coords


def test_artifact_mode_mismatch_recomputes(tmp_path):
    from reseek_tpu.align.pipeline import FLT_MAX
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.artifact import load_artifact, write_artifact
    from reseek_tpu.io.bca import read_bca
    chains = read_bca(Q10)[:3]
    art = str(tmp_path / "t.rsdx")
    write_artifact(art, chains, modes=("fast",))
    ecs = load_artifact(art, DSSParams.create("sensitive"),
                        mode="sensitive")
    assert all(ec.self_rev_score == FLT_MAX for ec in ecs)
    # the host driver fills them in and still searches correctly
    rows = _search_rows(ecs)
    assert rows == _search_rows(chains)


def test_fast_search_streaming_bca_path(tmp_path):
    """fast_search given a .bca PATH (streamed stage 1 + random-access
    stage 2) produces the same rows as the in-memory list."""
    import io as _io
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.search.driver import SearchOptions, fast_search
    queries = read_bca(Q10)[:2]
    db_chains = read_bca(Q100)
    params = DSSParams.create("fast")
    opts = SearchOptions(
        columns=parse_columns("query+target+evalue+cigar"),
        max_evalue=10.0, mode="fast")
    b1, b2 = _io.StringIO(), _io.StringIO()
    fast_search(queries, db_chains, params, opts, b1)
    fast_search(queries, Q100, params, opts, b2)
    assert b1.getvalue() == b2.getvalue()
    assert b2.getvalue().count("\n") > 0


def test_fast_search_dbmu(tmp_path):
    """-dbmu: stage 1 runs from a Mu FASTA without touching coordinates;
    the FASTA round-trip (with the reference's K/L char quirk applied on
    BOTH sides) keeps the same survivor sets and hits."""
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.encoder.dss import encode_chain, feature_string
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.search.driver import SearchOptions, fast_search
    import io as _io

    queries = read_bca(Q10)[:2]
    db_chains = read_bca(Q100)
    mufa = tmp_path / "db.mu.fa"
    with open(mufa, "w") as f:
        for c in db_chains:
            f.write(f">{c.label}\n{feature_string(encode_chain(c), 'Mu')}\n")

    params = DSSParams.create("fast")
    opts = SearchOptions(columns=parse_columns("query+target+evalue"),
                         max_evalue=10.0, mode="fast")
    b1, b2 = _io.StringIO(), _io.StringIO()
    fast_search(queries, Q100, params, opts, b1)
    fast_search(queries, Q100, params, opts, b2, dbmu=str(mufa))
    # the K/L swap applies to FASTA-loaded targets exactly like the
    # reference's ToLetters, so hits may differ only if selection does;
    # on q100 the survivor top-B is stable
    assert b2.getvalue() == b1.getvalue()


def test_mu_fasta_reader_kl_swap(tmp_path):
    from reseek_tpu.io.mufasta import iter_mu_fasta
    p = tmp_path / "x.fa"
    p.write_text(">a\nABKLjz\n".replace("z", "j"))
    (label, letters), = iter_mu_fasta(str(p))
    assert label == "a"
    # 'K' -> 11, 'L' -> 10 (reference g_CharToLetterMu quirk)
    assert letters.tolist() == [0, 1, 11, 10, 35, 35]


def test_query_search_device_matches_host():
    """Query-vs-DB through the batched device engine produces the same
    rows as the host per-pair path (src/runquery.cpp semantics)."""
    import io as _io
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.search.driver import SearchOptions, query_search
    queries = read_bca(Q10)[:3]
    db = read_bca(Q100)[:40]
    params = DSSParams.create("sensitive")
    opts = SearchOptions(
        columns=parse_columns("query+target+qlo+qhi+evalue+cigar"),
        max_evalue=10.0, mode="sensitive")
    b1, b2 = io.StringIO(), io.StringIO()
    query_search(queries, db, params, opts, b1, engine="host")
    query_search(queries, db, params, opts, b2, engine="device")
    assert b1.getvalue() == b2.getvalue()
    assert b1.getvalue().count("\n") > 0


def test_query_search_chunked_stream(tmp_path):
    """Streaming query-vs-DB: a path-streamed DB processed in small
    chunks (forcing several chunk pipelines) emits the same rows as the
    one-shot in-memory run; memory stays O(queries + chunk)."""
    import io as _io
    from reseek_tpu.align.output import parse_columns
    from reseek_tpu.constants import DSSParams
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.search.driver import SearchOptions, query_search
    queries = read_bca(Q10)[:3]
    db = read_bca(Q100)[:40]
    params = DSSParams.create("sensitive")
    opts = SearchOptions(
        columns=parse_columns("query+target+qlo+qhi+evalue+cigar"),
        max_evalue=10.0, mode="sensitive")
    b1, b2, b3 = _io.StringIO(), _io.StringIO(), _io.StringIO()
    query_search(queries, db, params, opts, b1, engine="device")
    query_search(queries, db, params, opts, b2, engine="device",
                 chunk_size=16)
    query_search(queries, Q100, params, opts, b3, engine="device",
                 chunk_size=16)
    assert b1.getvalue() == b2.getvalue()
    # path-streamed DB covers all 100 chains; the 40-chain rows are a
    # strict prefix-by-target subset check via row containment
    assert set(b2.getvalue().splitlines()) <= set(b3.getvalue().splitlines())
    assert b3.getvalue().count("\n") >= b2.getvalue().count("\n")
