"""Foldseek DB interop (io/foldseek.py): create-foldseekdb output was
verified byte-identical to the reference binary's -create_foldseekdb on
q10 (all 14 files), and convert-foldseekdb round-trips byte-identically
(aa FASTA / 3Di FASTA / .cal).  This test locks the round trip and the
coordinate codec without needing the binary."""

import io
import os
from contextlib import redirect_stderr

import numpy as np

from conftest import TEST_DATA


def test_foldseek_roundtrip(tmp_path):
    from reseek_tpu.cli import main
    from reseek_tpu.encoder.dss import encode_chain, feature_string
    from reseek_tpu.io.bca import read_bca
    from reseek_tpu.io.foldseek import (coords_from_mem, coords_to_mem,
                                        read_foldseek_db,
                                        write_foldseek_db)

    chains = read_bca(os.path.join(TEST_DATA, "q10.bca"))
    s3di = {c.label: feature_string(encode_chain(c), "Mu")
            for c in chains}
    prefix = str(tmp_path / "db")
    n = write_foldseek_db(chains, s3di, prefix)
    assert n == len(chains)

    entries = read_foldseek_db(prefix)
    assert len(entries) == len(chains)
    for c, (label, seq, s3, coords) in zip(chains, entries):
        assert label == c.label
        assert seq == c.seq
        assert s3 == s3di[c.label]
        # int16-delta codec: millitruncated coordinates round-trip
        assert np.abs(coords - c.coords).max() < 2e-3

    # codec unit check incl. the raw-float overflow fallback
    rng = np.random.default_rng(0)
    small = np.cumsum(rng.normal(0, 2.2, (50, 3)),
                      axis=0).astype(np.float32)
    mem = coords_to_mem(small)
    assert mem is not None
    back = coords_from_mem(mem, 50)
    assert np.abs(back - small).max() < 2e-3
    big = small.copy()
    big[10] += 100.0  # 100 A jump -> int16 delta overflow
    assert coords_to_mem(big) is None

    # dupes (reference -n): entry count and DUPE labels
    with redirect_stderr(io.StringIO()):
        prefix2 = str(tmp_path / "db2")
        write_foldseek_db(chains[:2], s3di, prefix2, dupes=2)
    e2 = read_foldseek_db(prefix2)
    assert len(e2) == 4
    assert e2[1][0] == "DUPE1_" + chains[0].label
