"""Structure I/O tests: .bca/.cal round-trips and PDB/CIF parsing."""

import glob
import io
import os

import numpy as np

from tests.conftest import GOLDEN, TEST_DATA, load_fasta
from reseek_tpu.chain import Chain
from reseek_tpu.io.bca import BCAReader, read_bca, write_bca
from reseek_tpu.io.cal import read_cal, write_cal
from reseek_tpu.io.pdb import read_pdb
from reseek_tpu.io.cif import read_cif
from reseek_tpu.io.reader import read_chains

REF_STRUCTURES = "/root/reference/test_structures"


def test_bca_read(q100_chains):
    assert len(q100_chains) == 100
    c = q100_chains[0]
    assert c.label == "155c__A"
    assert len(c) == 134


def test_bca_roundtrip(tmp_path, q100_chains):
    out = str(tmp_path / "rt.bca")
    write_bca(q100_chains, out)
    # byte-identical to the reference-produced file
    ref_bytes = open(os.path.join(TEST_DATA, "q100.bca"), "rb").read()
    assert open(out, "rb").read() == ref_bytes


def test_cal_golden_roundtrip():
    chains = read_cal(os.path.join(GOLDEN, "q100.cal"))
    assert len(chains) == 100
    buf = io.StringIO()
    write_cal(chains, buf)
    assert buf.getvalue() == open(os.path.join(GOLDEN, "q100.cal")).read()


def test_cal_coords_quantization(q100_chains):
    cal = {c.label: c for c in read_cal(os.path.join(GOLDEN, "q100.cal"))}
    for c in q100_chains[:10]:
        assert np.abs(cal[c.label].coords - c.coords).max() < 0.051


def test_read_pdb_gz():
    for fn in sorted(glob.glob(os.path.join(REF_STRUCTURES, "*.pdb.gz"))):
        chains = read_pdb(fn)
        assert chains, fn
        for c in chains:
            assert len(c) > 0
            assert c.coords.dtype == np.float32


def test_read_structures_dir():
    chains = read_chains(REF_STRUCTURES)
    assert len(chains) >= 4
    labels = [c.label for c in chains]
    assert len(set(labels)) == len(labels)


def test_ic_roundtrip():
    coords = np.array([[1.25, -3.5, 999.9], [0.0, 0.05, -999.9]], np.float32)
    c = Chain("x", "AC", coords)
    c2 = Chain.from_ics("x", "AC", c.ics())
    assert np.abs(c2.coords - coords).max() < 0.051


def test_format_errors_counted_not_fatal(tmp_path):
    """A corrupt file in a multi-file scan is counted and skipped
    (ChainReader2::m_CRGlobalFormatErrors semantics); a corrupt single
    file still raises."""
    import shutil
    import pytest
    from reseek_tpu.io import reader
    from tests.conftest import TEST_DATA
    import os
    good = os.path.join(TEST_DATA, "q10.bca")
    shutil.copy(good, tmp_path / "good.bca")
    (tmp_path / "bad.bca").write_bytes(b"NOT A BCA FILE")
    before = reader.format_errors
    chains = reader.read_chains(str(tmp_path))
    assert len(chains) == 10
    assert reader.format_errors == before + 1
    with pytest.raises(Exception):
        reader.read_chains(str(tmp_path / "bad.bca"))
