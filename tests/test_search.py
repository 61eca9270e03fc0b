"""End-to-end search parity: our self-search output must be byte-identical
to the reference binary's on q10.bca (goldens committed from
reseek -search q10.bca -verysensitive/-sensitive, 1 thread).  The q10
chains here come from tests/golden/q100.cal, whose coordinates are rounded
to 0.1 A; -sensitive rows are unchanged by that rounding."""

import io
import os

import pytest

from tests.conftest import GOLDEN, golden_q10
from reseek_tpu.align.output import parse_columns
from reseek_tpu.constants import DSSParams
from reseek_tpu.search.driver import SearchOptions, self_search

COLUMNS = "query+target+qlo+qhi+tlo+thi+dpscore+lddt+newts+evalue+cigar"


def _run_self(mode: str) -> str:
    params = DSSParams.create(mode)
    options = SearchOptions(columns=parse_columns(COLUMNS),
                            max_evalue=float("inf") if mode == "verysensitive"
                            else 10.0,
                            mode=mode)
    buf = io.StringIO()
    self_search(golden_q10(), params, options, buf)
    return buf.getvalue()


@pytest.mark.slow
def test_q10_verysensitive_byte_identical():
    golden = open(os.path.join(GOLDEN, "q10_vs.tsv")).read()
    assert _run_self("verysensitive") == golden


@pytest.mark.slow
def test_q10_sensitive_byte_identical():
    golden = open(os.path.join(GOLDEN, "q10_sens.tsv")).read()
    assert _run_self("sensitive") == golden


def test_statsig_values():
    from reseek_tpu.constants import StatSig
    # elbow model (src/statsig.cpp:27-44)
    assert StatSig.pvalue(0.0) == pytest.approx(10 ** -0.58)
    assert StatSig.pvalue(1.0) == pytest.approx(10 ** (-52 - 3.7))
    assert StatSig.pvalue(-1.0) == 1.0
    assert StatSig.evalue(0.2) == pytest.approx(
        8340 * 10 ** (-52 * 0.2 - 3.7))


def test_kabsch_recovers_rotation():
    import numpy as np
    from reseek_tpu.ops.kabsch import kabsch
    rng = np.random.default_rng(0)
    x = rng.normal(size=(30, 3))
    theta = 0.7
    R = np.array([[np.cos(theta), -np.sin(theta), 0],
                  [np.sin(theta), np.cos(theta), 0],
                  [0, 0, 1.0]])
    y = x @ R.T + np.array([1.0, -2.0, 3.0])
    t, u, msd = kabsch(x, y)
    assert msd < 1e-18
    assert np.allclose(u, R)
    assert np.allclose(t, [1.0, -2.0, 3.0])


@pytest.mark.slow
def test_q10_device_pipeline_byte_identical(q10_chains):
    """The sorted-DB rectangular device pipeline (engine='device', here on
    CPU) must produce the same bytes as the host path / reference."""
    params = DSSParams.create("sensitive")
    options = SearchOptions(columns=parse_columns(COLUMNS),
                            max_evalue=10.0, mode="sensitive")
    chains = q10_chains
    buf = io.StringIO()
    self_search(chains, params, options, buf, engine="device")
    golden = open(os.path.join(GOLDEN, "q10_sens.tsv")).read()
    assert buf.getvalue() == golden


@pytest.mark.slow
def test_q10_sharded_mesh_byte_identical(q10_chains):
    """Multi-chip search (SURVEY §2.8): the engine sharded over an
    8-virtual-device mesh must produce hit-for-hit (byte-identical)
    output vs the single-device engine / reference golden."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    params = DSSParams.create("sensitive")
    options = SearchOptions(columns=parse_columns(COLUMNS),
                            max_evalue=10.0, mode="sensitive")
    chains = q10_chains
    # 6 shortest chains: exercises the mesh path with few bucket shapes
    # (the full-set single-device parity is covered by the test above)
    chains = sorted(chains, key=lambda c: len(c.seq))[:6]
    devs = jax.devices()
    assert len(devs) >= 8, "conftest should force 8 virtual CPU devices"
    mesh = Mesh(np.array(devs[:8]), ("db",))
    buf_mesh, buf_one = io.StringIO(), io.StringIO()
    self_search(chains, params, options, buf_mesh, engine="device",
                mesh=mesh)
    self_search(chains, params, options, buf_one, engine="device")
    assert buf_mesh.getvalue() == buf_one.getvalue()
    assert buf_mesh.getvalue().count("\n") > 5


def test_q10_device_with_e_prepass_byte_identical(monkeypatch, q10_chains):
    """The E-bound score-only prepass (skips the traceback kernel for
    pairs whose best-possible E exceeds the gate) must not change a
    single output byte — forced on with RESEEK_E_PREPASS_MIN=1."""
    monkeypatch.setenv("RESEEK_E_PREPASS_MIN", "1")
    params = DSSParams.create("sensitive")
    options = SearchOptions(columns=parse_columns(COLUMNS),
                            max_evalue=10.0, mode="sensitive")
    chains = q10_chains
    buf = io.StringIO()
    self_search(chains, params, options, buf, engine="device")
    golden = open(os.path.join(GOLDEN, "q10_sens.tsv")).read()
    assert buf.getvalue() == golden
