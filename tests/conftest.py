"""Test configuration: JAX on the CPU with an 8-device virtual mesh, so the
sharding tests run without accelerators, and the structure inputs the
tests share, made from the chains committed under tests/golden/.

The tests marked `gpu` need the card and skip on the CPU; on a GPU
machine run them with
    RESEEK_TEST_PLATFORM=cuda python -m pytest -m gpu tests/
(chip_smoke.py runs them too)."""

import os
import shutil
import tempfile

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms",
                  os.environ.get("RESEEK_TEST_PLATFORM", "cpu"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# q10.bca / q100.bca / 1hhs.bca, written from the .cal chains of
# tests/golden by the session fixture below (.cal rounds coordinates to
# 0.1 A, so goldens made from the original .bca files can differ in the
# last digits; device-vs-host comparisons on these inputs are exact).
# One directory per process: test modules import this file both as
# `conftest` and as `tests.conftest`, and both must name the same place.
TEST_DATA = os.path.join(tempfile.gettempdir(),
                         f"reseek-test-data-{os.getpid()}")


def load_fasta(path):
    d, lab = {}, None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                lab = line[1:]
                d[lab] = ""
            elif lab is not None:
                d[lab] += line
    return d


def golden_q100():
    from reseek_tpu.benchmarks.replicas import golden_chains
    return golden_chains(("q100.cal",))


def golden_q10():
    from reseek_tpu.benchmarks.replicas import golden_q10
    return golden_q10()


@pytest.fixture(scope="session", autouse=True)
def _test_data_files():
    from reseek_tpu.io.bca import write_bca
    from reseek_tpu.io.cal import read_cal
    os.makedirs(TEST_DATA, exist_ok=True)
    write_bca(golden_q100(), os.path.join(TEST_DATA, "q100.bca"))
    write_bca(golden_q10(), os.path.join(TEST_DATA, "q10.bca"))
    sepq = read_cal(os.path.join(GOLDEN, "sepq_set.cal"))
    write_bca([c for c in sepq if c.label == "1hhs_A"],
              os.path.join(TEST_DATA, "1hhs.bca"))
    yield
    shutil.rmtree(TEST_DATA, ignore_errors=True)


@pytest.fixture(scope="session")
def q100_chains():
    return golden_q100()


@pytest.fixture(scope="session")
def q10_chains():
    return golden_q10()


@pytest.fixture(scope="session")
def q100_encodings(q100_chains):
    from reseek_tpu.encoder.dss import encode_chain
    return {c.label: encode_chain(c) for c in q100_chains}


@pytest.fixture
def gpu():
    """The test needs the card: skips where JAX runs on the CPU."""
    from reseek_tpu.device import platform
    if platform() != "gpu":
        pytest.skip("needs a CUDA GPU (run: python chip_smoke.py)")
