"""The accelerator decision (reseek_tpu/device.py), the engine rules built
on it, and the native library builds (reseek_tpu/native_build.py)."""

import os

import pytest

from reseek_tpu import device, native_build
from reseek_tpu.search import driver


def test_platform_is_cpu_in_tests():
    assert device.platform() == "cpu"
    assert device.default_engine() == "host"
    assert not any(device.kernels(k) for k in device.KERNELS)


def test_gpu_platform_picks_device_engine_and_kernels(monkeypatch):
    monkeypatch.setattr(device, "platform", lambda: "gpu")
    assert device.default_engine() == "device"
    assert device.kernels("mu") and device.kernels("align")
    with device.plain_kernels():
        assert not device.kernels("mu") and not device.kernels("align")
    with device.plain_kernels("align"):
        assert device.kernels("mu") and not device.kernels("align")
    assert device.kernels("mu") and device.kernels("align")


def test_unknown_platform_raises(monkeypatch):
    monkeypatch.setattr(device, "platform", lambda: "rocm")
    with pytest.raises(RuntimeError):
        device.default_engine()


@pytest.mark.parametrize("platform,mesh,want", [
    ("cpu", None, "host"), ("gpu", None, "device"), ("cpu", "m", "device")])
def test_resolve_engine(monkeypatch, platform, mesh, want):
    monkeypatch.setattr(device, "platform", lambda: platform)
    assert driver.resolve_engine("auto", mesh) == want
    assert driver.resolve_engine("host", mesh) == "host"


@pytest.mark.parametrize("platform,n_cand,want", [
    ("gpu", 20000, "device"), ("gpu", 19999, "host"), ("cpu", 10**6, "host")])
def test_fast_engine_threshold(monkeypatch, platform, n_cand, want):
    monkeypatch.setattr(device, "platform", lambda: platform)
    monkeypatch.delenv("RESEEK_FAST_DEVICE_MIN", raising=False)
    assert driver.fast_engine("auto", n_cand) == want
    assert driver.fast_engine("device", 0) == "device"


def test_host_library_keyed_on_source_flags_and_target():
    path = native_build.host_library_path("lddt")
    name = os.path.basename(path)
    assert name.startswith("liblddt-") and name.endswith(".so")
    key = name[len("liblddt-"):-3]
    src = os.path.join(native_build.NATIVE, "lddt.cpp")
    flags = ["-O2", "-march=native", "-shared", "-fPIC", "-ffp-contract=off"]
    target = native_build._host_target()
    assert key == native_build._key([src], flags, target)
    assert key != native_build._key([src], flags, target + "other cpu")
    assert key != native_build._key([src], flags[:-1], target)
    assert native_build.LOADED["lddt"]["path"] == path


def test_native_disabled_returns_none(monkeypatch):
    monkeypatch.setenv("RESEEK_NATIVE", "0")
    assert native_build.load_host("sw") is None


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native_build, "BUILD", str(tmp_path))
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++")
    monkeypatch.setattr(native_build, "NATIVE", str(tmp_path))
    with pytest.raises(RuntimeError, match="building bad failed"):
        native_build.load_source("bad", ["bad.cpp"])
