"""Build and load the native libraries compiled from `native/`.

Every shared library of the package is built here from the sources in the
repository, for the machine the program runs on: host C++ with g++
(`-march=native`) and the CUDA kernels with nvcc (`sm_90a`).  A library's
file name carries a hash of its sources, its flags, the compiler's version
and the compiler's resolved target (the `-march=native` expansion, or the
CUDA architecture), so a library built on another CPU or card is never
loaded: a copy of the tree moved to a new machine rebuilds on first use.

Libraries land in `native/build/` (git-ignored).  `RESEEK_NATIVE=0`
disables the host libraries (callers then use their numpy replicas); any
other failure to build or load raises.

    python -m reseek_tpu.native_build      # build every host library now
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "native")
BUILD = os.path.join(NATIVE, "build")

# host libraries: name -> (source, extra g++ flags)
HOST_LIBS = {
    "prefilter": ("prefilter.cpp", ("-std=c++17", "-pthread")),
    "dssenc": ("dss_encoder.cpp", ()),
    "sw": ("sw.cpp", ("-ffp-contract=off",)),
    # -ffp-contract=off: only the EXPLICIT fmaf calls fuse, matching the
    # reference's contracted d^2 and nothing else
    "lddt": ("lddt.cpp", ("-ffp-contract=off",)),
    "mkf": ("mkf.cpp", ()),
}

_lock = threading.Lock()
# name -> {"path": ..., "built": bool} for every library this process loaded
LOADED: Dict[str, dict] = {}


def native_disabled() -> bool:
    return os.environ.get("RESEEK_NATIVE", "1") == "0"


def _run(cmd: Sequence[str]) -> str:
    return subprocess.run(list(cmd), check=True, capture_output=True,
                          text=True).stdout


@functools.lru_cache(maxsize=None)
def _host_target() -> str:
    """g++'s version plus its resolved `-march=native` target flags."""
    return (_run(["g++", "--version"]).splitlines()[0] + "\n"
            + _run(["g++", "-march=native", "-Q", "--help=target"]))


@functools.lru_cache(maxsize=None)
def _cuda_target(arch: str) -> str:
    return _run([nvcc(), "--version"]) + arch


def nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def _key(sources: Sequence[str], flags: Sequence[str], target: str) -> str:
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update("\0".join(flags).encode())
    h.update(target.encode())
    return h.hexdigest()[:16]


def _build(name: str, cmd_for, sources: Sequence[str],
           flags: Sequence[str], target: str) -> str:
    """Build `name` unless a library for this exact key exists; returns
    its path.  `cmd_for(out_path)` gives the compiler command."""
    so = os.path.join(BUILD, f"lib{name}-{_key(sources, flags, target)}.so")
    built = False
    with _lock:
        if not os.path.exists(so):
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(cmd_for(tmp), capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {name} failed:\n"
                                   f"{proc.stderr[-4000:]}")
            os.replace(tmp, so)
            built = True
        LOADED.setdefault(name, {"path": so, "built": built})
    return so


def host_library_path(name: str) -> str:
    src, extra = HOST_LIBS[name]
    src = os.path.join(NATIVE, src)
    flags = ["-O2", "-march=native", "-shared", "-fPIC", *extra]
    return _build(name, lambda out: ["g++", *flags, src, "-o", out],
                  [src], flags, _host_target())


def load_host(name: str) -> Optional[ctypes.CDLL]:
    """The host library `name` (see HOST_LIBS), built if needed; None when
    RESEEK_NATIVE=0.  Raises when it cannot be built or loaded."""
    if native_disabled():
        return None
    return ctypes.CDLL(host_library_path(name))


def load_source(name: str, sources: Sequence[str],
                flags: Sequence[str] = ()) -> ctypes.CDLL:
    """A host library built from arbitrary `native/` sources (the CPU build
    of the CUDA kernels' lane code, used by the tests)."""
    srcs = [os.path.join(NATIVE, s) for s in sources]
    fl = ["-O2", "-shared", "-fPIC", "-std=c++17", *flags]
    cpp = [s for s in srcs if s.endswith(".cpp")]
    return ctypes.CDLL(_build(name, lambda out: ["g++", *fl, *cpp, "-o", out],
                              srcs, fl, _host_target()))


def cuda_library_path(name: str, sources: Sequence[str],
                      include_dirs: Sequence[str] = (),
                      arch: str = "sm_90a") -> str:
    """Build a CUDA shared library with nvcc for `arch`."""
    srcs = [os.path.join(NATIVE, s) for s in sources]
    cu = [s for s in srcs if s.endswith(".cu")]
    flags = ["-gencode", f"arch=compute_{arch[3:]},code={arch}",
             "-std=c++17", "-O3", "--fmad=false", "-shared",
             "-Xcompiler", "-fPIC", *[f"-I{d}" for d in include_dirs]]
    return _build(name, lambda out: [nvcc(), *flags, *cu, "-o", out],
                  srcs, flags, _cuda_target(arch))


def build_all_host() -> List[str]:
    return [host_library_path(n) for n in HOST_LIBS]


if __name__ == "__main__":
    for p in build_all_host():
        print(p)
