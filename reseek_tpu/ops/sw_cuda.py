"""The Hopper Smith-Waterman kernels (native/cuda/sw_kernels.cu) as JAX
operations, and a host build of their lane code for the tests.

Two kernels, one warp per pair, the DP state in registers and the
substitution scores looked up in shared memory (no [B, LA, LB] tensor in
device memory):

- `mu_sw_scores_cuda`: best local score of the 36-letter Mu filter
  (integer table; equals ops/sw_sweep.sw_score_sweep over
  mu_smx_onehot exactly);
- `sw_align_cuda`: full-profile SW with traceback, best cell and the
  backward walk (equals ops/sw_jax.sw_traceback_batch over the
  feature-ordered smx_jax.smx_batch_gather, then
  postalign_jax.walk_traceback_batch, bit for bit).

The library is built with nvcc on first use (reseek_tpu/native_build.py).
The kernels have no interpret mode; `emulate_mu_scores` and
`emulate_align` run the same lane code on the host (native/
sw_lanes_cpu.cpp), lane by lane, so the tests check its arithmetic here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np

from reseek_tpu.constants import ALPHA_SIZES
from reseek_tpu.native_build import cuda_library_path, load_source

WARP = 32
MAX_FEATURES = 8
MU_ALPHA = 37
MU_PAD_SCORE = -(1 << 27)
# dynamic shared memory a block may take without opting in
MAX_TABLE_FLOATS = 48 * 1024 // 4

_SOURCES = ("cuda/sw_kernels.cu", "sw_lanes.h")


def lanes_k(la: int) -> int:
    """Rows per lane for an A side of `la` rows (sw_lanes.h lanes_k)."""
    return 4 if la <= 128 else (8 if la <= 256 else 16)


def tb_pair_bytes(la: int, lb: int) -> int:
    k = lanes_k(la)
    npass = -(-la // (WARP * k))
    return npass * (lb + WARP - 1) * WARP * k


def library_path() -> str:
    """Build the CUDA library (nvcc) if needed; returns its path."""
    import jax.ffi
    return cuda_library_path("swkernels", _SOURCES,
                             include_dirs=(jax.ffi.include_dir(),))


@functools.lru_cache(maxsize=1)
def register() -> str:
    """Build the CUDA library and register its FFI targets; returns the
    library path."""
    import jax
    so = library_path()
    lib = ctypes.cdll.LoadLibrary(so)
    jax.ffi.register_ffi_target("reseek_mu_sweep",
                                jax.ffi.pycapsule(lib.ReseekMuSweep),
                                platform="CUDA")
    jax.ffi.register_ffi_target("reseek_sw_align",
                                jax.ffi.pycapsule(lib.ReseekSwAlign),
                                platform="CUDA")
    return so


# ------------------------------------------------------------ Mu filter
def mu_table(mumx_padded):
    """Integer 37x37 Mu table (flat) from the padded float matrix: the
    padding letter's NEG/2 entries become MU_PAD_SCORE."""
    import jax.numpy as jnp
    m = jnp.asarray(mumx_padded)
    return jnp.where(m < -1e6, MU_PAD_SCORE,
                     m.astype(jnp.int32)).astype(jnp.int32).reshape(-1)


def mu_sw_scores_cuda(a, b, mumx_padded, open_: float, ext: float):
    """Best local Mu SW scores [B] f32 for letter arrays a [B, LA],
    b [B, LB] (letter 36 = padding).  open_/ext must be integers."""
    import jax
    import jax.numpy as jnp
    assert float(open_).is_integer() and float(ext).is_integer()
    register()
    n, lb = a.shape[0], b.shape[1]
    out, _bnd = jax.ffi.ffi_call(
        "reseek_mu_sweep",
        (jax.ShapeDtypeStruct((n,), jnp.float32),
         jax.ShapeDtypeStruct((n, 3 * lb), jnp.int32)))(
        a.astype(jnp.uint8), b.astype(jnp.uint8), mu_table(mumx_padded),
        open=np.int32(open_), ext=np.int32(ext))
    return out


# ------------------------------------------------- profile SW + traceback
def align_supported(features: Sequence[str]) -> bool:
    sizes = [ALPHA_SIZES[f] for f in features]
    return (1 <= len(sizes) <= MAX_FEATURES
            and sum((s + 1) ** 2 for s in sizes) <= MAX_TABLE_FLOATS)


def align_meta(sizes: Sequence[int]) -> np.ndarray:
    """int32 [18]: per-feature table base, row stride, then the packed
    padding codes of the two code words (sw_lanes.h)."""
    meta = np.zeros(2 * MAX_FEATURES + 2, np.int64)
    base = 0
    pad = [0] * MAX_FEATURES
    for f, sz in enumerate(sizes):
        meta[f] = base
        meta[MAX_FEATURES + f] = sz + 1
        pad[f] = sz
        base += (sz + 1) ** 2
    meta[2 * MAX_FEATURES] = sum(pad[f] << (8 * f) for f in range(4))
    meta[2 * MAX_FEATURES + 1] = sum(pad[4 + f] << (8 * f)
                                     for f in range(4))
    return meta.astype(np.uint32).view(np.int32)


def align_table(w, sizes: Sequence[int]):
    """Flat f32 table of the per-feature (sz+1)^2 blocks of the flat
    block-diagonal W (smx_jax.flat_layout), padding row/column last."""
    import jax.numpy as jnp
    d = sum(sizes)
    pad = w[d, 0]
    blocks = []
    off = 0
    for sz in sizes:
        t = jnp.full((sz + 1, sz + 1), pad, jnp.float32)
        t = t.at[:sz, :sz].set(w[off:off + sz, off:off + sz])
        blocks.append(t.reshape(-1))
        off += sz
    return jnp.concatenate(blocks)


def profile_codes(prof, sizes: Sequence[int], pad_byte: int = 255):
    """uint8 profiles [B, F, L] (pad_byte past the chain) -> kernel codes
    uint8 [B, L, 8]: per-feature letters, padding = the alphabet size."""
    import jax.numpy as jnp
    sz = jnp.asarray(np.asarray(sizes, np.uint8))[None, :, None]
    c = jnp.where(prof == pad_byte, sz, prof).astype(jnp.uint8)
    c = jnp.transpose(c, (0, 2, 1))
    return jnp.pad(c, ((0, 0), (0, 0), (0, MAX_FEATURES - len(sizes))))


def sw_align_cuda(pa, pb, tbl, meta, nf: int, open_: float, ext: float):
    """pa [B, LA, 8], pb [B, LB, 8] uint8 codes.  Returns (best, bi, bj,
    lo_a, lo_b, plen, path_rev [B, LA+LB] uint8, tb)."""
    import jax
    import jax.numpy as jnp
    register()
    n, la, lb = pa.shape[0], pa.shape[1], pb.shape[1]
    i32 = jnp.int32
    outs = (jax.ShapeDtypeStruct((n,), jnp.float32),
            *[jax.ShapeDtypeStruct((n,), i32)] * 5,
            jax.ShapeDtypeStruct((n, la + lb), jnp.uint8),
            jax.ShapeDtypeStruct((n, tb_pair_bytes(la, lb)), jnp.uint8),
            jax.ShapeDtypeStruct((n, 3 * lb), jnp.float32))
    r = jax.ffi.ffi_call("reseek_sw_align", outs)(
        pa, pb, tbl, jnp.asarray(meta), open=np.float32(open_),
        ext=np.float32(ext), nf=np.int32(nf))
    return tuple(r[:8])


def unpack_tb(tb: np.ndarray, la: int, lb: int) -> np.ndarray:
    """Kernel traceback bytes [B, tb_pair_bytes] -> [B, LA, LB] cells."""
    k = lanes_k(la)
    i = np.arange(la)[:, None]
    j = np.arange(lb)[None, :]
    rows = WARP * k
    t = (i % rows) // k
    off = (((i // rows) * (lb + WARP - 1) + j + t) * WARP + t) * k + i % k
    return np.asarray(tb)[:, off]


# ------------------------------------------------------ host lane build
@functools.lru_cache(maxsize=1)
def _host_lanes() -> ctypes.CDLL:
    lib = load_source("swlanes", ("sw_lanes_cpu.cpp", "sw_lanes.h"),
                      ("-ffp-contract=off",))
    p = ctypes.c_void_p
    i = ctypes.c_int
    f = ctypes.c_float
    lib.swl_mu_scores.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.swl_align.argtypes = [p, p, p, p, i, i, i, i, f, f,
                              p, p, p, p, p, p, p, p]
    lib.swl_lanes_k.restype = i
    lib.swl_tb_pair_bytes.restype = ctypes.c_longlong
    return lib


def _ptr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.c_void_p)


def emulate_mu_scores(a: np.ndarray, b: np.ndarray, table: np.ndarray,
                      open_: int, ext: int) -> np.ndarray:
    """mu_sw_scores_cuda's lane code on the host."""
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    t = np.ascontiguousarray(table, np.int32)
    out = np.zeros(a.shape[0], np.float32)
    _host_lanes().swl_mu_scores(_ptr(a), _ptr(b), _ptr(t), a.shape[0],
                                a.shape[1], b.shape[1], int(open_),
                                int(ext), _ptr(out))
    return out


def emulate_align(pa: np.ndarray, pb: np.ndarray, tbl: np.ndarray,
                  meta: np.ndarray, nf: int, open_: float, ext: float
                  ) -> Tuple[np.ndarray, ...]:
    """sw_align_cuda's lane code on the host; same outputs."""
    lib = _host_lanes()
    pa = np.ascontiguousarray(pa, np.uint8)
    pb = np.ascontiguousarray(pb, np.uint8)
    tbl = np.ascontiguousarray(tbl, np.float32)
    meta = np.ascontiguousarray(meta, np.int32)
    n, la, lb = pa.shape[0], pa.shape[1], pb.shape[1]
    assert lib.swl_tb_pair_bytes(la, lb) == tb_pair_bytes(la, lb)
    best = np.zeros(n, np.float32)
    ints = [np.zeros(n, np.int32) for _ in range(5)]
    path = np.zeros((n, la + lb), np.uint8)
    tb = np.zeros((n, tb_pair_bytes(la, lb)), np.uint8)
    lib.swl_align(_ptr(pa), _ptr(pb), _ptr(tbl), _ptr(meta), int(nf), n,
                  la, lb, float(open_), float(ext), _ptr(best),
                  *[_ptr(x) for x in ints], _ptr(path), _ptr(tb))
    return (best, *ints, path, tb)
