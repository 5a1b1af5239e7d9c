"""Build and bind the port's CUDA kernels.

``nvcc`` compiles each source under ``csrc/`` into a shared library with
a plain C interface, loaded with ``ctypes``.  The build happens at first
use, into ``build/`` beside this file (ignored by git), under a name
keyed by a hash of the source and the flags, so a changed source is
rebuilt and an unchanged one is loaded as it is.  Nothing here runs at
import time: the CPU tests import every module of the port on a machine
without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["NVCC_FLAGS", "SOURCES", "build", "build_all", "flash_decode_lib",
           "doc_attention_lib", "forbid_kernels"]

HERE = Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_DIR = HERE / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: every CUDA source of the port, one library each
SOURCES = ("flash_decode.cu", "doc_attention.cu")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built at first use on a "
            "machine with the CUDA toolkit")
    return found


def build(source: str) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` if its hash-keyed library is missing.
    Returns (library path, compiler log; empty when already built)."""
    src = CSRC / source
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}_{key}.so"
    if lib.is_file():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def build_all(sources=SOURCES) -> dict[str, tuple[Path, str, float]]:
    """Build several sources at once, one ``nvcc`` process each, all
    started together.  Returns {source: (library, log, seconds)}."""
    def one(source):
        t0 = time.perf_counter()
        path, log = build(source)
        return source, (path, log, time.perf_counter() - t0)

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(pool.map(one, sources))


# set inside forbid_kernels(): a library handed out there raises
_FORBIDDEN: list[str] = []


@contextlib.contextmanager
def forbid_kernels(why: str):
    """Inside, asking for a kernel library raises (``why`` says who
    forbids it): a trace on ``meta`` tensors must never hand its fake
    pointers to a launch."""
    _FORBIDDEN.append(why)
    try:
        yield
    finally:
        _FORBIDDEN.pop()


def _allowed(name: str) -> None:
    if _FORBIDDEN:
        raise RuntimeError(f"the {name} kernels were reached inside "
                           f"forbid_kernels ({_FORBIDDEN[-1]})")


def flash_decode_lib() -> ctypes.CDLL:
    """The flash-decode library, built on first call, argtypes bound."""
    _allowed("flash_decode")
    return _flash_decode_lib()


def doc_attention_lib() -> ctypes.CDLL:
    """The doc-attention training kernels, built on first call, argtypes
    bound."""
    _allowed("doc_attention")
    return _doc_attention_lib()


@functools.lru_cache(maxsize=None)
def _flash_decode_lib() -> ctypes.CDLL:
    path, _ = build("flash_decode.cu")
    lib = ctypes.CDLL(str(path))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    lib.flash_decode_dense.argtypes = [
        vp, vp, vp, vp, vp, vp, vp,            # q k v lengths out out_m out_l
        vp, vp, vp,                            # part_o part_m part_l
        i32, i32, i32, i32, i32, i32,          # B Hkv G S D tile
        i64, i64, i64, i64,                    # k/v batch and head strides
        i32, i32,                              # pages_per_split n_split
        f32, i32, i32, vp]                     # scale dtype partial stream
    lib.flash_decode_dense.restype = i32
    lib.flash_decode_paged.argtypes = [
        vp, vp, vp, vp, vp, vp,                # q k v lengths tables out
        vp, vp, vp,                            # part_o part_m part_l
        i32, i32, i32, i64, i32, i32, i32,     # B Hkv G pool_tokens bs nk D
        i32, i32,                              # pages_per_split n_split
        f32, i32, vp]                          # scale dtype stream
    lib.flash_decode_paged.restype = i32
    lib.flash_decode_split_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.flash_decode_split_smem_bytes.restype = i64
    lib.flash_decode_error_string.argtypes = [i32]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _doc_attention_lib() -> ctypes.CDLL:
    """The three doc-attention entries share one argument list; the
    forward adds its kernel choice, dQ its sub-tile, dK/dV its split."""
    path, _ = build("doc_attention.cu")
    lib = ctypes.CDLL(str(path))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    args = [vp, vp, vp, vp,                    # q k v do
            vp, vp, vp, vp,                    # q_doc q_pos kv_doc kv_pos
            vp, vp, vp, vp,                    # t0 t1 t2 starts
            vp, vp, vp, vp,                    # lse delta out0 out1
            i32, i32, i32, i32, i32, i32,      # B Hq Hkv Tq Tk D
            i32, i32, i32, i32, i32,           # bq bk rows width flat
            f32, i32, vp]                      # scale dtype stream
    for name in ("doc_attn_fwd", "doc_attn_dq", "doc_attn_dkv"):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = i32
    # the forward also takes its kind (0, or 3 for the wgmma kernel); dQ
    # the bf16 kernel's keys per sub-tile; dK/dV its split: key parts,
    # group slices, f32 slice workspace
    lib.doc_attn_fwd.argtypes = args + [i32]
    lib.doc_attn_dq.argtypes = args + [i32]
    lib.doc_attn_dkv.argtypes = args + [i32, i32, vp]
    # kind dtype bq bk D parts key_tile
    lib.doc_attn_smem_bytes.argtypes = [i32] * 7
    lib.doc_attn_smem_bytes.restype = ctypes.c_longlong
    lib.doc_attn_error_string.argtypes = [i32]
    lib.doc_attn_error_string.restype = ctypes.c_char_p
    return lib
