"""Build the CUDA sources under ``kernels/csrc`` and bind them with ctypes.

Each source is compiled on first use by ``nvcc`` into a shared library with
a plain C interface, under ``build/`` at the repository root, named by a
hash of the source and the flags — an edited source builds anew, an
unchanged one loads the library already built. Nothing here catches a
build failure: it raises with the compiler's output.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so nvcc never
contracts a multiply and an add on its own; the kernels ask for every fused
multiply-add they want explicitly (``__fmaf_rn``), which is what keeps them
bitwise equal to their plain versions. Never ``--use_fast_math``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parents[3] / "build"

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

#: ctypes signatures per library: function -> (restype, argtypes)
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_BLOCK_CODEC = {
    "encode": (_INT, [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P]),
    "decode_reduce": (_INT, [_P, _P, _P, _I64, _I64, _I64, _I64, _P]),
    "error_string": (ctypes.c_char_p, [_INT]),
}
SIGNATURES = {
    "codec_int8": {f"codec_int8_{k}": v for k, v in _BLOCK_CODEC.items()},
    "codec_int4": {f"codec_int4_{k}": v for k, v in _BLOCK_CODEC.items()},
    "codec_fp8": {
        "codec_fp8_encode": (_INT, [_P, _P, _P, _P, _P, _P, _I64, _I64,
                                    _P]),
        "codec_fp8_decode_reduce": (_INT, [_P, _P, _P, _I64, _I64, _I64,
                                           _I64, _P]),
        "codec_fp8_error_string": (ctypes.c_char_p, [_INT]),
    },
    "flash_decode": {
        "flash_decode": (_INT, [_P, _P, _P, _P, _P, _P, _P, _INT, _INT,
                                _INT, _INT, _INT, _INT, _INT,
                                ctypes.c_float, _P]),
        "flash_decode_error_string": (ctypes.c_char_p, [_INT]),
    },
    "rwkv6_wkv": {
        "rwkv6_wkv": (_INT, [_P, _P, _P, _P, _P, _P, _P, _P, _INT, _INT,
                             _INT, _INT, _INT, _P]),
        "rwkv6_wkv_tick": (_INT, [_P, _P, _P, _P, _P, _P, _P, _P, _INT,
                                  _INT, _INT, _INT, _INT, _P]),
        "rwkv6_wkv_chunked": (_INT, [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _INT, _INT, _INT, _INT, _INT, _P]),
        "rwkv6_wkv_error_string": (ctypes.c_char_p, [_INT]),
    },
    "mamba_scan": {
        "mamba_scan": (_INT, [_P, _P, _P, _P, _P, _P, _P, _P, _INT, _INT,
                              _INT, _INT, _INT, _P]),
        "mamba_scan_error_string": (ctypes.c_char_p, [_INT]),
    },
    "staging": {
        "staging_shift_blocks": (_INT, [_P, _P, _P, _I64, _I64, _I64, _I64,
                                        _I64, _P]),
        "staging_pack_blocks": (_INT, [_P, _P, _P, _I64, _I64, _I64, _I64,
                                       _I64, _I64, _P]),
        "staging_error_string": (ctypes.c_char_p, [_INT]),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on
    ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found: the CUDA kernels build on a "
                            "machine with the CUDA toolkit")


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{key.hexdigest()[:16]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists; the
    compiler's output (``-Xptxas=-v``: registers, spills) goes to a
    ``.log`` beside the library."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [nvcc(), *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{name}.cu:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)  # atomic: concurrent builds race safely
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> List[pathlib.Path]:
    """Build several sources at once: one nvcc process each, all started
    together; raises with the first failure's output."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib
