"""Build the CUDA sources in ``repro_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the repo
root (a directory git ignores), then loaded with ``ctypes``.  No PyTorch
header is included, so a build takes seconds rather than the minutes
``torch.utils.cpp_extension`` needs.  The library's file name carries a
hash of its source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them.

Nothing here runs at import: the first call of a kernel builds it, and a
failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
#: argtypes of each exported launch function, by source name
SIGNATURES: Dict[str, Dict[str, list]] = {
    # q, k, v, q_pos, kv_pos, out, part, S, C, KV, rep, dh, window, chunk,
    # scale, is_bf16, n_split, split_len, stream
    "decode_attention": {"decode_attention_launch":
                         [_P] * 7 + [_I] * 7 + [_F] + [_I] * 3 + [_P]},
    # q, k, v, out, B, T, S, H, KV, dh, dv, window, chunk, scale, is_bf16,
    # stream
    "flash_attention": {"flash_attention_launch":
                        [_P] * 4 + [_I] * 9 + [_F, _I, _P]},
    # q_c, q_rope, c_kv, k_rope, lens, out, part, S, C, H, kvr, rd, scale,
    # design, n_split, split_len, stream
    # ...; dynamic shared memory a block of a design takes
    "mla_decode": {"mla_decode_launch":
                   [_P] * 7 + [_I] * 5 + [_F] + [_I] * 3 + [_P],
                   "mla_decode_smem": [_I]},
    # x, out, K, B, D, eps, is_bf16, n_split, d_split, stream
    "gram": {"gram_launch": [_P, _P, _I, _I, _I, _F] + [_I] * 3 + [_P]},
    # x, w, a, b, y, xa, M, K, N, r, 6 element strides, flags, bn,
    # k_split, is_bf16, nodes, A's and B's node strides, stream
    "lora_matmul": {"lora_matmul_launch":
                    [_P] * 6 + [_I] * 4 + [_L] * 6 + [_I] * 5 + [_L] * 2
                    + [_P]},
    # da, dbx, h0, h_all, h_last, links, n_links, B, S, C, tile, chunk,
    # sub, is_bf16, stream; resident blocks a SM of a design: chained,
    # is_bf16
    "selective_scan": {"selective_scan_launch":
                       [_P] * 6 + [_L] + [_I] * 7 + [_P],
                       "selective_scan_resident": [_I, _I]},
}

_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas resource report (registers, shared memory, spills) per source
ptxas_report: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "port's CUDA kernels are built on the GPU machine")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _load(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def build_all(names: Optional[List[str]] = None) -> Dict[str, ctypes.CDLL]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has
    no up-to-date library yet, one ``nvcc`` each, all at once; load them.
    Raises with the compiler output if any build fails."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if name in _libs:
            continue
        out = _target(name)
        if out.exists():
            _load(name, out)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        ptxas_report[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        _load(name, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all([name])[name]


def check_launch(name: str, err: int) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``."""
    if err:
        msg = _libs[name].kernel_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} "
                           f"({msg})")


__all__ = ["build_all", "load", "check_launch", "BUILD_DIR", "CSRC",
           "ptxas_report"]
