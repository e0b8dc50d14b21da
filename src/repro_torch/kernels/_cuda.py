"""Build, load and call the hand-written CUDA kernels in ``csrc/``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together, then one link) into a shared
library with a plain C interface under the package's git-ignored
``build/`` directory, and loaded with ``ctypes``.  The library's file name
carries a hash of the sources and flags, so an edited source is rebuilt
and never served stale.  Nothing here runs at import: the CPU tests import
every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build"
SOURCES = ("merge_spmm.cu", "rowsplit_spmm.cu", "sddmm.cu", "moe_gemm.cu",
           "flash_attention.cu")
HEADERS = ("spmm_common.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# Codes shared with csrc/spmm_common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {"none": 0, "relu": 1, "gelu": 2}
# The bodies of the merge, row-split and SDDMM kernels, by the code their C
# entries report (csrc/spmm_common.cuh, enum SpmmBody); ``staged`` is the
# row-split kernel's alone.
BODIES = ("scalar", "f32x4", "bf16x8", "staged")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # cols, slot_nz, vals, vals_dtype, b, b_dtype, bias, residual, act,
    # has_scale, scale, out, out_dtype, batch, m, l, nnz_pad, k, n, parts,
    # staged, device, stream, body (out)
    "repro_rowsplit_spmm": (_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _F, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                            ctypes.POINTER(_I)),
    # cols, lrow, slot_nz, tile, first, vals, vals_dtype, b, b_dtype, bias,
    # residual, act, has_scale, scale, out, out_dtype, carry, batch,
    # n_chunks, t, tm, nnz_pad, m, k, n, g, device, stream, body (out)
    "repro_merge_spmm": (_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I,
                         _F, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P, ctypes.POINTER(_I)),
    # rows, cols, valid, dc, dc_dtype, b, b_dtype, out, batch, nnz_pad, m,
    # k, n, g, device, stream, body (out)
    "repro_sddmm": (_P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                    _I, _P, ctypes.POINTER(_I)),
    # x, w, dtype, block_expert, out, tokens, d_in, d_out, n_experts, tt,
    # device, stream, body (out)
    "repro_moe_gemm": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                       ctypes.POINTER(_I)),
    # q, k, v, out, dtype, b, s, h, kv_heads, head_dim, scale, device,
    # stream, body (out)
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                              _I, _P, ctypes.POINTER(_I)),
}

_lib = None
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the kernels are built from "
            f"{CSRC} at first use and need the CUDA toolkit (set "
            "CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libreprotorch_spmm_{h.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels (if not built yet); returns the library path.

    ``verbose`` adds ``-Xptxas -v`` and prints what the compiler says
    (registers, shared memory and spills of every kernel).
    """
    so = library_path()
    if so.exists():
        return so
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    extra = ("-Xptxas", "-v") if verbose else ()
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / name), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, proc in zip(SOURCES, procs):
        out, _ = proc.communicate()
        if verbose and out:
            print(f"[nvcc {name}]\n{out}", end="")
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    tmp = so.with_suffix(f".{tag}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {so.name}:\n{link.stdout}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def body_for(dtype: torch.dtype, n: int, *, aligned: bool = True) -> str:
    """The body a merge, row-split or SDDMM launch runs for rows of
    ``dtype`` and ``n`` columns (``aligned``: every row-major operand the
    kernel reads or writes with vector accesses starts on a 16-byte
    boundary; for the SDDMM also dc's dtype is b's): ``f32x4`` for float32
    with n % 4 == 0, ``bf16x8`` for bfloat16 with n % 8 == 0, ``scalar``
    otherwise (``pick_body`` in ``csrc/spmm_common.cuh``)."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, not {dtype}")
    if aligned and dtype == torch.float32 and n % 4 == 0:
        return "f32x4"
    if aligned and dtype == torch.bfloat16 and n % 8 == 0:
        return "bf16x8"
    return "scalar"


def count_launch(by_body: dict, code: int) -> None:
    """Add one launch of the body a C entry reported to ``by_body``."""
    name = BODIES[code]
    by_body[name] = by_body.get(name, 0) + 1


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (refused launch, bad
    argument): such a launch never ran, and no synchronise reports it."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, *, device, dtypes,
            shape=None) -> None:
    """The wrapper-side argument checks: device, dtype, shape and
    contiguity; the kernels take nothing else."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                        f"{sorted(str(d) for d in dtypes)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (row-major)")


def epilogue_args(ep, bias, residual, *, device, m: int, batch: int,
                  n: int):
    """(bias, residual, act, has_scale, scale) for a C entry.  bias and
    residual are cast to float32 (exact for f32/bf16 operands), which the
    epilogue math runs in anyway; the caller keeps them alive across the
    launch."""
    if ep is None:
        return None, None, ACT_CODES["none"], 0, 1.0
    if ep.bias:
        require(bias, "bias", device=device,
                dtypes=(torch.float32, torch.bfloat16), shape=(m,))
        bias = bias.to(torch.float32)
    else:
        bias = None
    if ep.residual:
        require(residual, "residual", device=device,
                dtypes=(torch.float32, torch.bfloat16),
                shape=(batch, m, n))
        residual = residual.to(torch.float32)
    else:
        residual = None
    scale = 1.0 if ep.scale is None else ep.scale
    return (bias, residual, ACT_CODES[ep.activation],
            int(ep.scale is not None), scale)
