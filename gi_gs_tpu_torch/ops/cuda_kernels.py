"""Build, load and count the port's hand-written CUDA kernels.

The sources in `gi_gs_tpu_torch/csrc/*.cu` have a plain C interface. At
the first CUDA call every one of them is compiled by nvcc for sm_90a, one
process per source started together, linked into one shared library under
`build/torch_kernels/` (keyed by a hash of sources and flags) and loaded
with ctypes. Nothing is built at import time: the CPU tests import every
module of the package on a machine without nvcc.

The sources' `GIGS_API` declarations are the registry: they give each C
function's ctypes argument types (`signatures`), and each launcher that is
neither a `_resources` query nor `gigs_error_string` is a kernel, counted
in `launches` under its name without the `gigs_` prefix. A new kernel is
a .cu file with its launcher and a Python wrapper that calls `launch`.

`launches` counts, per kernel, the launches made by its wrapper; a run
sets the counts to 0 (`reset_launches`) and reads them afterwards to show
which kernels a code path went through. Inside `timed()`, each launch is
also bracketed by CUDA events on its stream, so the device time of the
kernel alone (without its wrapper's torch work) can be read back.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# -fmad=false: no multiply-add contraction, so each kernel rounds like its
# plain PyTorch version (the exact f32 tile cull of `expand` and the bits
# of `sh_fwd` / `sh_bwd` rely on it).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_DECL = re.compile(r"GIGS_API\s+[\w\s*]+?\b(gigs_\w+)\s*\(([^)]*)\)")
_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def sources(csrc: Path = CSRC) -> List[Path]:
    """The library's sources: every .cu file in `csrc`."""
    return sorted(csrc.glob("*.cu"))


def parse_declarations(csrc: Path) -> Dict[str, Tuple[type, ...]]:
    """{C name: ctypes argument types} of every `GIGS_API` function in
    `csrc`'s .cu files: a pointer is c_void_p (as c_int it would be cut to
    32 bits), `int` c_int, `float` c_float; any other parameter raises."""
    decls = {}
    for src in sources(csrc):
        for name, params in _DECL.findall(src.read_text()):
            args = []
            for p in params.split(","):
                ctype = " ".join(re.sub(r"\w+\s*$", "", p).split())
                if "*" in ctype:
                    args.append(ctypes.c_void_p)
                elif ctype in _CTYPES:
                    args.append(_CTYPES[ctype])
                else:
                    raise ValueError(f"{src.name}: {name} has a parameter of "
                                     f"type {ctype!r} (pointer, int or "
                                     f"float only)")
            decls[name] = tuple(args)
    return decls


@functools.lru_cache(maxsize=None)
def signatures() -> Dict[str, Tuple[type, ...]]:
    """The ctypes argument types of every C function of the library: the
    `GIGS_API` declarations in csrc/*.cu, read once."""
    return parse_declarations(CSRC)


# every launcher but the `_resources` queries and the error string
launches: Dict[str, int] = {
    name[len("gigs_"):]: 0 for name in signatures()
    if not name.endswith("_resources") and name != "gigs_error_string"}

_lib: Optional[ctypes.CDLL] = None
# kernel -> its C launcher, resolved when the library loads
_launchers: Dict[str, Callable[..., int]] = {}
_lock = threading.Lock()
# (kernel, start event, end event) per launch while `timed()` is active
_events: Optional[List[Tuple[str, torch.cuda.Event, torch.cuda.Event]]] = None
build_log: str = ""

RESOURCE_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
                 "threads", "blocks_per_sm", "local_bytes", "cluster_size",
                 "active_clusters")


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@contextlib.contextmanager
def timed():
    """Record a pair of CUDA events around every launch made inside the
    block. Yields a dict that, once the block has ended (the device is
    synchronised on exit), maps each kernel to the list of its launches'
    device milliseconds."""
    global _events
    prev, _events = _events, []
    ms: Dict[str, List[float]] = {}
    try:
        yield ms
        torch.cuda.synchronize()
        for name, start, end in _events:
            ms.setdefault(name, []).append(start.elapsed_time(end))
    finally:
        _events = prev


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from gi_gs_tpu_torch/csrc at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()
                       if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the shared library;
    returns its path (an up-to-date library is reused)."""
    global build_log
    so = BUILD_DIR / f"libgigs_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}"
    procs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src.name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = BUILD_DIR / f"libgigs_kernels.{tag}.so"
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *[str(o) for _, o, _ in procs]]
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in signatures().items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.gigs_error_string.restype = ctypes.c_char_p
            _launchers.update({k: getattr(lib, f"gigs_{k}") for k in launches})
            _lib = lib
    return _lib


def launch(kernel: str, device: torch.device, *args) -> None:
    """Call the C launcher `gigs_<kernel>` on `device`'s current stream,
    raise on a launch error, and count the launch."""
    if kernel not in launches:
        raise ValueError(f"no csrc/*.cu declares a launcher gigs_{kernel}")
    lib = library()
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(idx)
    if _events is not None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
    err = _launchers[kernel](idx, *args, stream.cuda_stream)
    if _events is not None:
        end.record(stream)
        _events.append((kernel, start, end))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"{lib.gigs_error_string(err).decode()}")
    launches[kernel] += 1


def resources(fn_name: str, device: torch.device, *args) -> Dict[str, int]:
    """A kernel's registers, shared memory and resident blocks per SM at a
    launch shape, from its C query `fn_name` (`RESOURCE_KEYS`; 0 where the
    kernel does not report a key). Launches nothing and counts nothing."""
    if fn_name not in signatures():
        raise ValueError(f"no csrc/*.cu declares {fn_name}")
    lib = library()
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    out = (ctypes.c_int * len(RESOURCE_KEYS))()
    err = getattr(lib, fn_name)(idx, *args, ctypes.cast(out, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: "
                           f"{lib.gigs_error_string(err).decode()}")
    return dict(zip(RESOURCE_KEYS, out))


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          device: Optional[torch.device] = None) -> None:
    """Validate a kernel argument: CUDA, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
