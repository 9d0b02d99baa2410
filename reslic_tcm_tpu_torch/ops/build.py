"""Build and load the port's native libraries (route: compiler + ctypes).

Every library is one source file compiled into one shared object with a
plain C interface, loaded with ``ctypes``:

* the CUDA kernels in ``reslic_tcm_tpu_torch/csrc/*.cu``, compiled by
  ``nvcc`` for ``sm_90a`` (Hopper), without ``-use_fast_math`` (the device
  coder's kernels must round every float32 operation as XLA does);
* the host rANS coder ``coding/csrc/rans.cpp`` and PNG's row unfilter
  ``data/csrc/png_unfilter.cpp``, compiled by ``g++``.

Nothing includes PyTorch's headers, so each build takes seconds. The
objects go to ``reslic_tcm_tpu_torch/_build/`` (listed in ``.gitignore``)
under a name that carries a hash of the source, of every local header it
includes (``#include "..."``, followed recursively) and of the flags, so an
edited source or header is rebuilt and a stale object is never loaded. Each compiler writes
to a private temporary name that is renamed into place when it succeeds:
no lock files, and concurrent builders (pytest workers) cannot see a
half-written object. All missing objects are compiled in parallel, one
compiler process per source, each under a hard timeout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# name -> (source relative to the package, compiler[, extra flags]). B1's
# bf16 LN+MLP source builds as two libraries (C <= 96, and C >= 128),
# compiled at once: one took twice as long as any other source; its
# attention-only flavour is a source of its own.
SOURCES = {
    "flash_window_attn": ("csrc/flash_window_attn.cu", "nvcc"),
    "flash_window_attn_bf16": ("csrc/flash_window_attn_bf16.cu", "nvcc"),
    "flash_window_attn_bf16_wide": ("csrc/flash_window_attn_bf16.cu", "nvcc", ("-DSWIN_WIDE",)),
    "window_attn_bf16": ("csrc/window_attn_bf16.cu", "nvcc"),
    "fused_conv": ("csrc/fused_conv.cu", "nvcc"),
    "fused_conv_bf16": ("csrc/fused_conv_bf16.cu", "nvcc"),
    "qkv_attention": ("csrc/qkv_attention.cu", "nvcc"),
    "device_rans": ("csrc/device_rans.cu", "nvcc"),
    "rans": ("coding/csrc/rans.cpp", "g++"),
    "png_unfilter": ("data/csrc/png_unfilter.cpp", "g++"),
}

BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cuda):
        return cuda
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _flags(name: str) -> tuple:
    src, compiler, *extra = SOURCES[name]
    return (NVCC_FLAGS if compiler == "nvcc" else GXX_FLAGS) + (extra[0] if extra else ())


def _command(name: str, out: str) -> list[str]:
    src, compiler = SOURCES[name][:2]
    src = os.path.join(_PKG, src)
    if compiler == "nvcc":
        return [_nvcc(), *_flags(name), src, "-o", out]
    return ["g++", *_flags(name), src, "-o", out]


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[str]:
    """The library's source and the local headers it includes, recursively
    (paths relative to the package, in the order first reached)."""
    files: list[str] = []

    def visit(rel: str) -> None:
        if rel in files:
            return
        files.append(rel)
        with open(os.path.join(_PKG, rel), "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            visit(os.path.normpath(os.path.join(os.path.dirname(rel), inc.decode())))

    visit(SOURCES[name][0])
    return files


def library_path(name: str) -> str:
    compiler = SOURCES[name][1]
    flags = _flags(name)
    h = hashlib.sha256()
    for rel in source_files(name):
        h.update(rel.encode() + b"\0")
        with open(os.path.join(_PKG, rel), "rb") as f:
            h.update(f.read())
    h.update(" ".join((compiler,) + flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=None) -> dict[str, dict]:
    """Compile every library in ``names`` (default: all) whose object is
    missing, all compilers running at once. Returns, per name, the object's
    path, the seconds its compile took (0.0 when it was already built) and
    the compiler's diagnostics (``ptxas`` register and shared-memory lines
    for the CUDA kernels). Raises when a compiler fails or times out."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    report = {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        report[name] = {"path": path, "seconds": 0.0, "log": ""}
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ), tmp)
    errors = []

    def finish(name, proc, tmp):
        # one waiter per compiler, so each one's seconds end when it does
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            errors.append(f"{name}: compiler timed out after {BUILD_TIMEOUT_S} s")
            return
        report[name]["seconds"] = time.perf_counter() - t0
        report[name]["log"] = log
        if proc.returncode != 0:
            errors.append(f"{name}: compiler exited {proc.returncode}\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            return
        os.replace(tmp, report[name]["path"])

    waiters = [threading.Thread(target=finish, args=(name, *pt)) for name, pt in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    if errors:
        raise RuntimeError("native build failed:\n" + "\n".join(errors))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if its object is missing."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _loaded:
            path = build([name])[name]["path"]
            _loaded[name] = ctypes.CDLL(path)
        return _loaded[name]


# ------------------------------ calling kernels ------------------------------


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device, for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_inference(*tensors) -> None:
    """The kernels have no backward: refuse inputs that want a gradient."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the CUDA kernels are inference-only: call them under torch.no_grad()")


def check_tensor(name: str, t, shape, device, contiguous: bool = False) -> None:
    import torch

    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_params(device, **params) -> None:
    """Each keyword is ``name=(tensor, expected_shape)``."""
    for name, (t, shape) in params.items():
        check_tensor(name, t, shape, device)
