"""Build and load the port's CUDA kernels (csrc/*.cu) and launch them.

The sources compile with nvcc for sm_90a into one shared library with a
plain C interface, loaded with ctypes; nothing includes PyTorch's headers.
Each point-kernel source builds once per point family (csrc/family.cuh:
-DBPP_FAMILY=0 gives entry point bpp_<kernel>_edwards, 1 gives
bpp_<kernel>_weierstrass at 8 words a coordinate, 2 gives
bpp_<kernel>_weierstrass12 at 12), and all thirteen compilations run at
once; K1 (mont_mul.cu) holds both of its widths in one unit. The build
runs at first use, into bulletproofsplus_tpu_torch/build/ (git-ignored),
keyed by a hash of the sources, so a checkout builds everything it runs from
its own files.

Every C entry point launches on the stream it is given and returns
cudaGetLastError(); `launch` raises on a nonzero code. Launch counters live
on the Python wrappers (`mont_mul.launches`, ...), not here.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("mont_mul.cu", "joint_ladder.cu", "sum_points.cu", "fixed_lookup.cu",
           "ladder.cu")
POINT_SOURCES = SOURCES[1:]
FAMILIES = ("edwards", "weierstrass", "weierstrass12")     # BPP_FAMILY 0, 1, 2
HEADERS = ("field.cuh", "points.cuh", "family.cuh", "ed25519.cuh", "weierstrass.cuh")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U32P = ctypes.POINTER(ctypes.c_uint32)
_POINT_SIGNATURES = {
    "bpp_joint_ladder": [_P, _P, _P, _LL, _I, _I, _U32P],
    "bpp_sum_points": [_P, _P, _LL, _LL, _U32P],
    "bpp_fixed_lookup": [_P, _P, _P, _LL, _I, _I, _U32P],
    "bpp_ladder": [_P, _P, _P, _LL, _I, _U32P],
}
# entry point: argument types before the trailing stream pointer
SIGNATURES = {"bpp_mont_mul": [_P, _P, _P, _LL, _I, _U32P],
              **{f"{name}_{fam}": args for name, args in _POINT_SIGNATURES.items()
                 for fam in FAMILIES}}

_LIB = None
BUILD_LOG = ""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(SRC_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources (one nvcc per file and family, all in parallel)
    and link the shared library; returns its path. Reuses a library of the
    same hash."""
    global BUILD_LOG
    so = os.path.join(BUILD_DIR, f"libbpp_kernels_{_digest()}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    common = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

    def compile_one(unit):
        src, family = unit
        tag = "" if family is None else f".{FAMILIES[family]}"
        obj = os.path.join(BUILD_DIR, src + f"{tag}.{os.getpid()}.o")
        flags = [] if family is None else [f"-DBPP_FAMILY={family}"]
        cmd = [nvcc, *common, *flags, "-Xptxas", "-v", "-c",
               os.path.join(SRC_DIR, src), "-o", obj]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}{tag}:\n{res.stderr}")
        return obj, res.stderr

    units = [(src, None) for src in SOURCES if src not in POINT_SOURCES]
    units += [(src, f) for src in POINT_SOURCES for f in range(len(FAMILIES))]
    with ThreadPoolExecutor(len(units)) as pool:
        results = list(pool.map(compile_one, units))
    tmp = so + f".{os.getpid()}.tmp"
    res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                          *[obj for obj, _ in results]],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stderr}")
    os.replace(tmp, so)
    for obj, _ in results:
        os.remove(obj)
    BUILD_LOG = "".join(log for _, log in results)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(BUILD_LOG)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [*args, _P]
            fn.restype = ctypes.c_int
        lib.bpp_error_string.argtypes = [ctypes.c_int]
        lib.bpp_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_operands(kernel: str, *pairs) -> None:
    """Each (tensor, dtype) must be a CUDA tensor of that dtype, all on one
    device; raise otherwise."""
    device = pairs[0][0].device
    for t, dtype in pairs:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{kernel}: operands must share one CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{kernel}: expected {dtype}, got {t.dtype}")


def launch(name: str, *args, device) -> None:
    """Call C entry point `name` on `device`'s current stream; raise if there
    is no such entry point (an unknown point family) or the launch reports a
    CUDA error."""
    if name not in SIGNATURES:
        raise ValueError(f"no kernel entry point {name!r}")
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.bpp_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data pointer is 16-byte aligned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
