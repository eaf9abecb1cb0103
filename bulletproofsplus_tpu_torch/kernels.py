"""Build and load the port's CUDA kernels (csrc/*.cu) and launch them.

The sources compile with nvcc for sm_90a into one shared library with a
plain C interface, loaded with ctypes; nothing includes PyTorch's headers.
Each point-kernel source builds once per point family (csrc/family.cuh:
-DBPP_FAMILY=0 gives entry point bpp_<kernel>_edwards, 1 gives
bpp_<kernel>_weierstrass at 8 words a coordinate, 2 gives
bpp_<kernel>_weierstrass12 at 12), and all eighteen compilations run at
once; the field kernels (field_ops.cu: K1's product, add, sub, neg, sum,
power and inverse) hold both of their widths in one unit, and the fs256
transcript's chain (fs256_chain.cu) and SHA-256 (sha256.cu), which share
sha256.cuh's compression, are two more. The build runs at first use, into
bulletproofsplus_tpu_torch/build/ (git-ignored), keyed by a hash of the
sources, so a checkout builds everything it runs from its own files.

Every C entry point launches on the stream it is given and returns
cudaGetLastError(); `launch` raises on a nonzero code. Launch counters live
on the Python wrappers (`mont_mul.launches`, ...), not here. A launch costs
the host little: the entry point is looked up once, the stream is read
without building a Stream object, and the device is switched only when the
tensor is not on the current one. `operand` passes a tensor to the field
kernels without copying it where it is aligned, broadcast included.
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
SOURCES = ("field_ops.cu", "sha256.cu", "fs256_chain.cu", "joint_ladder.cu",
           "sum_points.cu", "fixed_lookup.cu", "ladder.cu", "pippenger.cu")
POINT_SOURCES = SOURCES[3:]
FAMILIES = ("edwards", "weierstrass", "weierstrass12")     # BPP_FAMILY 0, 1, 2
HEADERS = ("field.cuh", "points.cuh", "family.cuh", "ed25519.cuh", "weierstrass.cuh",
           "sha256.cuh")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U32P = ctypes.POINTER(ctypes.c_uint32)
_POINT_SIGNATURES = {
    "bpp_joint_ladder": [_P, _P, _P, _LL, _I, _I, _U32P],
    "bpp_sum_points": [_P, _P, _P, _LL, _LL, _I, _I, _I, _U32P],
    "bpp_fixed_lookup": [_P, _P, _P, _LL, _I, _I, _U32P],
    "bpp_ladder": [_P, _P, _P, _LL, _I, _U32P],
    "bpp_pippenger_accumulate": [_P, _P, _P, _LL, _LL, _LL, _I, _I, _I, _U32P],
    "bpp_pippenger_merge": [_P, _P, _LL, _I, _I, _I, _U32P],
    "bpp_pippenger_reduce": [_P, _P, _P, _LL, _I, _I, _I, _U32P],
}
_OPERAND = [_P, _LL, _LL, _LL]                  # pointer, inner, s_inner, s_outer
_FIELD_SIGNATURES = {
    "bpp_mont_mul": [*_OPERAND, *_OPERAND, _P, _LL, _I, _U32P],
    "bpp_fe_add": [*_OPERAND, *_OPERAND, _P, _LL, _I, _U32P],
    "bpp_fe_sub": [*_OPERAND, *_OPERAND, _P, _LL, _I, _U32P],
    "bpp_fe_neg": [*_OPERAND, _P, _LL, _I, _U32P],
    "bpp_fe_sum": [_P, _P, _LL, _LL, _LL, _I, _U32P],
    "bpp_fe_pow": [_P, _P, _LL, _I, _U32P, _I, _U32P],
    "bpp_fe_inv": [_P, _P, _LL, _I, _U32P],
}
# entry point: argument types before the trailing stream pointer
SIGNATURES = {**_FIELD_SIGNATURES, "bpp_sha256_words": [_P, _P, _LL, _I],
              "bpp_fs256_chain": [_P, _P, _P, _P, _P, _LL, _I, _I, _U32P, _I, _U32P],
              **{f"{name}_{fam}": args for name, args in _POINT_SIGNATURES.items()
                 for fam in FAMILIES}}

# point kernels whose entry point bpp_<kernel>_resident_<family>() gives the
# blocks the card holds at once (kernels that size their grid to it)
RESIDENT = ("bpp_sum_points", "bpp_fixed_lookup", "bpp_pippenger_accumulate",
            "bpp_pippenger_reduce")

_LIB = None
_ENTRIES: dict = {}
_RESIDENT: dict = {}
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
        for name in RESIDENT:
            for fam in FAMILIES:
                fn = getattr(lib, f"{name}_resident_{fam}")
                fn.argtypes = []
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


def _entry(name: str):
    """The C function of entry point `name`, looked up once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        if name not in SIGNATURES:
            raise ValueError(f"no kernel entry point {name!r}")
        fn = _ENTRIES[name] = getattr(library(), name)
    return fn


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _raw_stream(index: int) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def launch(name: str, *args, device) -> None:
    """Call C entry point `name` on `device`'s current stream; raise if there
    is no such entry point (an unknown point family) or the launch reports a
    CUDA error."""
    fn = _entry(name)
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index == torch.cuda.current_device():
        err = fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _raw_stream(index))
    if err != 0:
        msg = library().bpp_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def resident_blocks(kernel: str, family: str, device) -> int:
    """Blocks of point kernel `kernel` (one of RESIDENT) of `family` that
    `device` holds at once: its SMs × the blocks an SM fits
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), asked once a device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (kernel, family, index)
    n = _RESIDENT.get(key)
    if n is None:
        if kernel not in RESIDENT or family not in FAMILIES:
            raise ValueError(f"no resident-block query for {kernel}_{family}")
        with torch.cuda.device(index):
            n = getattr(library(), f"{kernel}_resident_{family}")()
        if n < 1:
            raise RuntimeError(f"{kernel}_{family}: occupancy query failed ({n})")
        _RESIDENT[key] = n
    return n


def aligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t whose data pointer is 16-byte aligned (t itself
    where it already is one)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def elementwise(name: str, shape, operands, consts) -> tuple:
    """Launch field kernel `name` (bpp_mont_mul, bpp_fe_add, bpp_fe_sub,
    bpp_fe_neg) over the elements of the broadcast `shape` (..., L), each
    of `operands` read as `operand` passes it; (output, elements). An empty
    shape launches nothing."""
    out = torch.empty(shape, dtype=torch.int32, device=operands[0].device)
    L = shape[-1]
    n = out.numel() // L if L else 0
    if n:
        args, keep = [], []
        for t in operands:
            if t.shape == shape and t.is_contiguous() and t.data_ptr() % 16 == 0:
                args += (t.data_ptr(), n, L, 0)
                continue
            kept, *desc = operand(t, shape)
            keep.append(kept)
            args += desc
        launch(name, *args, out.data_ptr(), n, L, consts, device=out.device)
    return out, n


def broadcast_shape(x, y) -> torch.Size:
    """torch.broadcast_shapes of two shapes, at a fraction of its host cost
    (a field kernel's wrapper runs on every call)."""
    if x == y:
        return x
    rank = max(len(x), len(y))
    x = (1,) * (rank - len(x)) + tuple(x)
    y = (1,) * (rank - len(y)) + tuple(y)
    out = []
    for p, q in zip(x, y):
        if p != q and p != 1 and q != 1:
            raise ValueError(f"shapes {x} and {y} do not broadcast")
        out.append(q if p == 1 else p)
    return torch.Size(out)


def operand(t: torch.Tensor, shape) -> tuple:
    """(tensor to keep alive, pointer, inner, s_inner, s_outer): t broadcast to
    `shape` (..., L) as a field kernel reads it, element i at pointer +
    (i // inner)·s_outer + (i % inner)·s_inner words (csrc/field_ops.cu,
    Operand). A broadcast operand keeps its stride 0 and is not copied; t
    is copied (once, at its own size) only where its words are not
    contiguous or an element would not start 16-byte aligned, and broadcast
    out to `shape` only where its strides do not fold into two levels."""
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % 4 for s in t.stride()[:-1]):
        t = aligned(t)
    v = t.expand(*shape)
    dims = []
    for size, stride in zip(v.shape[:-1], v.stride()[:-1]):
        if size == 1:
            continue
        if dims and dims[-1][1] == stride * size:
            dims[-1] = (dims[-1][0] * size, stride)
        else:
            dims.append((size, stride))
    if len(dims) > 2:
        v = v.contiguous()
        return v, v.data_ptr(), v[..., 0].numel(), shape[-1], 0
    if len(dims) == 2:
        (_, s_outer), (inner, s_inner) = dims
        return t, t.data_ptr(), inner, s_inner, s_outer
    inner, s_inner = dims[0] if dims else (1, 0)
    return t, t.data_ptr(), inner, s_inner, 0
