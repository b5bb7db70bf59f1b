"""Build, load and count the port's hand-written kernels.

The CUDA sources live in csrc/ (field.cuh, kernels.cu).  They are compiled
at first use with nvcc for sm_90a into a shared library with a plain C
interface, loaded with ctypes, into build/<hash>/ (git-ignored), where the
hash covers the sources and the compiler command, so a checkout builds
everything itself and a changed source rebuilds.  `host_core()` builds the
same arithmetic with g++ for the CPU tests (csrc/host_core.cpp).

Each kernel has one `Kernel` record here.  Its wrapper (fields/montmul.py,
curves/point_ops.py, fields/sortperm.py) adds one to `launches` where it launches the kernel
and nowhere else, so a run can show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


class BuildError(RuntimeError):
    """A compiler was missing or refused a source."""


@dataclass
class Kernel:
    name: str
    source: str  # path in the repo
    replaces: str  # the TPU kernel (file:line) it is the port of
    launches: int = 0


MONTMUL = Kernel(
    "montmul", "zksaas_tpu_torch/csrc/kernels.cu", "zksaas_tpu/fields/pallas_mul.py:29"
)
POINT_ADD = Kernel(
    "point_add", "zksaas_tpu_torch/csrc/kernels.cu", "zksaas_tpu/curves/fused.py:252"
)
POINT_ADD_IF = Kernel(
    "point_add_if", "zksaas_tpu_torch/csrc/kernels.cu", "zksaas_tpu/curves/fused.py:266"
)
POINT_DOUBLE = Kernel(
    "point_double", "zksaas_tpu_torch/csrc/kernels.cu", "zksaas_tpu/curves/fused.py:283"
)
RING_MUL = Kernel(
    "ring_mul", "zksaas_tpu_torch/csrc/kernels.cu", "zksaas_tpu/curves/fused.py:300"
)
RING_INV = Kernel(
    "ring_inv", "zksaas_tpu_torch/csrc/kernels.cu", "zksaas_tpu/curves/fused.py:392"
)
POINT_AADD = Kernel(
    "point_aadd", "zksaas_tpu_torch/csrc/kernels.cu", "zksaas_tpu/curves/fused.py:375"
)
POINT_MADD_IF = Kernel(
    "point_madd_if", "zksaas_tpu_torch/csrc/kernels.cu", "zksaas_tpu/curves/fused.py:464"
)
SORT_U32 = Kernel(
    "sort_u32", "zksaas_tpu_torch/csrc/kernels.cu", "zksaas_tpu/fields/sortperm.py:77"
)
KERNELS = (MONTMUL, POINT_ADD, POINT_ADD_IF, POINT_DOUBLE, RING_MUL, RING_INV, POINT_AADD,
           POINT_MADD_IF, SORT_U32)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def build_shared(name: str, sources, compiler, deps=()) -> str:
    """Compile `sources` with the `compiler` command into build/<hash>/lib<name>.so
    (reused when present) and return its path."""
    h = hashlib.sha256(" ".join(compiler).encode())
    for f in list(sources) + list(deps):
        with open(f, "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(BUILD, h.hexdigest()[:16])
    lib = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    res = subprocess.run(
        list(compiler) + ["-o", tmp] + list(sources),
        capture_output=True, text=True, timeout=900,
    )
    if res.returncode != 0:
        raise BuildError(f"{compiler[0]} failed for {name}:\n{res.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: concurrent builders agree on one file
    return lib


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise BuildError("nvcc not found (CUDA toolkit needed to build the kernels)")


_PTR = ctypes.c_void_p


@functools.cache
def cuda_lib():
    """Build (first call) and load the CUDA kernels library."""
    src = os.path.join(CSRC, "kernels.cu")
    path = build_shared(
        "zkkernels", [src], [nvcc()] + NVCC_FLAGS, deps=[os.path.join(CSRC, "field.cuh")]
    )
    L = ctypes.CDLL(path)
    L.zk_montmul.argtypes = [_PTR, _PTR, _PTR, ctypes.c_long, _PTR, _PTR]
    L.zk_point_add.argtypes = [ctypes.c_int] + [_PTR] * 9 + [ctypes.c_long, _PTR, _PTR]
    L.zk_point_add_if.argtypes = [ctypes.c_int] + [_PTR] * 10 + [ctypes.c_long, _PTR, _PTR]
    L.zk_point_double.argtypes = (
        [ctypes.c_int] + [_PTR] * 6 + [ctypes.c_long, ctypes.c_int, _PTR, _PTR]
    )
    L.zk_ring_mul.argtypes = [ctypes.c_int] + [_PTR] * 3 + [ctypes.c_long, _PTR, _PTR]
    L.zk_ring_inv.argtypes = [ctypes.c_int] + [_PTR] * 2 + [ctypes.c_long, _PTR, _PTR]
    L.zk_point_aadd.argtypes = [ctypes.c_int] + [_PTR] * 9 + [ctypes.c_long, _PTR, _PTR]
    L.zk_point_madd_if.argtypes = [ctypes.c_int] + [_PTR] * 9 + [ctypes.c_long, _PTR, _PTR]
    L.zk_sort_u32.argtypes = [_PTR, ctypes.c_long, ctypes.c_long, _PTR]
    for fn in (L.zk_montmul, L.zk_point_add, L.zk_point_add_if, L.zk_point_double,
               L.zk_ring_mul, L.zk_ring_inv, L.zk_point_aadd, L.zk_point_madd_if,
               L.zk_sort_u32):
        fn.restype = ctypes.c_int
    return L


@functools.cache
def host_core():
    """g++ build of the kernels' arithmetic (csrc/host_core.cpp) for tests."""
    src = os.path.join(CSRC, "host_core.cpp")
    path = build_shared(
        "zkcore", [src], ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"],
        deps=[os.path.join(CSRC, "field.cuh")],
    )
    L = ctypes.CDLL(path)
    L.zkc_montmul.argtypes = [_PTR, _PTR, _PTR, ctypes.c_long, _PTR]
    L.zkc_point_add_if.argtypes = [ctypes.c_int] + [_PTR] * 10 + [ctypes.c_long, _PTR]
    L.zkc_point_double.argtypes = (
        [ctypes.c_int] + [_PTR] * 6 + [ctypes.c_long, ctypes.c_int, _PTR]
    )
    L.zkc_ring_mul.argtypes = [ctypes.c_int] + [_PTR] * 3 + [ctypes.c_long, _PTR]
    L.zkc_ring_inv.argtypes = [ctypes.c_int] + [_PTR] * 2 + [ctypes.c_long, _PTR]
    L.zkc_point_aadd.argtypes = [ctypes.c_int] + [_PTR] * 9 + [ctypes.c_long, _PTR]
    L.zkc_point_madd_if.argtypes = [ctypes.c_int] + [_PTR] * 9 + [ctypes.c_long, _PTR]
    L.zkc_sort_u32.argtypes = [_PTR, ctypes.c_long, ctypes.c_long]
    return L


@functools.cache
def field_params(spec) -> np.ndarray:
    """(p, R mod p, n0) as the kernels' FieldParams: 8 32-bit limbs each and
    n0 = -p^-1 mod 2^32 (the 32-bit factor, not spec.n0inv's 16-bit one)."""
    if spec.nlimbs != 16:
        raise NotImplementedError(f"kernels are built for 256-bit fields only, not {spec.name}")
    limbs = lambda x: [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    n0 = (-pow(spec.p, -1, 1 << 32)) % (1 << 32)
    return np.array(limbs(spec.p) + limbs(spec.r_mod_p) + [n0], dtype=np.uint32)


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(kernel: Kernel, rc: int) -> None:
    """Raise on a refused launch; otherwise count it."""
    if rc != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error {rc}")
    kernel.launches += 1
