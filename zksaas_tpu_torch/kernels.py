"""Build, load and count the port's hand-written kernels.

The CUDA sources live in csrc/: field.cuh (the arithmetic, carry-chain Fq
and the safegcd inverse included), add_group.cuh (the complete add, the
k-fold double and the affine+affine add as programs for a group of lanes),
kernels.cuh (the point and ring kernels as templates over the coordinate
ring), kernels.cu (the C interface, montmul, field_rand and the sort) and one
ring_*.cu per coordinate ring.  They are compiled at first use with nvcc for sm_90a, one
nvcc per source, all started together, and linked into one shared library
with a plain C interface, loaded with ctypes, in build/<hash>/ (git-ignored),
where the hash covers the sources and the compiler commands, so a checkout
builds everything itself and a changed source rebuilds.  `host_core()`
builds the same arithmetic with g++ for the CPU tests (csrc/host_core.cpp).

Every field-taking kernel is built for BN254 (8 32-bit limbs, Fq2 nr = -1),
BLS12-381 (12 limbs, nr = -1) and BLS12-377 (12 limbs, nr = -5);
`field_args(spec)` gives a call's (limbs, nr, params).

Each kernel has one `Kernel` record here.  Its wrapper (fields/montmul.py,
fields/field.py, curves/point_ops.py, fields/sortperm.py) calls `check`, which adds one to
`launches` and to the spec's entry of `by_field`, and the launch's lanes to
`elements`, where it launches the kernel and nowhere else, so a run can
show which kernels, and which field instances of them, its path went
through, and how much work they did.  A lane is one Montgomery product,
one element drawn (field_rand), one point (one point for each of k doublings of the k-fold double), one
ring element or one sort key.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass, field

import numpy as np

from .fields.spec import fq2_nonresidue

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]
# NOT_BUILT in csrc/field.cuh: the entry point has no instance for the
# (limbs, nr) it was given
NOT_BUILT = -1


class BuildError(RuntimeError):
    """A compiler was missing or refused a source."""


@dataclass
class Kernel:
    name: str
    source: str  # path in the repo
    replaces: str  # the TPU kernel (file:line) it is the port of
    launches: int = 0
    elements: int = 0  # lanes over all launches
    by_field: dict = field(default_factory=dict)  # launches per field spec name


MONTMUL = Kernel(
    "montmul", "zksaas_tpu_torch/csrc/kernels.cu", "zksaas_tpu/fields/pallas_mul.py:29"
)
POINT_ADD = Kernel(
    "point_add", "zksaas_tpu_torch/csrc/kernels.cuh", "zksaas_tpu/curves/fused.py:252"
)
POINT_ADD_IF = Kernel(
    "point_add_if", "zksaas_tpu_torch/csrc/kernels.cuh", "zksaas_tpu/curves/fused.py:266"
)
POINT_DOUBLE = Kernel(
    "point_double", "zksaas_tpu_torch/csrc/kernels.cuh", "zksaas_tpu/curves/fused.py:283"
)
RING_MUL = Kernel(
    "ring_mul", "zksaas_tpu_torch/csrc/kernels.cuh", "zksaas_tpu/curves/fused.py:300"
)
RING_INV = Kernel(
    "ring_inv", "zksaas_tpu_torch/csrc/kernels.cuh", "zksaas_tpu/curves/fused.py:392"
)
POINT_AADD = Kernel(
    "point_aadd", "zksaas_tpu_torch/csrc/kernels.cuh", "zksaas_tpu/curves/fused.py:375"
)
POINT_MADD_IF = Kernel(
    "point_madd_if", "zksaas_tpu_torch/csrc/kernels.cuh", "zksaas_tpu/curves/fused.py:464"
)
SORT_U32 = Kernel(
    "sort_u32", "zksaas_tpu_torch/csrc/kernels.cu", "zksaas_tpu/fields/sortperm.py:77"
)
FIELD_RAND = Kernel(
    "field_rand", "zksaas_tpu_torch/csrc/kernels.cu", "zksaas_tpu/fields/jfield.py:389"
)
KERNELS = (MONTMUL, POINT_ADD, POINT_ADD_IF, POINT_DOUBLE, RING_MUL, RING_INV, POINT_AADD,
           POINT_MADD_IF, SORT_U32, FIELD_RAND)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
        k.elements = 0
        k.by_field.clear()


def save_launches():
    """The counters as they stand, for `restore_launches`."""
    return [(k.launches, dict(k.by_field), k.elements) for k in KERNELS]


def restore_launches(saved) -> None:
    for k, (n, by, elements) in zip(KERNELS, saved):
        k.launches = n
        k.elements = elements
        k.by_field.clear()
        k.by_field.update(by)


def _digest(commands, files) -> str:
    h = hashlib.sha256(repr(commands).encode())
    for f in files:
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _run(cmds, name):
    """Run the compiler commands at once; raise, with the error output of
    each one that failed, if any did."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = []
    for c, p in zip(cmds, procs):
        _, err = p.communicate(timeout=900)
        if p.returncode != 0:
            errs.append(f"{' '.join(c[:1] + c[-1:])}:\n{err[-4000:]}")
    if errs:
        raise BuildError(f"build of {name} failed:\n" + "\n".join(errs))


def build_shared(name: str, sources, compiler, deps=(), link=None) -> str:
    """Compile `sources` with the `compiler` command into build/<hash>/lib<name>.so
    (reused when present) and return its path.  With `link`, each source is
    compiled to an object by its own process, all at once, and `link` makes
    the library from the objects."""
    out_dir = os.path.join(BUILD, _digest([compiler, link], list(sources) + list(deps)))
    lib = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    if link is None:
        _run([list(compiler) + ["-o", tmp] + list(sources)], name)
    else:
        objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
        _run([list(compiler) + ["-c", "-o", o, s] for o, s in zip(objs, sources)], name)
        _run([list(link) + ["-o", tmp] + objs], name)
        for o in objs:
            os.remove(o)
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


def cuda_sources() -> list:
    """kernels.cu and the ring_*.cu instances, one nvcc each."""
    rings = sorted(f for f in os.listdir(CSRC) if f.startswith("ring_") and f.endswith(".cu"))
    return [os.path.join(CSRC, f) for f in ["kernels.cu"] + rings]


def _headers() -> list:
    return [os.path.join(CSRC, f) for f in ("field.cuh", "add_group.cuh", "kernels.cuh")]


_POINT_ARGS = [ctypes.c_int, ctypes.c_int, ctypes.c_int]  # limbs, nr, ncoord
_RAND_ARGS = [ctypes.c_int, _PTR, _PTR, ctypes.c_long, _PTR]  # limbs, key, out, n, params


@functools.cache
def cuda_lib():
    """Build (first call) and load the CUDA kernels library."""
    path = build_shared("zkkernels", cuda_sources(), [nvcc()] + NVCC_FLAGS, deps=_headers(),
                        link=[nvcc()] + NVCC_FLAGS + ["-shared"])
    L = ctypes.CDLL(path)
    L.zk_montmul.argtypes = [ctypes.c_int, _PTR, _PTR, _PTR, ctypes.c_long, _PTR, _PTR]
    L.zk_point_add.argtypes = _POINT_ARGS + [_PTR] * 9 + [ctypes.c_long, _PTR, _PTR]
    L.zk_point_add_if.argtypes = _POINT_ARGS + [_PTR] * 10 + [ctypes.c_long, _PTR, _PTR]
    L.zk_point_double.argtypes = (
        _POINT_ARGS + [_PTR] * 6 + [ctypes.c_long, ctypes.c_int, _PTR, _PTR]
    )
    L.zk_ring_mul.argtypes = _POINT_ARGS + [_PTR] * 3 + [ctypes.c_long, _PTR, _PTR]
    L.zk_ring_inv.argtypes = _POINT_ARGS + [_PTR] * 2 + [ctypes.c_long, _PTR, _PTR]
    L.zk_point_aadd.argtypes = _POINT_ARGS + [_PTR] * 9 + [ctypes.c_long, _PTR, _PTR]
    L.zk_point_madd_if.argtypes = _POINT_ARGS + [_PTR] * 9 + [ctypes.c_long, _PTR, _PTR]
    L.zk_sort_u32.argtypes = [_PTR, _PTR, ctypes.c_long, ctypes.c_long, _PTR]
    L.zk_sort_u32_scratch_words.argtypes = [ctypes.c_long, ctypes.c_long]
    L.zk_sort_u32_scratch_words.restype = ctypes.c_long
    L.zk_field_rand.argtypes = _RAND_ARGS + [_PTR]
    L.zk_empty.argtypes = [_PTR]
    for fn in (L.zk_montmul, L.zk_point_add, L.zk_point_add_if, L.zk_point_double,
               L.zk_ring_mul, L.zk_ring_inv, L.zk_point_aadd, L.zk_point_madd_if,
               L.zk_sort_u32, L.zk_field_rand, L.zk_empty):
        fn.restype = ctypes.c_int
    return L


@functools.cache
def host_core():
    """g++ build of the kernels' arithmetic (csrc/host_core.cpp) for tests."""
    src = os.path.join(CSRC, "host_core.cpp")
    path = build_shared(
        "zkcore", [src], ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"],
        deps=[os.path.join(CSRC, f) for f in ("field.cuh", "add_group.cuh")],
    )
    L = ctypes.CDLL(path)
    L.zkc_montmul.argtypes = [ctypes.c_int, _PTR, _PTR, _PTR, ctypes.c_long, _PTR]
    L.zkc_point_add_if.argtypes = _POINT_ARGS + [_PTR] * 10 + [ctypes.c_long, _PTR]
    L.zkc_point_double.argtypes = (
        _POINT_ARGS + [_PTR] * 6 + [ctypes.c_long, ctypes.c_int, _PTR]
    )
    L.zkc_ring_mul.argtypes = _POINT_ARGS + [_PTR] * 3 + [ctypes.c_long, _PTR]
    L.zkc_ring_inv.argtypes = _POINT_ARGS + [_PTR] * 2 + [ctypes.c_long, _PTR]
    L.zkc_point_aadd.argtypes = _POINT_ARGS + [_PTR] * 9 + [ctypes.c_long, _PTR]
    L.zkc_point_madd_if.argtypes = _POINT_ARGS + [_PTR] * 9 + [ctypes.c_long, _PTR]
    L.zkc_sort_u32.argtypes = [_PTR, ctypes.c_long, ctypes.c_long]
    L.zkc_field_rand.argtypes = _RAND_ARGS
    return L


@functools.cache
def field_params(spec) -> np.ndarray:
    """The kernels' params (csrc/field.cuh::params_from, inv_params_from):
    p and R mod p in NL 32-bit limbs (8 for a 256-bit field, 12 for a
    384-bit one; R = 2^(32 NL), the port's R), n0 = -p^-1 mod 2^32 (the
    32-bit factor, not spec.n0inv's 16-bit one), then for the safegcd
    inverse R^3 mod p in NL 32-bit limbs, p in (32 NL + 29) // 30 30-bit
    limbs and p^-1 mod 2^30."""
    nl = spec.nlimbs // 2
    if spec.nlimbs % 2 or nl not in (8, 12):
        raise ValueError(f"kernels take 16 or 24 16-bit limbs, not {spec.nlimbs} ({spec.name})")
    limbs = lambda x, bits, n: [(x >> (bits * i)) & ((1 << bits) - 1) for i in range(n)]
    p, R = spec.p, 1 << (32 * nl)
    n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
    return np.array(limbs(p, 32, nl) + limbs(R % p, 32, nl) + [n0]
                    + limbs(pow(R, 3, p), 32, nl) + limbs(p, 30, (32 * nl + 29) // 30)
                    + [pow(p, -1, 1 << 30)], dtype=np.uint32)


def field_args(spec) -> tuple:
    """(32-bit limbs, Fq2 non-residue, params pointer) of a kernel call
    over `spec` (the non-residue is read only by the G2 kernels)."""
    return spec.nlimbs // 2, fq2_nonresidue(spec), field_params(spec).ctypes.data


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check(kernel: Kernel, rc: int, elements: int, spec=None) -> None:
    """Raise on a refused launch; otherwise count it (and under spec.name)
    and its `elements` lanes."""
    if rc == NOT_BUILT:
        raise RuntimeError(f"{kernel.name}: no instance built for {spec.name if spec else rc}")
    if rc != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error {rc}")
    kernel.launches += 1
    kernel.elements += elements
    if spec is not None:
        kernel.by_field[spec.name] = kernel.by_field.get(spec.name, 0) + 1
