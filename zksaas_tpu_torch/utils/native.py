"""ctypes loader for the native host kernels (csrc/zkhost.cpp).

Copy of zksaas_tpu/utils/native.py with its own copy of native/zkhost.cpp
under the port's csrc/, so that the port imports nothing of the JAX
package.  Compiles libzkhost.so on first use (g++, into the port's
git-ignored build/ directory, keyed by the source's hash) and
exposes batch Montgomery encode/decode used by Field.encode/decode for
the dealer's big conversions (hundreds of thousands of elements per
proof).  Falls back silently when no compiler is available — callers
must treat `context(spec)` returning None as "use the Python path".

Reference analog: arkworks MontBackend's into/from bigint conversions,
exercised en masse by groth16/src/proving_key.rs:47-123.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "..", "csrc", "zkhost.cpp")


@functools.cache
def _lib():
    from ..kernels import BuildError, build_shared

    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        return None
    try:
        lib = build_shared("zkhost", [src], ["g++", "-O2", "-shared", "-fPIC"])
    except (OSError, subprocess.SubprocessError, BuildError):
        return None
    try:
        L = ctypes.CDLL(lib)
    except OSError:
        return None
    L.zk_ctx_size.restype = ctypes.c_int
    L.zk_ctx_init.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int,
    ]
    for fn in (L.zk_encode, L.zk_decode):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    L.zk_modmul.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_long,
    ]
    return L


class NativeField:
    """Batch conversions for one field spec."""

    def __init__(self, lib, spec):
        self.lib = lib
        self.spec = spec
        self.W = -(-spec.bits // 64)
        self.K16 = spec.nlimbs
        self.ctx = ctypes.create_string_buffer(lib.zk_ctx_size())
        p_b = spec.p.to_bytes(8 * self.W, "little")
        r = 1 << (64 * self.W)
        r2_b = (r * r % spec.p).to_bytes(8 * self.W, "little")
        lib.zk_ctx_init(self.ctx, p_b, r2_b, self.W, self.K16)
        # device Montgomery form uses R16 = 2^(16*K16); ours is
        # R64 = 2^(64*W).  They coincide when 16*K16 == 64*W; otherwise
        # encode must post-scale.  All supported fields satisfy it.
        assert 16 * self.K16 == 64 * self.W, spec.name

    def encode_ints(self, ints) -> np.ndarray:
        """list[int] (reduced mod p) -> (n, K16) uint32 Montgomery."""
        n = len(ints)
        stride = 8 * self.W
        buf = b"".join(v.to_bytes(stride, "little") for v in ints)
        out = np.empty((n, self.K16), dtype=np.uint32)
        self.lib.zk_encode(
            self.ctx, buf, out.ctypes.data_as(ctypes.c_void_p), n
        )
        return out

    def decode_ints(self, arr: np.ndarray) -> list[int]:
        """(n, K16) uint32 Montgomery -> list[int]."""
        arr = np.ascontiguousarray(arr, dtype=np.uint32)
        n = arr.shape[0]
        stride = 8 * self.W
        out = ctypes.create_string_buffer(n * stride)
        self.lib.zk_decode(
            self.ctx, arr.ctypes.data_as(ctypes.c_void_p), out, n
        )
        raw = out.raw
        return [
            int.from_bytes(raw[i * stride : (i + 1) * stride], "little")
            for i in range(n)
        ]


@functools.cache
def context(spec):
    """NativeField for a spec, or None when the native lib is absent."""
    lib = _lib()
    if lib is None:
        return None
    try:
        return NativeField(lib, spec)
    except AssertionError:
        return None
