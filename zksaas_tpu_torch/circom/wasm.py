"""Minimal WebAssembly interpreter for circom witness generators.

Port of zksaas_tpu/circom/wasm.py, host-only like it: the reference runs
the circom-compiled wasm module through a JS host
(fixtures/sha256/sha256_js/witness_calculator.js, generate_witness.js);
this module executes the same `.wasm` artifact in pure Python, from circom
artifacts + JSON inputs to a full witness with no node or wasmtime.

Scope: the integer subset of WebAssembly MVP that circom 2.x emits:
i32/i64 arithmetic, memory, structured control flow, direct calls.  No
floats, no call_indirect and no globals are needed by circom modules; the
decoder raises with a clear message on anything outside the subset.
Speed is "good enough for fixtures", not a goal.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

PAGE = 65536
M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF

# value types
_VALTYPES = {0x7F: "i32", 0x7E: "i64", 0x7D: "f32", 0x7C: "f64"}


class WasmTrap(RuntimeError):
    """Raised for wasm traps and circom runtime exceptions."""


class _Reader:
    __slots__ = ("d", "i")

    def __init__(self, data: bytes, i: int = 0):
        self.d = data
        self.i = i

    def byte(self) -> int:
        b = self.d[self.i]
        self.i += 1
        return b

    def u(self) -> int:
        r = s = 0
        while True:
            b = self.d[self.i]
            self.i += 1
            r |= (b & 0x7F) << s
            s += 7
            if not b & 0x80:
                return r

    def s(self) -> int:
        r = s = 0
        while True:
            b = self.d[self.i]
            self.i += 1
            r |= (b & 0x7F) << s
            s += 7
            if not b & 0x80:
                if b & 0x40:
                    r -= 1 << s
                return r

    def bytes_(self, n: int) -> bytes:
        b = self.d[self.i : self.i + n]
        self.i += n
        return b

    def name(self) -> str:
        return self.bytes_(self.u()).decode("utf-8")


# ---------------------------------------------------------------------------
# Structured instruction tree.  Plain ops are (op, imm) tuples; control
# constructs carry nested bodies so the executor can restore the value
# stack to the frame's entry height on branches without any static
# stack-height analysis.
#   ("block", arity, body)  ("loop", arity, body)
#   ("if", arity, then_body, else_body)
# Branch ops carry the relative depth; "return" uses the _RET sentinel.
# ---------------------------------------------------------------------------

_RET = 1 << 30


def _block_arity(r: _Reader) -> int:
    bt = r.d[r.i]
    if bt == 0x40:
        r.i += 1
        return 0
    if bt in _VALTYPES:
        r.i += 1
        return 1
    raise WasmTrap(f"multi-value block type {bt:#x} not in the circom subset")


def _decode_body(r: _Reader, end_op_terminates: bool = True):
    """Decode instructions until the matching `end`, returning a list."""
    body = []
    d = r.d
    while True:
        op = d[r.i]
        r.i += 1
        if op == 0x0B:  # end
            return body
        if op == 0x02:  # block
            a = _block_arity(r)
            body.append(("block", a, _decode_body(r)))
        elif op == 0x03:  # loop
            a = _block_arity(r)
            body.append(("loop", a, _decode_body(r)))
        elif op == 0x04:  # if
            a = _block_arity(r)
            then_body, else_body = _decode_if(r)
            body.append(("if", a, then_body, else_body))
        elif op in (0x0C, 0x0D):  # br / br_if
            body.append((op, r.u()))
        elif op == 0x0E:  # br_table
            n = r.u()
            targets = [r.u() for _ in range(n)]
            targets.append(r.u())  # default
            body.append((op, targets))
        elif op == 0x0F:  # return
            body.append((op, None))
        elif op == 0x10:  # call
            body.append((op, r.u()))
        elif op == 0x11:
            raise WasmTrap("call_indirect not in the circom subset")
        elif op in (0x20, 0x21, 0x22, 0x23, 0x24):  # local/global get/set/tee
            body.append((op, r.u()))
        elif 0x28 <= op <= 0x3E:  # loads/stores: align + offset
            r.u()
            body.append((op, r.u()))
        elif op in (0x3F, 0x40):  # memory.size / grow
            r.u()
            body.append((op, None))
        elif op == 0x41:  # i32.const
            body.append((op, r.s() & M32))
        elif op == 0x42:  # i64.const
            body.append((op, r.s() & M64))
        elif op in (0x00, 0x01, 0x1A, 0x1B):  # unreachable/nop/drop/select
            body.append((op, None))
        elif 0x45 <= op <= 0xC4:  # numeric ops, conversions, sign-extends
            body.append((op, None))
        else:
            raise WasmTrap(f"opcode {op:#x} not in the circom subset")


def _decode_if(r: _Reader):
    """Decode an `if` construct: then-body until else/end, else-body."""
    then_body = []
    d = r.d
    while True:
        op = d[r.i]
        if op == 0x05:  # else
            r.i += 1
            return then_body, _decode_body(r)
        if op == 0x0B:  # end (no else)
            r.i += 1
            return then_body, []
        # delegate single-instruction decoding by re-entering the main
        # decoder on a synthetic one-instruction stream is messy; instead
        # inline: reuse _decode_body's logic via _decode_one
        then_body.append(_decode_one(r))


def _decode_one(r: _Reader):
    op = r.d[r.i]
    r.i += 1
    if op == 0x02:
        a = _block_arity(r)
        return ("block", a, _decode_body(r))
    if op == 0x03:
        a = _block_arity(r)
        return ("loop", a, _decode_body(r))
    if op == 0x04:
        a = _block_arity(r)
        t, e = _decode_if(r)
        return ("if", a, t, e)
    if op in (0x0C, 0x0D, 0x10, 0x20, 0x21, 0x22, 0x23, 0x24):
        return (op, r.u())
    if op == 0x0E:
        n = r.u()
        targets = [r.u() for _ in range(n)]
        targets.append(r.u())
        return (op, targets)
    if op == 0x0F:
        return (op, None)
    if op == 0x11:
        raise WasmTrap("call_indirect not in the circom subset")
    if 0x28 <= op <= 0x3E:
        r.u()
        return (op, r.u())
    if op in (0x3F, 0x40):
        r.u()
        return (op, None)
    if op == 0x41:
        return (op, r.s() & M32)
    if op == 0x42:
        return (op, r.s() & M64)
    if op in (0x00, 0x01, 0x1A, 0x1B):
        return (op, None)
    if 0x45 <= op <= 0xC4:
        return (op, None)
    raise WasmTrap(f"opcode {op:#x} not in the circom subset")


@dataclass
class _Func:
    n_params: int
    n_results: int
    n_locals: int = 0
    body: list = field(default_factory=list)


class WasmModule:
    """Parsed + instantiable circom-subset wasm module.

    `imports` maps "module.name" -> python callable taking unsigned int
    args and returning an int result (or None for void).
    """

    def __init__(self, data: bytes, imports: dict):
        if data[:4] != b"\x00asm" or struct.unpack("<I", data[4:8])[0] != 1:
            raise WasmTrap("not a wasm v1 module")
        r = _Reader(data, 8)
        types: list[tuple[list, list]] = []
        self.funcs: list = []  # host callables or _Func
        func_type_idx: list[int] = []
        self.mem = bytearray()
        self._mem_max_pages = None
        self.exports: dict[str, int] = {}
        self._export_mem = None
        code_payload = None

        while r.i < len(data):
            sid = r.byte()
            size = r.u()
            end = r.i + size
            if sid == 1:  # types
                for _ in range(r.u()):
                    if r.byte() != 0x60:
                        raise WasmTrap("bad functype")
                    ps = [r.byte() for _ in range(r.u())]
                    rs = [r.byte() for _ in range(r.u())]
                    types.append((ps, rs))
            elif sid == 2:  # imports
                for _ in range(r.u()):
                    mod, nm = r.name(), r.name()
                    kind = r.byte()
                    if kind == 0:
                        ti = r.u()
                        key = f"{mod}.{nm}"
                        if key not in imports:
                            raise WasmTrap(f"unresolved import {key}")
                        self.funcs.append(imports[key])
                        func_type_idx.append(ti)
                    else:
                        raise WasmTrap(
                            f"import kind {kind} not in the circom subset"
                        )
            elif sid == 3:  # function declarations
                for _ in range(r.u()):
                    func_type_idx.append(r.u())
            elif sid == 5:  # memory
                n = r.u()
                if n != 1:
                    raise WasmTrap("expected exactly one memory")
                flags = r.byte()
                mn = r.u()
                if flags & 1:
                    self._mem_max_pages = r.u()
                self.mem = bytearray(mn * PAGE)
            elif sid == 7:  # exports
                for _ in range(r.u()):
                    nm = r.name()
                    kind = r.byte()
                    idx = r.u()
                    if kind == 0:
                        self.exports[nm] = idx
                    elif kind == 2:
                        self._export_mem = idx
                r.i = end
            elif sid == 10:  # code — decode after all sections are known
                code_payload = r.i
                r.i = end
            elif sid == 11:  # data
                for _ in range(r.u()):
                    mode = r.u()
                    if mode != 0:
                        raise WasmTrap("passive data not in the circom subset")
                    # offset expr: i32.const N end
                    if r.byte() != 0x41:
                        raise WasmTrap("non-const data offset")
                    off = r.s()
                    if r.byte() != 0x0B:
                        raise WasmTrap("bad data offset expr")
                    seg = r.bytes_(r.u())
                    self.mem[off : off + len(seg)] = seg
            else:
                # table/elem/global/custom/start: circom modules carry a
                # table+elem pair that is never call_indirect'ed, and no
                # globals or start function — skip.
                r.i = end
            if r.i != end and sid not in (10,):
                r.i = end

        # decode code bodies
        n_imported = len(self.funcs)
        if code_payload is not None:
            cr = _Reader(data, code_payload)
            n = cr.u()
            for k in range(n):
                ti = func_type_idx[n_imported + k]
                ps, rs = types[ti]
                bsz = cr.u()
                bend = cr.i + bsz
                n_locals = 0
                for _ in range(cr.u()):
                    cnt = cr.u()
                    cr.byte()  # local valtype
                    n_locals += cnt
                f = _Func(len(ps), len(rs), n_locals, _decode_body(cr))
                if cr.i != bend:
                    raise WasmTrap("code body decode out of sync")
                self.funcs.append(f)
        # patch host import signatures (arg counts) for dispatch
        self._n_params = []
        for k, fn in enumerate(self.funcs):
            if isinstance(fn, _Func):
                self._n_params.append(fn.n_params)
            else:
                ps, rs = types[func_type_idx[k]]
                self._n_params.append(len(ps))

    # -- execution ---------------------------------------------------------

    def invoke(self, name: str, *args: int) -> int | None:
        if name not in self.exports:
            raise WasmTrap(f"no export {name}")
        res = self._call(self.exports[name], list(args))
        return res[0] if res else None

    def _call(self, fidx: int, args: list[int]) -> list[int]:
        fn = self.funcs[fidx]
        if not isinstance(fn, _Func):  # host import
            r = fn(*args)
            return [] if r is None else [int(r) & M64]
        locals_ = args + [0] * fn.n_locals
        stack: list[int] = []
        r = self._exec(fn.body, stack, locals_)
        if fn.n_results:
            return [stack[-1]]
        return []

    def _exec(self, body: list, stack: list, loc: list):
        """Execute a decoded body.  Returns None on fallthrough, or a
        branch depth relative to the enclosing frame (0 = this frame's
        parent construct), or _RET for `return`."""
        mem = self.mem
        call = self._call
        for ins in body:
            op = ins[0]
            # --- hottest ops first -------------------------------------
            if op == 0x41 or op == 0x42:  # i32/i64.const
                stack.append(ins[1])
            elif op == 0x20:  # local.get
                stack.append(loc[ins[1]])
            elif op == 0x6A:  # i32.add
                b = stack.pop()
                stack[-1] = (stack[-1] + b) & M32
            elif op == 0x6C:  # i32.mul
                b = stack.pop()
                stack[-1] = (stack[-1] * b) & M32
            elif op == 0x10:  # call
                fi = ins[1]
                fn = self.funcs[fi]
                np_ = self._n_params[fi]
                args = stack[len(stack) - np_ :] if np_ else []
                if np_:
                    del stack[len(stack) - np_ :]
                stack.extend(call(fi, args))
            elif op == 0x21:  # local.set
                loc[ins[1]] = stack.pop()
            elif op == 0x22:  # local.tee
                loc[ins[1]] = stack[-1]
            elif op == 0x28:  # i32.load
                a = stack[-1] + ins[1]
                stack[-1] = int.from_bytes(mem[a : a + 4], "little")
            elif op == 0x36:  # i32.store
                v = stack.pop()
                a = stack.pop() + ins[1]
                mem[a : a + 4] = v.to_bytes(4, "little")
            elif op == 0x7C:  # i64.add
                b = stack.pop()
                stack[-1] = (stack[-1] + b) & M64
            elif op == 0x7E:  # i64.mul
                b = stack.pop()
                stack[-1] = (stack[-1] * b) & M64
            elif op == 0x88:  # i64.shr_u
                b = stack.pop() & 63
                stack[-1] >>= b
            elif op == 0x86:  # i64.shl
                b = stack.pop() & 63
                stack[-1] = (stack[-1] << b) & M64
            elif op == 0x83:  # i64.and
                b = stack.pop()
                stack[-1] &= b
            elif op == 0x45:  # i32.eqz
                stack[-1] = 1 if stack[-1] == 0 else 0
            elif op == 0xA7:  # i32.wrap_i64
                stack[-1] &= M32
            elif op == 0xAD:  # i64.extend_i32_u
                pass
            # --- control ------------------------------------------------
            elif op == "block":
                h = len(stack)
                r = self._exec(ins[2], stack, loc)
                if r is None:
                    continue
                if r == 0:
                    a = ins[1]
                    if a:
                        vals = stack[len(stack) - a :]
                        del stack[h:]
                        stack.extend(vals)
                    else:
                        del stack[h:]
                    continue
                return r - 1 if r != _RET else _RET
            elif op == "loop":
                h = len(stack)
                while True:
                    r = self._exec(ins[2], stack, loc)
                    if r is None:
                        break
                    if r == 0:  # backedge: loop label has no results
                        del stack[h:]
                        continue
                    return r - 1 if r != _RET else _RET
            elif op == "if":
                c = stack.pop()
                h = len(stack)
                r = self._exec(ins[2] if c else ins[3], stack, loc)
                if r is None:
                    continue
                if r == 0:
                    a = ins[1]
                    if a:
                        vals = stack[len(stack) - a :]
                        del stack[h:]
                        stack.extend(vals)
                    else:
                        del stack[h:]
                    continue
                return r - 1 if r != _RET else _RET
            elif op == 0x0C:  # br
                return ins[1]
            elif op == 0x0D:  # br_if
                if stack.pop():
                    return ins[1]
            elif op == 0x0E:  # br_table
                i = stack.pop()
                t = ins[1]
                return t[i] if i < len(t) - 1 else t[-1]
            elif op == 0x0F:  # return
                return _RET
            # --- remaining memory ops ----------------------------------
            elif op == 0x29:  # i64.load
                a = stack[-1] + ins[1]
                stack[-1] = int.from_bytes(mem[a : a + 8], "little")
            elif op == 0x2C:  # i32.load8_s
                a = stack[-1] + ins[1]
                v = mem[a]
                stack[-1] = (v - 256 if v & 0x80 else v) & M32
            elif op == 0x2D:  # i32.load8_u
                stack[-1] = mem[stack[-1] + ins[1]]
            elif op == 0x2E:  # i32.load16_s
                a = stack[-1] + ins[1]
                v = int.from_bytes(mem[a : a + 2], "little")
                stack[-1] = (v - 65536 if v & 0x8000 else v) & M32
            elif op == 0x2F:  # i32.load16_u
                a = stack[-1] + ins[1]
                stack[-1] = int.from_bytes(mem[a : a + 2], "little")
            elif op == 0x30:  # i64.load8_s
                a = stack[-1] + ins[1]
                v = mem[a]
                stack[-1] = (v - 256 if v & 0x80 else v) & M64
            elif op == 0x31:  # i64.load8_u
                stack[-1] = mem[stack[-1] + ins[1]]
            elif op == 0x32:  # i64.load16_s
                a = stack[-1] + ins[1]
                v = int.from_bytes(mem[a : a + 2], "little")
                stack[-1] = (v - 65536 if v & 0x8000 else v) & M64
            elif op == 0x33:  # i64.load16_u
                a = stack[-1] + ins[1]
                stack[-1] = int.from_bytes(mem[a : a + 2], "little")
            elif op == 0x34:  # i64.load32_s
                a = stack[-1] + ins[1]
                v = int.from_bytes(mem[a : a + 4], "little")
                stack[-1] = (v - (1 << 32) if v & 0x80000000 else v) & M64
            elif op == 0x35:  # i64.load32_u
                a = stack[-1] + ins[1]
                stack[-1] = int.from_bytes(mem[a : a + 4], "little")
            elif op == 0x37:  # i64.store
                v = stack.pop()
                a = stack.pop() + ins[1]
                mem[a : a + 8] = v.to_bytes(8, "little")
            elif op == 0x3A:  # i32.store8
                v = stack.pop()
                mem[stack.pop() + ins[1]] = v & 0xFF
            elif op == 0x3B:  # i32.store16
                v = stack.pop()
                a = stack.pop() + ins[1]
                mem[a : a + 2] = (v & 0xFFFF).to_bytes(2, "little")
            elif op == 0x3C:  # i64.store8
                v = stack.pop()
                mem[stack.pop() + ins[1]] = v & 0xFF
            elif op == 0x3D:  # i64.store16
                v = stack.pop()
                a = stack.pop() + ins[1]
                mem[a : a + 2] = (v & 0xFFFF).to_bytes(2, "little")
            elif op == 0x3E:  # i64.store32
                v = stack.pop()
                a = stack.pop() + ins[1]
                mem[a : a + 4] = (v & M32).to_bytes(4, "little")
            elif op == 0x3F:  # memory.size
                stack.append(len(mem) // PAGE)
            elif op == 0x40:  # memory.grow
                old = len(mem) // PAGE
                n = stack.pop()
                if self._mem_max_pages is not None and old + n > self._mem_max_pages:
                    stack.append(M32)  # -1
                else:
                    mem.extend(bytes(n * PAGE))
                    stack.append(old)
            # --- parametric --------------------------------------------
            elif op == 0x1A:  # drop
                stack.pop()
            elif op == 0x1B:  # select
                c = stack.pop()
                b = stack.pop()
                if not c:
                    stack[-1] = b
            elif op == 0x01:  # nop
                pass
            elif op == 0x00:  # unreachable
                raise WasmTrap("unreachable executed")
            # --- comparisons -------------------------------------------
            elif op == 0x46:  # i32.eq
                b = stack.pop()
                stack[-1] = 1 if stack[-1] == b else 0
            elif op == 0x47:  # i32.ne
                b = stack.pop()
                stack[-1] = 1 if stack[-1] != b else 0
            elif op == 0x48:  # i32.lt_s
                b = _s32(stack.pop())
                stack[-1] = 1 if _s32(stack[-1]) < b else 0
            elif op == 0x49:  # i32.lt_u
                b = stack.pop()
                stack[-1] = 1 if stack[-1] < b else 0
            elif op == 0x4A:  # i32.gt_s
                b = _s32(stack.pop())
                stack[-1] = 1 if _s32(stack[-1]) > b else 0
            elif op == 0x4B:  # i32.gt_u
                b = stack.pop()
                stack[-1] = 1 if stack[-1] > b else 0
            elif op == 0x4C:  # i32.le_s
                b = _s32(stack.pop())
                stack[-1] = 1 if _s32(stack[-1]) <= b else 0
            elif op == 0x4D:  # i32.le_u
                b = stack.pop()
                stack[-1] = 1 if stack[-1] <= b else 0
            elif op == 0x4E:  # i32.ge_s
                b = _s32(stack.pop())
                stack[-1] = 1 if _s32(stack[-1]) >= b else 0
            elif op == 0x4F:  # i32.ge_u
                b = stack.pop()
                stack[-1] = 1 if stack[-1] >= b else 0
            elif op == 0x50:  # i64.eqz
                stack[-1] = 1 if stack[-1] == 0 else 0
            elif op == 0x51:  # i64.eq
                b = stack.pop()
                stack[-1] = 1 if stack[-1] == b else 0
            elif op == 0x52:  # i64.ne
                b = stack.pop()
                stack[-1] = 1 if stack[-1] != b else 0
            elif op == 0x53:  # i64.lt_s
                b = _s64(stack.pop())
                stack[-1] = 1 if _s64(stack[-1]) < b else 0
            elif op == 0x54:  # i64.lt_u
                b = stack.pop()
                stack[-1] = 1 if stack[-1] < b else 0
            elif op == 0x55:  # i64.gt_s
                b = _s64(stack.pop())
                stack[-1] = 1 if _s64(stack[-1]) > b else 0
            elif op == 0x56:  # i64.gt_u
                b = stack.pop()
                stack[-1] = 1 if stack[-1] > b else 0
            elif op == 0x57:  # i64.le_s
                b = _s64(stack.pop())
                stack[-1] = 1 if _s64(stack[-1]) <= b else 0
            elif op == 0x58:  # i64.le_u
                b = stack.pop()
                stack[-1] = 1 if stack[-1] <= b else 0
            elif op == 0x59:  # i64.ge_s
                b = _s64(stack.pop())
                stack[-1] = 1 if _s64(stack[-1]) >= b else 0
            elif op == 0x5A:  # i64.ge_u
                b = stack.pop()
                stack[-1] = 1 if stack[-1] >= b else 0
            # --- i32 arithmetic ----------------------------------------
            elif op == 0x6B:  # i32.sub
                b = stack.pop()
                stack[-1] = (stack[-1] - b) & M32
            elif op == 0x6D:  # i32.div_s
                b = _s32(stack.pop())
                a = _s32(stack[-1])
                if b == 0:
                    raise WasmTrap("i32.div_s by zero")
                q = abs(a) // abs(b)
                stack[-1] = (q if (a < 0) == (b < 0) else -q) & M32
            elif op == 0x6E:  # i32.div_u
                b = stack.pop()
                if b == 0:
                    raise WasmTrap("i32.div_u by zero")
                stack[-1] //= b
            elif op == 0x6F:  # i32.rem_s
                b = _s32(stack.pop())
                a = _s32(stack[-1])
                if b == 0:
                    raise WasmTrap("i32.rem_s by zero")
                stack[-1] = (abs(a) % abs(b) * (1 if a >= 0 else -1)) & M32
            elif op == 0x70:  # i32.rem_u
                b = stack.pop()
                if b == 0:
                    raise WasmTrap("i32.rem_u by zero")
                stack[-1] %= b
            elif op == 0x71:  # i32.and
                b = stack.pop()
                stack[-1] &= b
            elif op == 0x72:  # i32.or
                b = stack.pop()
                stack[-1] |= b
            elif op == 0x73:  # i32.xor
                b = stack.pop()
                stack[-1] ^= b
            elif op == 0x74:  # i32.shl
                b = stack.pop() & 31
                stack[-1] = (stack[-1] << b) & M32
            elif op == 0x75:  # i32.shr_s
                b = stack.pop() & 31
                stack[-1] = (_s32(stack[-1]) >> b) & M32
            elif op == 0x76:  # i32.shr_u
                b = stack.pop() & 31
                stack[-1] >>= b
            elif op == 0x77:  # i32.rotl
                b = stack.pop() & 31
                a = stack[-1]
                stack[-1] = ((a << b) | (a >> (32 - b))) & M32 if b else a
            elif op == 0x78:  # i32.rotr
                b = stack.pop() & 31
                a = stack[-1]
                stack[-1] = ((a >> b) | (a << (32 - b))) & M32 if b else a
            elif op == 0x67:  # i32.clz
                a = stack[-1]
                stack[-1] = 32 - a.bit_length() if a else 32
            elif op == 0x68:  # i32.ctz
                a = stack[-1]
                stack[-1] = (a & -a).bit_length() - 1 if a else 32
            elif op == 0x69:  # i32.popcnt
                stack[-1] = bin(stack[-1]).count("1")
            # --- i64 arithmetic ----------------------------------------
            elif op == 0x7D:  # i64.sub
                b = stack.pop()
                stack[-1] = (stack[-1] - b) & M64
            elif op == 0x7F:  # i64.div_s
                b = _s64(stack.pop())
                a = _s64(stack[-1])
                if b == 0:
                    raise WasmTrap("i64.div_s by zero")
                q = abs(a) // abs(b)
                stack[-1] = (q if (a < 0) == (b < 0) else -q) & M64
            elif op == 0x80:  # i64.div_u
                b = stack.pop()
                if b == 0:
                    raise WasmTrap("i64.div_u by zero")
                stack[-1] //= b
            elif op == 0x81:  # i64.rem_s
                b = _s64(stack.pop())
                a = _s64(stack[-1])
                if b == 0:
                    raise WasmTrap("i64.rem_s by zero")
                stack[-1] = (abs(a) % abs(b) * (1 if a >= 0 else -1)) & M64
            elif op == 0x82:  # i64.rem_u
                b = stack.pop()
                if b == 0:
                    raise WasmTrap("i64.rem_u by zero")
                stack[-1] %= b
            elif op == 0x84:  # i64.or
                b = stack.pop()
                stack[-1] |= b
            elif op == 0x85:  # i64.xor
                b = stack.pop()
                stack[-1] ^= b
            elif op == 0x87:  # i64.shr_s
                b = stack.pop() & 63
                stack[-1] = (_s64(stack[-1]) >> b) & M64
            elif op == 0x89:  # i64.rotl
                b = stack.pop() & 63
                a = stack[-1]
                stack[-1] = ((a << b) | (a >> (64 - b))) & M64 if b else a
            elif op == 0x8A:  # i64.rotr
                b = stack.pop() & 63
                a = stack[-1]
                stack[-1] = ((a >> b) | (a << (64 - b))) & M64 if b else a
            elif op == 0x79:  # i64.clz
                a = stack[-1]
                stack[-1] = 64 - a.bit_length() if a else 64
            elif op == 0x7A:  # i64.ctz
                a = stack[-1]
                stack[-1] = (a & -a).bit_length() - 1 if a else 64
            elif op == 0x7B:  # i64.popcnt
                stack[-1] = bin(stack[-1]).count("1")
            # --- conversions -------------------------------------------
            elif op == 0xAC:  # i64.extend_i32_s
                stack[-1] = _s32(stack[-1]) & M64
            elif op == 0xC0:  # i32.extend8_s
                v = stack[-1] & 0xFF
                stack[-1] = (v - 256 if v & 0x80 else v) & M32
            elif op == 0xC1:  # i32.extend16_s
                v = stack[-1] & 0xFFFF
                stack[-1] = (v - 65536 if v & 0x8000 else v) & M32
            elif op == 0xC2:  # i64.extend8_s
                v = stack[-1] & 0xFF
                stack[-1] = (v - 256 if v & 0x80 else v) & M64
            elif op == 0xC3:  # i64.extend16_s
                v = stack[-1] & 0xFFFF
                stack[-1] = (v - 65536 if v & 0x8000 else v) & M64
            elif op == 0xC4:  # i64.extend32_s
                v = stack[-1] & M32
                stack[-1] = (v - (1 << 32) if v & 0x80000000 else v) & M64
            else:
                raise WasmTrap(f"unimplemented opcode {op!r}")
        return None


def _s32(v: int) -> int:
    return v - (1 << 32) if v & 0x80000000 else v


def _s64(v: int) -> int:
    return v - (1 << 64) if v & (1 << 63) else v
