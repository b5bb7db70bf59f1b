"""The port's circom wasm witness generator, held against the JAX package's.

zksaas_tpu_torch/circom/wasm.py and witness_calc.py are host-only copies
of zksaas_tpu/circom/{wasm,witness_calc}.py.  The reference's sha256.wasm,
the JAX package's only end-to-end fixture, is not in the repository
(tests/test_wasm_witness.py skips without it), so the modules here are
written by hand, as bytes, by a small assembler:

* an arithmetic module: every i32 and i64 binary operation (signed and
  unsigned div and rem, shifts, rotates, compares, wrap-around), unary ones
  (clz, ctz, popcnt, eqz, extend, wrap), a loop with br_if, memory loads
  and stores of every width, memory.grow and memory.size, a direct call,
  an imported host function, and traps (unreachable, division by zero);
* a circom-style witness generator over the BN254 scalar field (n32 = 8):
  the runtime imports, shared rw memory, fnv-hashed input signals, and the
  witness [1, a * b, a, b] (inputs below 2^16, so a * b is one word).

Both interpreters run both modules on the same inputs: results, traps and
their messages, the witness, the `.wtns` bytes (read back by the JAX
package's load_wtns, and written by the port's command line,
circom/generate_witness.py) and fnv1a_64 must be equal.  Tolerance: exact.
"""

import itertools
import struct

import pytest

from zksaas_tpu.circom import r1cs as jr1cs
from zksaas_tpu.circom import wasm as jwasm
from zksaas_tpu.circom import witness_calc as jwc
from zksaas_tpu.fields import BN254_FR
from zksaas_tpu_torch.circom import generate_witness, wasm, witness_calc

from test_torch_heap import release_heap  # noqa: F401  (autouse)

I32, I64 = 0x7F, 0x7E
P = BN254_FR.p


# --- a small wasm assembler -------------------------------------------------

def uleb(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def sleb(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        done = (v == 0 and not b & 0x40) or (v == -1 and b & 0x40)
        out.append(b | (0 if done else 0x80))
        if done:
            return bytes(out)


def vec(items):
    return uleb(len(items)) + b"".join(items)


def name(s):
    return uleb(len(s)) + s.encode()


def section(sid, payload):
    return bytes([sid]) + uleb(len(payload)) + payload


def module(types, imports, funcs, exports, pages=1):
    """types: [(params, results)]; imports: [(module, name, type index)];
    funcs: [(type index, [local valtypes], body bytes)]; exports: {name:
    function index} (imports first)."""
    t = vec([b"\x60" + vec([bytes([p]) for p in ps]) + vec([bytes([r]) for r in rs])
             for ps, rs in types])
    im = vec([name(m) + name(n) + b"\x00" + uleb(ti) for m, n, ti in imports])
    fn = vec([uleb(ti) for ti, _, _ in funcs])
    mem = vec([b"\x00" + uleb(pages)])
    ex = vec([name(k) + b"\x00" + uleb(i) for k, i in exports.items()])
    code = vec([uleb(len(body)) + body for body in (
        vec([uleb(1) + bytes([v]) for v in locs]) + ins + b"\x0b" for _, locs, ins in funcs)])
    return (b"\x00asm" + struct.pack("<I", 1) + section(1, t) + section(2, im) + section(3, fn)
            + section(5, mem) + section(7, ex) + section(10, code))


def get(i):
    return b"\x20" + uleb(i)


def setl(i):
    return b"\x21" + uleb(i)


def i32(v):
    return b"\x41" + sleb(v)


def i64(v):
    return b"\x42" + sleb(v)


def call(i):
    return b"\x10" + uleb(i)


def mem(op, offset=0):
    return bytes([op]) + uleb(2) + uleb(offset)


IF, ELSE, END = b"\x04\x40", b"\x05", b"\x0b"


# --- the arithmetic module ----------------------------------------------------

I32_BIN = {"add": 0x6A, "sub": 0x6B, "mul": 0x6C, "div_s": 0x6D, "div_u": 0x6E, "rem_s": 0x6F,
           "rem_u": 0x70, "and": 0x71, "or": 0x72, "xor": 0x73, "shl": 0x74, "shr_s": 0x75,
           "shr_u": 0x76, "rotl": 0x77, "rotr": 0x78, "eq": 0x46, "ne": 0x47, "lt_s": 0x48,
           "lt_u": 0x49, "gt_s": 0x4A, "gt_u": 0x4B, "le_s": 0x4C, "le_u": 0x4D, "ge_s": 0x4E,
           "ge_u": 0x4F}
I64_BIN = {"add": 0x7C, "sub": 0x7D, "mul": 0x7E, "div_s": 0x7F, "div_u": 0x80, "rem_s": 0x81,
           "rem_u": 0x82, "and": 0x83, "or": 0x84, "xor": 0x85, "shl": 0x86, "shr_s": 0x87,
           "shr_u": 0x88, "rotl": 0x89, "rotr": 0x8A, "eq": 0x51, "ne": 0x52, "lt_s": 0x53,
           "lt_u": 0x54, "gt_s": 0x55, "gt_u": 0x56, "le_s": 0x57, "le_u": 0x58, "ge_s": 0x59,
           "ge_u": 0x5A}
# unary: (name, param type, opcode)
UNARY = [("i32_clz", I32, 0x67), ("i32_ctz", I32, 0x68), ("i32_popcnt", I32, 0x69),
         ("i32_eqz", I32, 0x45), ("i32_extend8_s", I32, 0xC0), ("i32_extend16_s", I32, 0xC1),
         ("i64_clz", I64, 0x79), ("i64_ctz", I64, 0x7A), ("i64_popcnt", I64, 0x7B),
         ("i64_eqz", I64, 0x50), ("i64_extend_i32_s", I32, 0xAC), ("i64_extend_i32_u", I32, 0xAD),
         ("i32_wrap_i64", I64, 0xA7), ("i64_extend32_s", I64, 0xC4)]
UNARY_RESULT = {0x67: I32, 0x68: I32, 0x69: I32, 0x45: I32, 0xC0: I32, 0xC1: I32, 0x79: I64,
                0x7A: I64, 0x7B: I64, 0x50: I32, 0xAC: I64, 0xAD: I64, 0xA7: I32, 0xC4: I64}


def arith_module():
    types = [((I32, I32), (I32,)), ((I64, I64), (I64,)), ((I64, I64), (I32,)), ((I32,), ()),
             ((I32,), (I32,)), ((), (I32,)), ((), ())]
    tix = {t: i for i, t in enumerate(types)}
    imports = [("env", "log", tix[((I32,), ())])]
    funcs, exports = [], {}

    def add(nm, ty, locs, body):
        if ty not in tix:
            types.append(ty)
            tix[ty] = len(types) - 1
        exports[nm] = len(imports) + len(funcs)
        funcs.append((tix[ty], locs, body))

    for nm, op in I32_BIN.items():
        add(f"i32_{nm}", ((I32, I32), (I32,)), [], get(0) + get(1) + bytes([op]))
    for nm, op in I64_BIN.items():
        res = I32 if 0x51 <= op <= 0x5A else I64
        add(f"i64_{nm}", ((I64, I64), (res,)), [], get(0) + get(1) + bytes([op]))
    for nm, pt, op in UNARY:
        add(nm, ((pt,), (UNARY_RESULT[op],)), [], get(0) + bytes([op]))
    # sum 1..n: block { loop { if n == 0 break; acc += n; n -= 1; continue } }
    add("sum_loop", ((I32,), (I32,)), [I32],
        b"\x02\x40\x03\x40" + get(0) + b"\x45\x0d" + uleb(1)
        + get(1) + get(0) + b"\x6a" + setl(1) + get(0) + i32(1) + b"\x6b" + setl(0)
        + b"\x0c" + uleb(0) + END + END + get(1))
    # memory: i32 at a, i64 at a + 8, the bytes back with every load width
    add("mem_roundtrip", ((I32, I32), (I64,)), [],
        get(0) + get(1) + mem(0x36) + get(0) + get(1) + b"\xac" + mem(0x37, 8)
        + get(0) + get(1) + mem(0x3A, 16) + get(0) + get(1) + mem(0x3B, 20)
        + get(0) + mem(0x29, 8) + get(0) + mem(0x2C, 16) + b"\xac" + b"\x7c"
        + get(0) + mem(0x2D, 16) + b"\xad" + b"\x7c" + get(0) + mem(0x2E, 20) + b"\xac" + b"\x7c"
        + get(0) + mem(0x2F, 20) + b"\xad" + b"\x7c" + get(0) + mem(0x30, 0) + b"\x7c"
        + get(0) + mem(0x31, 1) + b"\x7c" + get(0) + mem(0x32, 2) + b"\x7c"
        + get(0) + mem(0x33, 2) + b"\x7c" + get(0) + mem(0x34, 4) + b"\x7c"
        + get(0) + mem(0x35, 4) + b"\x7c"
        + get(0) + get(1) + b"\xac" + mem(0x3C, 24) + get(0) + get(1) + b"\xac" + mem(0x3D, 26)
        + get(0) + get(1) + b"\xac" + mem(0x3E, 28) + get(0) + mem(0x29, 24) + b"\x7c")
    # grow by n pages: the old size; then a store and load past the old end
    add("grow", ((I32,), (I32,)), [I32],
        get(0) + b"\x40\x00" + setl(1) + b"\x3f\x00" + i32(65536) + b"\x6c" + i32(4) + b"\x6b"
        + get(1) + mem(0x36) + b"\x3f\x00" + i32(65536) + b"\x6c" + i32(4) + b"\x6b" + mem(0x28)
        + get(1) + b"\x6a")
    # a direct call of i32_mul and the imported log, then select and drop
    add("call_log", ((I32,), (I32,)), [],
        get(0) + get(0) + call(exports["i32_mul"]) + call(0) + get(0) + i32(3)
        + call(exports["i32_mul"]) + i32(7) + get(0) + b"\x1b" + i32(5) + b"\x1a"
        + get(0) + IF[:1] + b"\x7f" + i32(1) + ELSE + i32(2) + END + b"\x6a")
    add("trap", ((), (I32,)), [], b"\x00")
    return module(types, imports, funcs, exports), exports


I32_VALS = [0, 1, 2, 3, 7, 31, 32, 33, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xFFFFFFFE, 12345678]
I64_VALS = [0, 1, 5, 63, 64, 65, 0x7FFFFFFFFFFFFFFF, 0x8000000000000000, (1 << 64) - 1,
            (1 << 64) - 7, 0x123456789ABCDEF0]


def _run(mod, nm, *args):
    try:
        return ("ok", mod.invoke(nm, *args))
    except (wasm.WasmTrap, jwasm.WasmTrap) as e:
        return ("trap", str(e))


# --- a circom-style witness generator ----------------------------------------

def circom_module():
    """Shared rw memory at 0 (8 32-bit words), the inputs a, b (word 0 of
    each) at 64 and 68, the count of inputs set at 72; witness
    [1, a * b, a, b]."""
    ha, hb = witness_calc.fnv1a_64("a"), witness_calc.fnv1a_64("b")
    types = [((I32,), ()), ((), ()), ((), (I32,)), ((I32,), (I32,)), ((I32, I32), ()),
             ((I32, I32), (I32,)), ((I32, I32, I32), ())]
    imports = [("runtime", "exceptionHandler", 0), ("runtime", "printErrorMessage", 1),
               ("runtime", "writeBufferMessage", 1), ("runtime", "showSharedRWMemory", 1)]

    def signed(v):
        return v - (1 << 32) if v & 0x80000000 else v

    def is_h(h):  # (msb, lsb) in locals 0, 1 == h
        return (get(0) + i32(signed(h >> 32)) + b"\x46" + get(1) + i32(signed(h & 0xFFFFFFFF))
                + b"\x46" + b"\x71")

    words = [(P >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
    zero_hi = b"".join(i32(4 * j) + i32(0) + mem(0x36) for j in range(1, 8))
    funcs = [
        (2, [], i32(2)),  # getVersion
        (2, [], i32(8)),  # getFieldNumLen32
        (1, [], b"".join(i32(4 * j) + i32(signed(w)) + mem(0x36)
                         for j, w in enumerate(words))),  # getRawPrime
        (3, [], get(0) + i32(4) + b"\x6c" + mem(0x28)),  # readSharedRWMemory
        (4, [], get(0) + i32(4) + b"\x6c" + get(1) + mem(0x36)),  # writeSharedRWMemory
        (0, [], i32(72) + i32(0) + mem(0x36)),  # init
        (5, [], is_h(ha) + is_h(hb) + b"\x72"),  # getInputSignalSize: 1 or 0
        (6, [], is_h(ha) + IF + i32(64) + i32(0) + mem(0x28) + mem(0x36) + ELSE
         + is_h(hb) + IF + i32(68) + i32(0) + mem(0x28) + mem(0x36) + ELSE + i32(1) + call(0)
         + END + END + i32(72) + i32(72) + mem(0x28) + i32(1) + b"\x6a" + mem(0x36)),
        (2, [], i32(2)),  # getInputSize
        (2, [], i32(4)),  # getWitnessSize
        (0, [], get(0) + i32(3) + b"\x4b" + IF + i32(4) + call(0) + END  # i > 3: Assert Failed
         + zero_hi + i32(0)
         + get(0) + b"\x45" + IF[:1] + b"\x7f" + i32(1) + ELSE
         + get(0) + i32(1) + b"\x46" + IF[:1] + b"\x7f" + i32(64) + mem(0x28) + i32(68) + mem(0x28) + b"\x6c" + ELSE
         + i32(56) + get(0) + i32(4) + b"\x6c" + b"\x6a" + mem(0x28) + END + END
         + mem(0x36)),  # getWitness
        (2, [], i32(0)),  # getMessageChar
    ]
    names = ["getVersion", "getFieldNumLen32", "getRawPrime", "readSharedRWMemory",
             "writeSharedRWMemory", "init", "getInputSignalSize", "setInputSignal",
             "getInputSize", "getWitnessSize", "getWitness", "getMessageChar"]
    exports = {nm: len(imports) + i for i, nm in enumerate(names)}
    return module(types, imports, funcs, exports)


def test_wasm_interpreters_agree(tmp_path):
    """Results and traps of both interpreters on the arithmetic module, then
    the witness calculator's protocol on the circom-style module."""
    data, exports = arith_module()
    logs = {"jax": [], "port": []}
    mods = {"jax": jwasm.WasmModule(data, {"env.log": logs["jax"].append}),
            "port": wasm.WasmModule(data, {"env.log": logs["port"].append})}
    for width, ops, vals in (("i32", I32_BIN, I32_VALS), ("i64", I64_BIN, I64_VALS)):
        for op in ops:
            for a, b in itertools.product(vals, vals):
                got = [_run(mods[k], f"{width}_{op}", a, b) for k in ("jax", "port")]
                assert got[0] == got[1], (width, op, a, b, got)
    for nm, pt, _ in UNARY:
        for a in (I32_VALS if pt == I32 else I64_VALS):
            got = [_run(mods[k], nm, a) for k in ("jax", "port")]
            assert got[0] == got[1], (nm, a, got)
    # wrap-around and signed division, spelled out
    port = mods["port"]
    assert port.invoke("i32_add", 0xFFFFFFFF, 2) == 1
    assert port.invoke("i32_div_s", 0xFFFFFFF9, 2) == 0xFFFFFFFD  # -7 / 2 = -3
    assert port.invoke("i32_rem_s", 0xFFFFFFF9, 2) == 0xFFFFFFFF  # -7 % 2 = -1
    assert port.invoke("i64_rotl", 0x8000000000000001, 1) == 3
    assert _run(port, "i32_div_u", 1, 0) == ("trap", "i32.div_u by zero")
    for args in ((10,), (0,), (1000,)):
        got = [_run(mods[k], "sum_loop", *args) for k in ("jax", "port")]
        assert got[0] == got[1] == ("ok", args[0] * (args[0] + 1) // 2)
    for a, v in ((0, 0x89ABCDEF), (100, 0x7FFF8081), (4096, 0xFFFFFFFF)):
        got = [_run(mods[k], "mem_roundtrip", a, v) for k in ("jax", "port")]
        assert got[0] == got[1] and got[0][0] == "ok", (a, v, got)
    for n in (1, 2):
        got = [_run(mods[k], "grow", n) for k in ("jax", "port")]
        assert got[0] == got[1] and got[0][0] == "ok", (n, got)
        assert len(mods["port"].mem) == len(mods["jax"].mem)
    assert mods["port"].mem == mods["jax"].mem
    for x in (0, 5, 0xFFFFFFFF):
        got = [_run(mods[k], "call_log", x) for k in ("jax", "port")]
        assert got[0] == got[1], (x, got)
    assert logs["jax"] == logs["port"] == [0, 25, 1]
    assert _run(mods["jax"], "trap") == _run(port, "trap") == ("trap", "unreachable executed")

    # the witness calculator on the circom-style module
    cdata = circom_module()
    jw, pw = jwc.WitnessCalculator(cdata), witness_calc.WitnessCalculator(cdata)
    assert (pw.version, pw.n32, pw.prime, pw.witness_size) == (jw.version, jw.n32, jw.prime,
                                                              jw.witness_size) == (2, 8, P, 4)
    for a, b in ((7, 9), (65535, 65535), (1 << 15, 3)):
        want = [1, a * b, a, b]
        assert jw.calculate_witness({"a": a, "b": b}) == want
        assert pw.calculate_witness({"a": a, "b": b}) == want
        blob = pw.calculate_wtns_bin({"a": a, "b": b})
        assert blob == jw.calculate_wtns_bin({"a": a, "b": b})
        path = tmp_path / f"w{a}.wtns"
        path.write_bytes(blob)
        assert jr1cs.load_wtns(str(path)) == want
    for calc, trap in ((jw, jwasm.WasmTrap), (pw, wasm.WasmTrap)):
        with pytest.raises(trap, match="Signal nope not found"):
            calc.calculate_witness({"a": 1, "nope": 2})
        with pytest.raises(trap, match="Not all inputs"):
            calc.calculate_witness({"a": 1})
        with pytest.raises(trap, match="Assert Failed"):
            calc.mod.invoke("getWitness", 9)
    for s in ("", "a", "b", "main.in[0]", "sha256_2.a", "x" * 100):
        assert witness_calc.fnv1a_64(s) == jwc.fnv1a_64(s)
    # the command line: artifact + JSON inputs -> the same .wtns bytes
    (tmp_path / "c.wasm").write_bytes(cdata)
    (tmp_path / "in.json").write_text('{"a": 7, "b": 9}')
    out = tmp_path / "out.wtns"
    assert generate_witness.main(["gw", str(tmp_path / "c.wasm"), str(tmp_path / "in.json"),
                                  str(out)]) == 0
    assert out.read_bytes() == jw.calculate_wtns_bin({"a": 7, "b": 9})
