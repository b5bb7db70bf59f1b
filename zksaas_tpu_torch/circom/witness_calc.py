"""Circom witness calculator: runs the circom-compiled `.wasm` witness
generator (through the pure-Python interpreter in `wasm.py`) to produce
the full witness vector from named inputs.

Port of zksaas_tpu/circom/witness_calc.py.  It follows the host protocol
of the reference's JS calculator
(fixtures/sha256/sha256_js/witness_calculator.js: fnv-hashed signal names,
32-bit-limb shared-rw-memory transfers, wtns v2 framing), so the same
artifacts drive both: circom artifacts + JSON inputs -> witness -> d_prove.
"""

from __future__ import annotations

import json
import struct

from .wasm import WasmModule, WasmTrap

_ERR_CODES = {
    1: "Signal not found.",
    2: "Too many signals set.",
    3: "Signal already set.",
    4: "Assert Failed.",
    5: "Not enough memory.",
    6: "Input signal array access exceeds the size.",
}


def fnv1a_64(s: str) -> int:
    h = 0xCBF29CE484222325
    for ch in s:
        h ^= ord(ch)
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class WitnessCalculator:
    def __init__(self, wasm_bytes: bytes):
        self._err_lines: list[str] = []
        self._log_parts: list[str] = []
        imports = {
            "runtime.exceptionHandler": self._on_exception,
            "runtime.printErrorMessage": self._on_error_message,
            "runtime.writeBufferMessage": self._on_buffer_message,
            "runtime.showSharedRWMemory": self._on_show_memory,
        }
        self.mod = WasmModule(wasm_bytes, imports)
        self.version = self.mod.invoke("getVersion")
        self.n32 = self.mod.invoke("getFieldNumLen32")
        self.mod.invoke("getRawPrime")
        self.prime = self._read_shared()
        self.witness_size = self.mod.invoke("getWitnessSize")

    @classmethod
    def from_file(cls, path: str) -> "WitnessCalculator":
        with open(path, "rb") as f:
            return cls(f.read())

    # -- host runtime callbacks (witness_calculator.js:36-78) -----------

    def _on_exception(self, code: int) -> None:
        msg = _ERR_CODES.get(code, "Unknown error.")
        raise WasmTrap(msg + ("\n" + "\n".join(self._err_lines) if self._err_lines else ""))

    def _message(self) -> str:
        out = []
        c = self.mod.invoke("getMessageChar")
        while c:
            out.append(chr(c))
            c = self.mod.invoke("getMessageChar")
        return "".join(out)

    def _on_error_message(self) -> None:
        self._err_lines.append(self._message())

    def _on_buffer_message(self) -> None:
        self._log_parts.append(self._message())

    def _on_show_memory(self) -> None:
        self._log_parts.append(str(self._read_shared()))

    # -- shared rw memory limb transfers ---------------------------------

    def _read_shared(self) -> int:
        v = 0
        for j in range(self.n32 - 1, -1, -1):
            v = (v << 32) | self.mod.invoke("readSharedRWMemory", j)
        return v

    def _write_shared(self, v: int) -> None:
        for j in range(self.n32):
            self.mod.invoke("writeSharedRWMemory", j, v & 0xFFFFFFFF)
            v >>= 32

    # -- protocol ---------------------------------------------------------

    def _set_inputs(self, inputs: dict, sanity_check: bool) -> None:
        self.mod.invoke("init", 1 if sanity_check else 0)
        count = 0
        for name, vals in inputs.items():
            h = fnv1a_64(name)
            h_msb, h_lsb = h >> 32, h & 0xFFFFFFFF
            flat = _flatten(vals)
            size = self.mod.invoke("getInputSignalSize", h_msb, h_lsb)
            # unknown names miss the hash table: 0 from circom 2.1.x,
            # -1 (as u32) from the JS calculator's contract — treat both
            if size == 0 or size & 0x80000000:
                raise WasmTrap(f"Signal {name} not found")
            if len(flat) != size:
                raise WasmTrap(
                    f"Signal {name}: expected {size} values, got {len(flat)}"
                )
            for i, v in enumerate(flat):
                self._write_shared(int(v) % self.prime)
                self.mod.invoke("setInputSignal", h_msb, h_lsb, i)
                count += 1
        total = self.mod.invoke("getInputSize")
        if count < total:
            raise WasmTrap(f"Not all inputs set: {count} of {total}")

    def calculate_witness(self, inputs: dict, sanity_check: bool = False) -> list[int]:
        """Full witness vector (w[0] == 1) as python ints."""
        self._set_inputs(inputs, sanity_check)
        w = []
        for i in range(self.witness_size):
            self.mod.invoke("getWitness", i)
            w.append(self._read_shared())
        return w

    def calculate_wtns_bin(self, inputs: dict, sanity_check: bool = False) -> bytes:
        """Witness in iden3 `.wtns` v2 binary framing (the snarkjs
        format; layout mirrors witness_calculator.js calculateWTNSBin)."""
        self._set_inputs(inputs, sanity_check)
        n8 = self.n32 * 4
        out = bytearray()
        out += b"wtns"
        out += struct.pack("<I", 2)  # version
        out += struct.pack("<I", 2)  # n sections
        out += struct.pack("<I", 1)  # section 1: header
        out += struct.pack("<Q", 8 + n8)
        out += struct.pack("<I", n8)
        out += self.prime.to_bytes(n8, "little")
        out += struct.pack("<I", self.witness_size)
        out += struct.pack("<I", 2)  # section 2: witness values
        out += struct.pack("<Q", n8 * self.witness_size)
        for i in range(self.witness_size):
            self.mod.invoke("getWitness", i)
            out += self._read_shared().to_bytes(n8, "little")
        return bytes(out)


def _flatten(v) -> list:
    if isinstance(v, (list, tuple)):
        out = []
        for x in v:
            out.extend(_flatten(x))
        return out
    return [v]


def generate_witness(wasm_path: str, inputs: dict | str) -> list[int]:
    """One-call analog of the reference's generate_witness.js: wasm
    artifact + inputs (dict or path to JSON) -> witness vector."""
    if isinstance(inputs, str):
        with open(inputs) as f:
            inputs = json.load(f)
    return WitnessCalculator.from_file(wasm_path).calculate_witness(inputs)
