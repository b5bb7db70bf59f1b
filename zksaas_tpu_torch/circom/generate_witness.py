"""Generate a circom `.wtns` witness from a compiled `.wasm` witness
generator and a JSON input file: the reference's generate_witness.js CLI
(fixtures/sha256/sha256_js/generate_witness.js), with the wasm run by the
pure-Python interpreter (circom/wasm.py) instead of node.  The port's
counterpart of scripts/generate_witness.py; host-only.

Usage: python -m zksaas_tpu_torch.circom.generate_witness <file.wasm> <input.json> <output.wtns>
"""

from __future__ import annotations

import json
import sys

from .witness_calc import WitnessCalculator


def main(argv: list[str]) -> int:
    if len(argv) != 4:
        print(__doc__.strip().splitlines()[-1])
        return 1
    wasm_path, input_path, out_path = argv[1:4]
    with open(input_path) as f:
        inputs = json.load(f)
    wc = WitnessCalculator.from_file(wasm_path)
    blob = wc.calculate_wtns_bin(inputs)
    with open(out_path, "wb") as f:
        f.write(blob)
    print(f"wrote {out_path}: {wc.witness_size} witness values, {len(blob)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
