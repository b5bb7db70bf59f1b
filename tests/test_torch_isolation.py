"""The port stands alone and runs on the card by default.

A fresh interpreter imports every module of zksaas_tpu_torch and must end
up with neither jax nor zksaas_tpu loaded.  The entry points (the flagship
over BN254 and BLS12-381, msm_best over BN254 and BLS12-381, ...)
must refuse to run without a CUDA device unless the caller asks for
device="cpu", and
chip_smoke.py must fail, printing no result, both without a card and in a
directory that holds nothing else of the repo.
"""

import os
import shutil
import subprocess
import sys

import pytest

from test_torch_heap import release_heap  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, cwd=ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    code = """
import importlib, pkgutil, sys
import zksaas_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
assert len(names) > 30, names
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "zksaas_tpu.")) or m == "zksaas_tpu")
assert not bad, bad
print("ok", len(names))
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


_SETUP = """
from zksaas_tpu_torch import sha256_e2e
from zksaas_tpu_torch.circom.r1cs import ConstraintBuilder
from zksaas_tpu_torch.curves.curve import curve_g1
from zksaas_tpu_torch.curves.pippenger import msm_best
from zksaas_tpu_torch.fields.sortperm import sort_u32
from zksaas_tpu_torch.fields.field import field
from zksaas_tpu_torch.fields.spec import BLS12_381_FR, BN254_FR
from zksaas_tpu_torch.groth16.prove import pack_witness
from zksaas_tpu_torch.groth16.qap import qap_pack
from zksaas_tpu_torch.pss.pss import pss
from zksaas_tpu_torch.utils.rng import generator
cb = ConstraintBuilder()
x = cb.witness(3)
cb.constrain([(1, x)], [(1, 0)], [(1, x)])
r1cs, z = cb.finalize()
pp = pss(BN254_FR, 2)
"""

ENTRY_POINTS = {
    "sha256_e2e": "sha256_e2e.main({})",
    "sha256_e2e_bls12_381": "sha256_e2e.main(curve='bls12_381'{})",
    "field_encode": "field(BN254_FR).encode([1, 2]{})",
    "qap_pack": "qap_pack(pp, r1cs, z, generator(1){})",
    "pack_witness": "pack_witness(pp, [1, 2, 3], generator(1){})",
    "msm_best": "msm_best(curve_g1(), curve_g1().infinity((1,){0}), field(BN254_FR).zeros((1,){0}))",
    "sort_u32": "sort_u32(field(BN254_FR).zeros((256,){0})[:, 0])",
    "msm_best_bls12_381_g1": "msm_best(curve_g1('bls12_381'), "
    "curve_g1('bls12_381').infinity((1,){0}), field(BLS12_381_FR).zeros((1,){0}))",
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_gpu_unless_cpu_is_asked(name):
    call = ENTRY_POINTS[name]
    code = _SETUP + f"""
try:
    {call.format("")}
except RuntimeError as e:
    assert "no CUDA device is available" in str(e), e
else:
    raise SystemExit("ran without a GPU")
"""
    if not name.startswith("sha256_e2e"):  # the full flagship is too big for a CPU test
        code += call.format(", device='cpu'") + "\n"
    res = _run(code + "print('ok')\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    # alone in a directory: nothing of the port to import
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout
