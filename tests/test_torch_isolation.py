"""The port stands alone and runs on the card by default.

A fresh interpreter imports every module of zksaas_tpu_torch (d_pp, Gao,
serial, the TCP star, HostStarNet, the journal, host_prove, spmd_prove and
the wasm witness generator among them)
and must end up with neither jax, zksaas_tpu nor cryptography loaded (the
star imports cryptography only to make a certificate), and no module of
the port may import pickle.  The entry points (the flagship over BN254 and
BLS12-381, the king of the multi-process prove, msm_best over BN254 and
BLS12-381, the dealer's libsnark masks and d_pp blinds, ...) must refuse to
run without a CUDA device unless the caller asks for device="cpu", and
chip_smoke.py must fail, printing no result, both without a card and in a
directory that holds nothing else of the repo.  The subprocesses run torch
with one thread: on an 8-core CPU busy with 8 other processes, a one-point
msm_best took 15.5 s with eight threads and 0.9 s with one.  The calls with
device="cpu" run in the test's own process while the subprocess starts, so
a case takes the longer of the two, not their sum.
"""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from test_torch_heap import release_heap  # noqa: F401  (autouse)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(code, cwd=ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.Popen([sys.executable, "-c", code], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _run(code, cwd=ROOT):
    proc = _start(code, cwd)
    out, err = proc.communicate(timeout=300)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def test_port_imports_no_jax():
    code = """
import importlib, pkgutil, sys
import zksaas_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
assert len(names) > 30, names
new = {"zksaas_tpu_torch.dist.dpp", "zksaas_tpu_torch.pss.gao", "zksaas_tpu_torch.utils.serial",
       "zksaas_tpu_torch.comm.star", "zksaas_tpu_torch.comm.host_net",
       "zksaas_tpu_torch.comm.journal", "zksaas_tpu_torch.host_prove",
       "zksaas_tpu_torch.spmd_prove", "zksaas_tpu_torch.circom.wasm",
       "zksaas_tpu_torch.circom.witness_calc", "zksaas_tpu_torch.circom.generate_witness"}
assert new <= set(names), sorted(new - set(names))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "zksaas_tpu", "cryptography"))
assert not bad, bad
print("ok", len(names))
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    # no module of the port imports a pickle format (torch imports pickle
    # itself, so this reads the sources)
    pickles = {"pickle", "_pickle", "cPickle", "cloudpickle", "dill", "shelve"}
    found = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "zksaas_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    tree = ast.parse(fh.read(), path)
                for node in ast.walk(tree):
                    mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                            else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                    found += [(path, m) for m in mods if m.split(".")[0] in pickles]
    assert not found, found


_SETUP = """
from zksaas_tpu_torch import host_prove, sha256_e2e, spmd_prove
from zksaas_tpu_torch.circom.r1cs import ConstraintBuilder
from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
from zksaas_tpu_torch.curves.pippenger import msm_best
from zksaas_tpu_torch.dist import PpBlind
from zksaas_tpu_torch.groth16 import libsnark_masks
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
    "host_prove": "host_prove.prove_king(pp, curve_g1(), curve_g2(), *[None] * 7, generator(1){})",
    "spmd_prove": "spmd_prove.prove_spmd(pp, curve_g1(), curve_g2(), *[None] * 7, 1, 'gloo'{})",
    "sha256_e2e_bls12_381": "sha256_e2e.main(curve='bls12_381'{})",
    "field_encode": "field(BN254_FR).encode([1, 2]{})",
    "qap_pack": "qap_pack(pp, r1cs, z, generator(1){})",
    "pack_witness": "pack_witness(pp, [1, 2, 3], generator(1){})",
    "msm_best": "msm_best(curve_g1(), curve_g1().infinity((1,){0}), field(BN254_FR).zeros((1,){0}))",
    "sort_u32": "sort_u32(field(BN254_FR).zeros((256,){0})[:, 0])",
    "msm_best_bls12_381_g1": "msm_best(curve_g1('bls12_381'), "
    "curve_g1('bls12_381').infinity((1,){0}), field(BLS12_381_FR).zeros((1,){0}))",
}


# more of the dealer's entry points, checked beside qap_pack
DEALER = ("PpBlind.sample(pp, 4, generator(1){})", "libsnark_masks(pp, 8, generator(1){})")
# whole proves, too big for this test on the CPU: the flagship, the king of
# the multi-process prove and the SPMD prove, which tests/test_torch_host_net.py
# and tests/test_torch_spmd.py run there
FULL_PROVES = ("sha256_e2e", "sha256_e2e_bls12_381", "host_prove", "spmd_prove")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_need_a_gpu_unless_cpu_is_asked(name):
    """Each call refuses in a fresh interpreter that sees no CUDA device;
    meanwhile, the same calls with device="cpu" run here."""
    calls = (ENTRY_POINTS[name],) + (DEALER if name == "qap_pack" else ())
    code = _SETUP
    for call in calls:
        code += f"""
try:
    {call.format("")}
except RuntimeError as e:
    assert "no CUDA device is available" in str(e), e
else:
    raise SystemExit("ran without a GPU")
"""
    proc = _start(code + "print('ok')\n")
    try:
        if name not in FULL_PROVES:
            scope = {}
            exec(_SETUP, scope)
            for call in calls:
                exec(call.format(", device='cpu'"), scope)
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, err
    assert out.strip() == "ok"


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
