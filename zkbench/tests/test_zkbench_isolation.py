"""What the benchmark loads: no JAX and nothing of the JAX package in a run,
nothing of the program in the reference; no result without a card or
without the program."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT
from zkbench.isolation import forbidden_modules, top_level


def _python(code, cwd=ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_top_level_names_are_compared_whole():
    mods = {"zksaas_tpu_torch": 1, "zksaas_tpu_torch.groth16.prove": 1, "jaxtyping": 1,
            "torch": 1}
    assert forbidden_modules(mods) == set()
    assert forbidden_modules(dict(mods, **{"zksaas_tpu.fields.spec": 1})) == {"zksaas_tpu"}
    assert forbidden_modules(dict(mods, **{"jax._src": 1, "flax": 1})) == {"jax", "flax"}
    assert top_level(["zksaas_tpu_torch.kernels"]) == {"zksaas_tpu_torch"}


def test_a_run_loads_no_jax_and_the_reference_none_of_the_program():
    code = """
import json, pkgutil, importlib, sys
import zkbench.reference as ref
for m in pkgutil.walk_packages(ref.__path__, "zkbench.reference."):
    importlib.import_module(m.name)
import zkbench.circuits.sha256_batch, zkbench.crs, zkbench.r1cs
from zkbench.isolation import top_level
reference = sorted(top_level(sys.modules) & {"zksaas_tpu_torch", "zksaas_tpu", "torch", "jax"})
import zkbench.harness, zkbench.faults, zkbench.control, zkbench.trace
from zkbench import loader
for m in loader.benchmark()["end_to_end"] + loader.benchmark()["per_layer"]:
    loader.metric_reader(m["name"])
# what set_up, one_proof and the check import inside their functions
import zksaas_tpu_torch.circom.r1cs, zksaas_tpu_torch.comm.net, zksaas_tpu_torch.curves.curve
import zksaas_tpu_torch.groth16.prove, zksaas_tpu_torch.groth16.qap
import zksaas_tpu_torch.groth16.setup_device, zksaas_tpu_torch.groth16.local
import zksaas_tpu_torch.pss.pss, zksaas_tpu_torch.kernels, torch.profiler
from zkbench.isolation import forbidden_modules
print(json.dumps({"reference": reference, "run": sorted(forbidden_modules(sys.modules))}))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == {"reference": [], "run": []}


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    args = ["zkbench/run.py", "--workload", "sha256-bn254.serial", "--seed", str(2**35),
            "--seconds", "1", "--trace", "0"]
    code = f"import runpy, sys; sys.argv = {args!r}; runpy.run_path('zkbench/run.py', run_name='__main__')"
    out = _python(code)
    assert out.returncode != 0 and "CUDA" in out.stderr and '"correct"' not in out.stdout
    # a directory that holds only BENCHMARK.json and the benchmark's folder
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "zkbench"), tmp_path / "zkbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", PYTHONPATH="")
    out = subprocess.run([sys.executable] + args, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout
