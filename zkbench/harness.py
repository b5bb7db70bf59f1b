"""One run of one cell: set up, prove back to back for the window, check
every proof against the reference, print the result line.

  python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The program under test is zksaas_tpu_torch: the dealer's packing
(qap_pack, pack_witness, pack_scalar_repeated, ProveMasks.sample), the
8-party d_prove over LocalNet and the client's unpack2_g.  The benchmark
makes every input itself: the circuit and its witness from the seed
(circuits/<kind>.py), the CRS scalars from the configuration's crs_seed
(crs.py), and each proof's r, s and the seeds of its shares and masks from
the seed.

Set-up runs from the start of the process to the window: imports, the
card, the circuit, the CRS scalars (cached in zkbench/.cache/<config>/ by
the first run), the CRS points and their shares on the card, the dealing
of the witness, and the traffic's warm-up proofs; then the constraint lists
are dropped and what set-up made is frozen out of the garbage collector's
passes (gc.freeze).  The window is a closed loop with one prover; each
proof is one step:

  1. deal: fresh r and s and their packed shares, fresh ProveMasks;
  2. d_prove over LocalNet(n), its phases timed by its own `times`;
  3. unpack2_g of A, B and C, the client's unpack;
  4. torch.cuda.synchronize().

The loop starts a proof while the window's seconds have not run out, so the
window ends with the last proof; every proof is checked.  In a cell with an
end-to-end metric read from the device's trace (`source` device_trace in
BENCHMARK.json), torch.profiler with CUDA activity alone records the whole
window, in both modes; its warm-up is the last warm-up proof's, in set-up.
With --trace 1 the window is the same, and a few more proofs run after it
under torch.profiler (a schedule with one warm-up step): first with CUDA
activity alone, whose trace gives the device's busy time and its
operations while the host runs as in the window; then one with the host's
operations too, whose trace only names the idle gaps.

After the window closes and the device's peak memory is read, every proof
is decoded and compared, coordinate for coordinate, with the one the
reference (zkbench/reference/) works out from the same inputs and the same
r and s; the masks' fingerprints, block by block, show that no proof
reused any part of another's masks.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import random
import sys
import time

from . import crs as crs_mod
from . import loader
from .isolation import forbidden_modules
from .reference.fields import SCALAR_FIELDS
from .reference.groth16 import Statement, groups

CACHE = os.path.join(loader.ZKBENCH, ".cache")
# the numbers compared, each with its limit: exact comparisons
LIMITS = {"proofs_wrong": 0, "masks_reused": 0}
# the blocks a party's share of one field mask is cut into for its
# fingerprints (a point mask is one block a party)
FIELD_MASK_BLOCKS = 8
MASK_PRINT_SEED = 0x6D61736B


def _cache_env() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds its
    own nvcc libraries in the git-ignored zksaas_tpu_torch/build/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)


@dataclasses.dataclass
class Setup:
    """The program's state for one run, built in set-up and handed to the
    window: the parameters, the CRS shares, the dealt witness and the net."""

    torch: object
    dev: object
    pp: object
    g1: object
    g2: object
    crs: object
    qap: object
    a_share: object
    ax_share: object
    net: object
    m: int
    prints: MaskPrints


def _sync(st: Setup) -> None:
    if st.dev.type == "cuda":
        st.torch.cuda.synchronize(st.dev)


def set_up(config: dict, circuit, crs, device: str, seeds: random.Random,
           phases: dict | None = None) -> Setup:
    """The program's set-up: the CRS points and their shares on the device
    (pack_proving_key_device), and the dealing of the witness; `phases`,
    when given, gets the seconds of each."""
    phases = {} if phases is None else phases
    import torch

    from zksaas_tpu_torch.circom.r1cs import R1CS
    from zksaas_tpu_torch.comm.net import LocalNet
    from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
    from zksaas_tpu_torch.fields.spec import FIELDS
    from zksaas_tpu_torch.groth16 import prove, qap, setup_device
    from zksaas_tpu_torch.groth16.local import Groth16Keys
    from zksaas_tpu_torch.pss.pss import pss

    if config["transport"] != "local" or config["reduction"] != "circom":
        raise NotImplementedError("the harness drives LocalNet with the circom reduction")
    family = config["curve"]
    spec = FIELDS[f"{family}_fr"]
    if spec.p != circuit.p:
        raise ValueError("the circuit is over another field than the curve's")
    pp = pss(spec, config["l"])
    if (pp.n, pp.t) != (config["n"], config["t"]):
        raise ValueError(f"the port packs n = 4l, t = l: n = {pp.n}, t = {pp.t}")
    g1, g2 = curve_g1(family), curve_g2(family)
    dev = torch.device(device)
    r1cs = R1CS(spec, circuit.num_instance, circuit.num_witness, circuit.a, circuit.b, circuit.c)
    ss = setup_device.SetupScalars(
        spec=spec, reduction="circom", alpha=crs.alpha, beta=crs.beta, gamma=crs.gamma,
        delta=crs.delta, a_t=crs.a_t, b_t=crs.b_t, h_scalars=crs.h_scalars,
        l_scalars=crs.l_scalars, gamma_abc=crs.gamma_abc, m=crs.m)
    G1, G2 = groups(family)
    gen1, gen2 = (lambda x: G1.mul(G1.gen, x)), (lambda x: G2.mul(G2.gen, x))
    # the clear points the prover combines; the verifying key's gamma
    # terms stay with the reference
    keys = Groth16Keys(
        spec=spec, reduction="circom", alpha_g1=gen1(crs.alpha), beta_g2=gen2(crs.beta),
        gamma_g2=gen2(crs.gamma), delta_g2=gen2(crs.delta), gamma_abc_g1=[],
        beta_g1=gen1(crs.beta), delta_g1=gen1(crs.delta), a_query=[gen1(crs.a_t[0])],
        b_g1_query=[gen1(crs.b_t[0])], b_g2_query=[gen2(crs.b_t[0])], h_query=[], l_query=[])
    t0 = time.perf_counter()
    crs_shares = setup_device.pack_proving_key_device(ss, keys, pp, g1, g2, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    z = circuit.z
    gens = [torch.Generator().manual_seed(seeds.getrandbits(63)) for _ in range(3)]
    qap_share = qap.qap_pack(pp, r1cs, z, gens[0], dev)
    a_share = prove.pack_witness(pp, z[1:], gens[1], dev)
    ax_share = prove.pack_witness(pp, z[circuit.num_instance:], gens[2], dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phases.update(device_crs=t1 - t0, dealing=time.perf_counter() - t1)
    return Setup(torch, dev, pp, g1, g2, crs_shares, qap_share, a_share, ax_share,
                 LocalNet(pp.n), qap_share.dom.n, MaskPrints(dev))


def _leaves(obj):
    import torch

    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _leaves(v)]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _leaves(getattr(obj, f.name))]
    return []


def _mask_units(masks) -> list[tuple[list, int]]:
    """The masks one proof consumes, unit by unit: each FFT mask's and the
    degree-reduction mask's in and out shares, each MSM mask's in and out
    points; with the blocks a party's part of the unit is cut into."""
    units = []
    for fm in masks.fft_masks + [masks.degred_mask]:
        units += [([fm.in_mask], FIELD_MASK_BLOCKS), ([fm.out_mask], FIELD_MASK_BLOCKS)]
    for mm in masks.g1_msm_masks + [masks.g2_msm_mask]:
        units += [(_leaves(mm.in_mask), 1), (_leaves(mm.out_mask), 1)]
    return units


class MaskPrints:
    """Fingerprints of a proof's masks, block by block: every party's part
    of a unit is cut into blocks, and each block is summed against fixed
    random int64 weights (mod 2^64) on the device, so that a block repeats
    another proof's only where its contents do."""

    def __init__(self, dev):
        self.dev = dev
        self.weights = None

    def __call__(self, masks):
        import torch

        blocks = []
        for tensors, pieces in _mask_units(masks):
            x = torch.cat([t.reshape(t.shape[0], -1) for t in tensors], 1)
            pad = -x.shape[1] % pieces
            if pad:
                x = torch.nn.functional.pad(x, (0, pad))
            blocks.append(x.reshape(x.shape[0] * pieces, -1))
        width = max(b.shape[1] for b in blocks)
        if self.weights is None:  # drawn once: every proof's masks have the same shapes
            gen = torch.Generator(device=self.dev).manual_seed(MASK_PRINT_SEED)
            self.weights = torch.randint(-2**62, 2**62, (width,), generator=gen,
                                         dtype=torch.int64, device=self.dev)
        return torch.cat([(b.to(torch.int64) * self.weights[:b.shape[1]]).sum(1)
                          for b in blocks])


def one_proof(st: Setup, prng: random.Random, annotate) -> dict:
    """Steps 1-4 of one proof with fresh r, s and masks; the record keeps
    r, s, the unpacked shares and the masks' fingerprints for the check."""
    from zksaas_tpu_torch.groth16 import prove

    torch = st.torch
    q = st.pp.spec.p
    r, s = prng.randrange(1, q), prng.randrange(1, q)
    gens = [torch.Generator().manual_seed(prng.getrandbits(63)) for _ in range(4)]
    times: dict = {}
    with annotate("zkbench.proof"):
        _sync(st)
        c0 = time.process_time()
        t0 = time.perf_counter()
        with annotate("zkbench.deal"):
            r_share = prove.pack_scalar_repeated(st.pp, r, gens[0], st.dev)
            s_share = prove.pack_scalar_repeated(st.pp, s, gens[1], st.dev)
            masks = prove.ProveMasks.sample(st.pp, st.g1, st.g2, st.m, gens[2], st.dev)
            _sync(st)
        t1 = time.perf_counter()
        with annotate("zkbench.prove"):
            pi = prove.d_prove(st.pp, st.g1, st.g2, st.crs, st.qap, st.a_share, st.ax_share,
                               r_share, s_share, masks, st.net, gens[3], times=times)
            _sync(st)
        with annotate("zkbench.unpack"):
            ua = st.pp.unpack2_g(st.g1, pi[0])
            ub = st.pp.unpack2_g(st.g2, pi[1])
            uc = st.pp.unpack2_g(st.g1, pi[2])
            _sync(st)
        t3 = time.perf_counter()
        c3 = time.process_time()
        with annotate("zkbench.fingerprint"):
            fp = st.prints(masks)
    return {"latency_s": t3 - t0, "cpu_s": c3 - c0, "deal_s": t1 - t0, "phases": times,
            "r": r, "s": s, "unpacked": (ua, ub, uc), "fingerprint": fp}


def _counters(st: Setup) -> dict:
    from zksaas_tpu_torch import kernels

    return {"net_rounds": st.net.rounds, "gathered_elems": st.net.gathered_elems,
            "port_launches": sum(k.launches for k in kernels.KERNELS)}


def _no_annotation(_name):
    return contextlib.nullcontext()


def traced_proofs(st: Setup, prng: random.Random, count: int, labelled: int,
                  path: str) -> tuple[list, dict | None]:
    """`count` proofs under torch.profiler with CUDA activity alone, after
    one profiled warm-up step: their host seconds and the trace's device
    operations; then `labelled` proofs with the host's operations and the
    benchmark's annotations too, which slow the host, and whose trace only
    names the idle gaps.  Each trace goes to `path` and is reduced there."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from . import trace

    os.makedirs(os.path.dirname(path), exist_ok=True)
    proofs: list = []
    cuda = [ProfilerActivity.CUDA] if st.dev.type == "cuda" else []

    def profiled(activities, steps, annotate):
        with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=steps,
                                                              repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for i in range(steps + 1):  # step 0 warms the profiler up
                if i == 1:
                    t0 = time.perf_counter()
                proofs.append(one_proof(st, prng, annotate))
                if i == steps:
                    seconds = time.perf_counter() - t0
                prof.step()
        return seconds

    # every proof synchronises at its start and its end, so the device
    # operations of the active steps lie inside their host seconds
    window_s = profiled(cuda or [ProfilerActivity.CPU], count, _no_annotation)
    reduced = trace.device_time(path, window_s, count)
    os.remove(path)
    profiled([ProfilerActivity.CPU] + cuda, labelled, record_function)
    if reduced is not None:
        reduced["idle_gaps"] = trace.idle_gaps(path)
    os.remove(path)
    return proofs, reduced


def window_profiler(path: str):
    """A profiler with CUDA activity alone for the whole window, in a cell
    whose end-to-end metrics read the device's trace: started on the last
    warm-up proof, which warms it up in set-up; stepped once before the
    window, from which on it records; stopped after the window, when it
    writes the trace to `path`."""
    from torch.profiler import ProfilerActivity, profile, schedule

    os.makedirs(os.path.dirname(path), exist_ok=True)
    return profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1 << 30, repeat=1),
                   on_trace_ready=lambda p: p.export_chrome_trace(path))


def check(st: Setup, statement: Statement, proofs: list) -> dict:
    """Decode every proof and compare it with the reference's; count the
    proofs that share a block of any mask with another proof."""
    torch = st.torch
    wrong = 0
    for rec in proofs:
        ua, ub, uc = rec["unpacked"]
        got = (st.g1.decode(ua), st.g2.decode(ub), st.g1.decode(uc))
        want = statement.expected_proof(rec["r"], rec["s"])
        # every slot of the unpacked sharing holds the whole proof
        if any(slot != w for g, w in zip(got, want) for slot in g):
            wrong += 1
    return {"proofs_wrong": wrong,
            "masks_reused": reused_masks(torch.stack([rec["fingerprint"] for rec in proofs]))}


def reused_masks(prints) -> int:
    """The proofs (rows of `prints`, a proof's block fingerprints) of which
    some block equals the same block of another proof."""
    import torch

    prints = prints.cpu()
    ordered, order = prints.sort(0)
    same = ordered[1:] == ordered[:-1]
    hit = torch.zeros_like(prints, dtype=torch.bool)
    hit.scatter_(0, order[1:], same)
    hit |= torch.zeros_like(hit).scatter_(0, order[:-1], same)
    return int(hit.any(1).sum())


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             root: str = loader.ZKBENCH, cache: str = CACHE, t_start: float | None = None,
             bench: dict | None = None) -> dict:
    """One run of the cell; returns the result line's object (without the
    isolation check, which main makes in the printing process)."""
    t_start = time.time() if t_start is None else t_start
    import torch

    phases = {"start": time.time() - t_start}
    cell = loader.cell(cell_name, root)
    config = loader.config(cell["config"], root)
    traffic = loader.traffic(cell["traffic"], root)
    if traffic["loop"] != "closed" or traffic["provers"] != 1:
        raise NotImplementedError("the harness runs one prover in a closed loop")
    bench = loader.benchmark() if bench is None else bench
    family = config["curve"]
    spec = SCALAR_FIELDS[family]
    run_rng = random.Random(seed)
    input_rng, deal_rng, proof_rng = (random.Random(run_rng.getrandbits(64)) for _ in range(3))
    gen = loader.circuit(config["circuit"]["kind"])
    params = config["circuit"]
    inputs = gen.draw_inputs(params, input_rng)
    circuit = gen.synthesize(params, inputs, spec.p)
    if circuit.num_constraints != config["constraints"]:
        raise ValueError(f"the circuit has {circuit.num_constraints} constraints, "
                         f"the configuration states {config['constraints']}")
    phases["circuit"] = time.time() - t_start - sum(phases.values())
    crs = crs_mod.load_or_derive(spec, circuit, config, os.path.join(cache, cell["config"]))
    phases["crs_scalars"] = time.time() - t_start - sum(phases.values())
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    st = set_up(config, circuit, crs, device, deal_rng, phases)
    if st.m != config["domain"]:
        raise ValueError(f"the domain is {st.m}, the configuration states {config['domain']}")
    z = circuit.z
    circuit = None  # the constraint lists served the dealing; the check needs z alone
    phases["host_keys"] = time.time() - t_start - sum(phases.values())
    window_path = None
    if device == "cuda" and any(m["source"] == "device_trace"
                                for m in loader.metrics_for(bench, cell_name, False)):
        window_path = os.path.join(cache, "trace", f"{cell_name}.window.json")
    prof = window_profiler(window_path) if window_path else None
    proofs = []
    if prof is not None and not traffic["warmup_proofs"]:
        prof.start()
    for i in range(traffic["warmup_proofs"]):
        if prof is not None and i == traffic["warmup_proofs"] - 1:
            prof.start()  # the last warm-up proof warms the profiler up
        proofs.append(one_proof(st, proof_rng, _no_annotation))
    if prof is not None:
        prof.step()  # from here on it records
    phases["warmup"] = time.time() - t_start - sum(phases.values())

    # set-up's objects (the CRS lists, the port's host tables) out of the
    # collector's reach, so that no full collection walks them in the window
    gc.collect()
    gc.freeze()
    before = _counters(st)
    _sync(st)
    t_window = time.perf_counter()
    cpu_window = time.process_time()
    setup_s = time.time() - t_start
    window = []
    while not window or time.perf_counter() - t_window < seconds:
        window.append(one_proof(st, proof_rng, _no_annotation))
    window_s = time.perf_counter() - t_window
    cpu_window = time.process_time() - cpu_window
    after = _counters(st)
    peak = torch.cuda.max_memory_allocated(st.dev) if device == "cuda" else 0
    window_trace = None
    if prof is not None:
        from . import trace as trace_mod

        t_read = time.perf_counter()
        prof.stop()  # writes the window's trace
        window_trace = trace_mod.device_time(window_path, window_s, len(window))
        os.remove(window_path)
        if window_trace is not None:
            window_trace["read_s"] = time.perf_counter() - t_read

    traced = None
    if trace:
        extra, traced = traced_proofs(st, proof_rng, traffic["profiled_proofs"],
                                      traffic["labelled_proofs"],
                                      os.path.join(cache, "trace", f"{cell_name}.json"))
        proofs += extra
    proofs += window

    record = {
        "setup_s": setup_s,
        "window_s": window_s,
        "proofs": [{k: v for k, v in p.items() if k not in ("unpacked", "fingerprint", "r", "s")}
                   for p in window],
        "counters": {k: after[k] - before[k] for k in after},
        "memory_peak_bytes": peak,
        "trace": traced,
        "window_trace": window_trace,
    }
    metrics = {}
    for m in loader.metrics_for(bench, cell_name, trace):
        value = loader.metric_reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.perf_counter()
    statement = Statement.make(family, crs, z, gen.statement(params, inputs, spec.p))
    checks = check(st, statement, proofs)
    check_s = time.perf_counter() - t_check
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(st.dev) if device == "cuda" else device,
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": all(checks[k] <= LIMITS[k] for k in LIMITS),
              "attempted": len(proofs), "failed": checks["proofs_wrong"],
              "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["top_ops"], "idle_gaps": traced["idle_gaps"]}
    result["timing"] = {"setup_phases_s": phases, "window_s": window_s, "window_cpu_s": cpu_window,
                        "latencies_s": [p["latency_s"] for p in window],
                        "cpu_s": [p["cpu_s"] for p in window],
                        "deal_s": [p["deal_s"] for p in window], "check_s": check_s}
    if traced is not None:
        result["timing"]["traced_device_span_s"] = traced["device_span_s"]
    if window_trace is not None:
        result["timing"]["window_trace"] = {k: v for k, v in window_trace.items()
                                            if k not in ("top_ops", "window_s", "proofs")}
    result["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]} for k in LIMITS}
    return result


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().replace("\n", "; ")


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.time() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of one cell of the benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    import torch

    cell = loader.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"zkbench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()} "
          f"({_power_limit()})", flush=True)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start=t_start)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"zkbench: the run loaded {', '.join(sorted(found))}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
