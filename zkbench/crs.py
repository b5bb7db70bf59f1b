"""The Groth16 CRS as the benchmark's input: toxic waste and query scalars.

A deployment makes its proving key once for each circuit, so the CRS is an
input of the benchmark, as a model's weights are.  The toxic waste
(alpha, beta, gamma, delta, tau) is drawn from the configuration's
`crs_seed`; the query scalars follow ark-groth16's generator with the
circom reduction, as the port's host setup does (a frozen copy of
zksaas_tpu_torch/groth16/setup_device.py::setup_scalars, with tau's powers
taken by repeated multiplication in place of one pow each: the same
values).  The harness hands the scalars to the program, which makes and
packs the points on the card; the reference reads the same scalars.

The scalars of a configuration are kept in `<cache>/crs-<key>.bin`, made by
the first run that needs them; the key covers the circuit's kind and
parameters, the curve, the reduction and the seed.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
from dataclasses import dataclass

from .r1cs import Circuit

_LISTS = ("a_t", "b_t", "h_scalars", "l_scalars", "gamma_abc")
_INTS = ("alpha", "beta", "gamma", "delta", "m")
_FORMAT = 1
_WIDTH = 32  # bytes a scalar: every scalar field here is under 2^256


@dataclass
class CrsScalars:
    p: int
    alpha: int
    beta: int
    gamma: int
    delta: int
    m: int  # the QAP domain's size
    a_t: list[int]  # A_i(tau) of every variable
    b_t: list[int]
    h_scalars: list[int]  # the h-query's scalars (circom reduction)
    l_scalars: list[int]  # (beta A_i + alpha B_i + C_i)(tau) / delta, witness variables
    gamma_abc: list[int]  # the same over gamma, instance variables


def domain_size(n: int) -> int:
    s = 1
    while s < n:
        s *= 2
    return s


def _fft_int(vals: list[int], g: int, p: int) -> list[int]:
    """In-order DFT out[i] = sum_j vals[j] g^(ij), iterative Cooley-Tukey."""
    n = len(vals)
    x = list(vals)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            x[i], x[j] = x[j], x[i]
    half = 1
    while half < n:
        w_m = pow(g, n // (2 * half), p)
        ws = [1] * half
        for k in range(1, half):
            ws[k] = ws[k - 1] * w_m % p
        for k in range(0, n, 2 * half):
            for jj in range(half):
                u = x[k + jj]
                v = x[k + jj + half] * ws[jj] % p
                x[k + jj] = (u + v) % p
                x[k + jj + half] = (u - v) % p
        half *= 2
    return x


def _ifft(spec, evals: list[int]) -> list[int]:
    p = spec.p
    n = len(evals)
    n_inv = pow(n, -1, p)
    g_inv = pow(spec.root_of_unity(n), -1, p)
    return [c * n_inv % p for c in _fft_int(evals, g_inv, p)]


def _lagrange_at(spec, m: int, tau: int) -> list[int]:
    """L_i(tau) over the size-m radix-2 domain (tau off the domain)."""
    p = spec.p
    g = spec.root_of_unity(m)
    zt = (pow(tau, m, p) - 1) % p
    if zt == 0:
        raise ValueError("tau lies on the domain")
    scale = zt * pow(m, -1, p) % p
    out = []
    gi = 1
    for _ in range(m):
        out.append(scale * gi % p * pow((tau - gi) % p, -1, p) % p)
        gi = gi * g % p
    return out


def derive(spec, circuit: Circuit, crs_seed: int) -> CrsScalars:
    """ark-groth16's circuit-specific setup scalars, circom reduction."""
    p = spec.p
    rng = random.Random(crs_seed)
    alpha, beta, gamma, delta, tau = (rng.randrange(1, p) for _ in range(5))
    m = domain_size(circuit.num_constraints + circuit.num_instance)
    u = _lagrange_at(spec, m, tau)
    nv = circuit.num_vars
    a_t, b_t, c_t = [0] * nv, [0] * nv, [0] * nv
    for r in range(circuit.num_constraints):
        ur = u[r]
        for coeff, v in circuit.a[r]:
            a_t[v] = (a_t[v] + coeff * ur) % p
        for coeff, v in circuit.b[r]:
            b_t[v] = (b_t[v] + coeff * ur) % p
        for coeff, v in circuit.c[r]:
            c_t[v] = (c_t[v] + coeff * ur) % p
    # the instance rows follow the constraints (the circom instance map)
    for i in range(circuit.num_instance):
        a_t[i] = (a_t[i] + u[circuit.num_constraints + i]) % p
    gamma_inv = pow(gamma, -1, p)
    delta_inv = pow(delta, -1, p)
    ni = circuit.num_instance
    gamma_abc = [(beta * a_t[i] + alpha * b_t[i] + c_t[i]) * gamma_inv % p for i in range(ni)]
    l_scalars = [(beta * a_t[i] + alpha * b_t[i] + c_t[i]) * delta_inv % p
                 for i in range(ni, nv)]
    # CircomReduction::h_query_scalars: delta_inv * tau^i for i < 2m - 1,
    # the ifft over the doubled domain, the odd coefficients
    scal = [0] * (2 * m)
    x = delta_inv
    for i in range(2 * m - 1):
        scal[i] = x
        x = x * tau % p
    h_scalars = _ifft(spec, scal)[1::2]
    return CrsScalars(p, alpha, beta, gamma, delta, m, a_t, b_t, h_scalars, l_scalars,
                      gamma_abc)


def cache_key(config: dict) -> str:
    what = {k: config[k] for k in ("circuit", "curve", "reduction", "crs_seed")}
    return hashlib.sha256(json.dumps([_FORMAT, what], sort_keys=True).encode()).hexdigest()[:16]


def _write(path: str, crs: CrsScalars) -> None:
    head = {k: getattr(crs, k) for k in ("p",) + _INTS}
    head["lengths"] = [len(getattr(crs, k)) for k in _LISTS]
    tmp = f"{path}.part"
    with open(tmp, "wb") as f:
        f.write(json.dumps(head).encode() + b"\n")
        for k in _LISTS:
            f.write(b"".join(x.to_bytes(_WIDTH, "little") for x in getattr(crs, k)))
    os.replace(tmp, path)


def _read(path: str) -> CrsScalars:
    with open(path, "rb") as f:
        head = json.loads(f.readline())
        body = memoryview(f.read())
    lists, at = {}, 0
    for k, n in zip(_LISTS, head["lengths"]):
        lists[k] = [int.from_bytes(body[i : i + _WIDTH], "little")
                    for i in range(at, at + _WIDTH * n, _WIDTH)]
        at += _WIDTH * n
    if at != len(body):
        raise ValueError(f"{path}: {len(body) - at} bytes left over")
    return CrsScalars(p=head["p"], **{k: head[k] for k in _INTS}, **lists)


def load_or_derive(spec, circuit: Circuit, config: dict, cache_dir: str) -> CrsScalars:
    """The configuration's CRS scalars, from the cache or derived (and
    then cached)."""
    path = os.path.join(cache_dir, f"crs-{cache_key(config)}.bin")
    if os.path.exists(path):
        crs = _read(path)
        if len(crs.a_t) != circuit.num_vars or crs.p != spec.p:
            raise ValueError(f"{path} does not belong to this circuit")
        return crs
    crs = derive(spec, circuit, config["crs_seed"])
    os.makedirs(cache_dir, exist_ok=True)
    _write(path, crs)
    return crs
