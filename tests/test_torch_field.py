"""The PyTorch port's Field against the JAX package's Field.

Same inputs (made from a numpy seed, including 0, 1 and p-1) go through
zksaas_tpu.fields.Field (jitted on the CPU) and zksaas_tpu_torch's Field
(on CPU tensors, so its multiply is kernel 1's plain version).  Tolerance:
exact equality of the Montgomery limbs everywhere (both keep canonical
residues).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksaas_tpu.fields import FIELDS as JFIELDS
from zksaas_tpu.fields import Field as JField
from zksaas_tpu_torch import convert
from zksaas_tpu_torch.fields import limbs as tlimbs
from zksaas_tpu_torch.fields import montmul as tmontmul
from zksaas_tpu_torch.fields.field import Field as TField
from zksaas_tpu_torch.fields.spec import FIELDS as TFIELDS

from test_torch_heap import release_heap  # noqa: F401  (autouse)

torch.set_num_threads(1)

NAMES = ["bn254_fr", "bn254_fq"]


def _ints(p, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    return vals + [0, 1, p - 1]


def _setup(name, n=29, seed=0):
    jf, tf = JField(JFIELDS[name]), TField(TFIELDS[name])
    xs, ys = _ints(jf.p, n, seed), _ints(jf.p, n, seed + 1)[::-1]
    a, b = jf.encode(xs), jf.encode(ys)
    return jf, tf, xs, ys, a, b


def _eq(jres, tres):
    np.testing.assert_array_equal(np.asarray(jres), convert.to_numpy(tres))


OPS = {
    "add": (lambda F, a, b: F.add(a, b)),
    "sub": (lambda F, a, b: F.sub(a, b)),
    "sub_rev": (lambda F, a, b: F.sub(b, a)),
    "neg": (lambda F, a, b: F.neg(a)),
    "mul": (lambda F, a, b: F.mul(a, b)),
    "square": (lambda F, a, b: F.square(a)),
    "from_mont": (lambda F, a, b: F.from_mont(a)),
    "muli": (lambda F, a, b: F.muli(a, 12345678901234567890)),
    "pow_const": (lambda F, a, b: F.pow_const(a, 13)),
}


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("name", NAMES)
def test_elementwise_op_matches_jax(name, op):
    jf, tf, _, _, a, b = _setup(name)
    fn = OPS[op]
    _eq(fn(jf, jnp.asarray(a), jnp.asarray(b)),
        fn(tf, convert.to_torch(a, device="cpu"), convert.to_torch(b, device="cpu")))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_large_batch_paths_match_jax(op):
    """4,099 elements: past the sizes where the plain montmul takes its
    limb-major REDC and normalize its limb-by-limb carries."""
    jf, tf, _, _, a, b = _setup("bn254_fq", n=4096, seed=11)
    assert a.shape[0] >= tmontmul._REDC_MIN and 2 * a.size >= tlimbs._SEQ_MIN
    fn = OPS[op]
    _eq(fn(jf, jnp.asarray(a), jnp.asarray(b)),
        fn(tf, convert.to_torch(a, device="cpu"), convert.to_torch(b, device="cpu")))


@pytest.mark.parametrize("name", NAMES)
def test_inv_matches_jax(name):
    jf, tf, _, _, a, _ = _setup(name, n=5, seed=3)
    _eq(jf.inv(jnp.asarray(a)), tf.inv(convert.to_torch(a, device="cpu")))


@pytest.mark.parametrize("name", NAMES)
def test_sum_matches_jax(name):
    jf, tf, _, _, a, _ = _setup(name, n=13, seed=4)
    a3 = a.reshape(4, 4, -1)
    _eq(jf.sum(jnp.asarray(a3), axis=1), tf.sum(convert.to_torch(a3, device="cpu"), axis=1))


@pytest.mark.parametrize("name", NAMES)
def test_encode_decode_round_trip(name):
    jf, tf, xs, _, a, _ = _setup(name, n=100, seed=5)  # > 64: native batch path
    t = tf.encode(xs, device="cpu")
    np.testing.assert_array_equal(convert.to_numpy(t), a)
    assert list(tf.decode(t)) == xs
    small = tf.encode(xs[:3], device="cpu")  # Python path
    assert list(tf.decode(small)) == xs[:3]


@pytest.mark.parametrize("name", NAMES)
def test_batch_inv_zeros_map_to_zeros(name):
    _, tf, xs, _, a, _ = _setup(name, n=20, seed=6)
    p = tf.p
    got = tf.decode(tf.batch_inv(convert.to_torch(a, device="cpu")))
    assert list(got) == [pow(x, -1, p) if x else 0 for x in xs]


@pytest.mark.parametrize("name", NAMES)
def test_rand_is_canonical_and_seeded(name):
    tf = TField(TFIELDS[name])
    r1 = tf.rand(torch.Generator().manual_seed(9), (3, 50), device="cpu")
    r2 = tf.rand(torch.Generator().manual_seed(9), (3, 50), device="cpu")
    assert torch.equal(r1, r2)
    vals = tf.decode(r1).reshape(-1)
    assert all(0 <= int(v) < tf.p for v in vals)
    assert len(set(int(v) for v in vals)) == vals.size
    # Montgomery limbs of canonical residues re-encode to themselves
    assert torch.equal(tf.encode(list(vals), device="cpu").reshape(r1.shape), r1)


@pytest.mark.parametrize("count", [16, 300])
@pytest.mark.parametrize("name", NAMES)
def test_montmul_accepts_raw_operand_below_r(name, count):
    """Field.rand multiplies raw limbs (< R, not reduced) by R^2 (both
    plain paths: 300 elements take the limb-major REDC)."""
    tf = TField(TFIELDS[name])
    spec = tf.spec
    rng = np.random.default_rng(7)
    raws = [int.from_bytes(rng.bytes(32), "little") for _ in range(count)] + [spec.R - 1]
    limbs = lambda x: [(x >> (16 * i)) & 0xFFFF for i in range(16)]
    a = torch.tensor([limbs(x) for x in raws], dtype=torch.int32)
    b = tf.const(7, (len(raws),), device="cpu").contiguous()
    got = tf.decode(tmontmul.montmul(spec, a, b))
    rinv = pow(spec.R, -1, spec.p)
    assert list(got) == [x * rinv * 7 % spec.p for x in raws]


@pytest.mark.parametrize("rows,n", [(64, 1), (64, 5), (64, 18), (64, 34), (4096, 18)])
def test_normalize_resolves_long_carry_chains(rows, n):
    """Redundant columns with long 0xFFFF runs (rare in random field values)
    normalize to the limbs of the same integer, against Python ints (4,096
    rows take the limb-by-limb carries)."""
    rng = np.random.default_rng(n)
    x = 0xFFFF + rng.integers(-1, 3, size=(rows, n))
    x = np.where(rng.random((rows, n)) < 0.2, rng.integers(0, 1 << 18, size=(rows, n)), x)
    out, top = tlimbs.normalize(torch.from_numpy(x))
    for row, o, c in zip(x.tolist(), out.tolist(), top.tolist()):
        want = sum(v << (16 * j) for j, v in enumerate(row))
        assert sum(v << (16 * j) for j, v in enumerate(o)) + (c << (16 * n)) == want
        assert max(o) <= 0xFFFF


def test_montmul_wrapper_rejects_bad_operands():
    spec = TFIELDS["bn254_fr"]
    a = torch.zeros(4, 16, dtype=torch.int32)
    with pytest.raises(TypeError):
        tmontmul.montmul(spec, a.long(), a.long())
    with pytest.raises(ValueError):
        tmontmul.montmul(spec, a, a[:2])
    with pytest.raises(ValueError):
        tmontmul.montmul(spec, a.t(), a.t())
