"""profile_prove's readers of what nvcc and the profiler report.

Pure Python, nothing is built or launched: `_parse_ptxas` on the
`-Xptxas -v` logs of two ring sources as nvcc wrote them for sm_90a
(csrc/ring_g1_8.cu and csrc/ring_g2_12_5.cu), where the grouped kernels call
the non-inlined `cc_mul` and ptxas lists that callee's frame under its own
name; `_kernel_label` on the mangled name of every point and ring kernel in
each of the five coordinate rings; `_short` on trace kernel names; and
`_kernel_table` on a small recorded trace.  Tolerance: exact equality.
"""

import json

import pytest

from zksaas_tpu_torch.profile_prove import TOP, _kernel_label, _kernel_table, _parse_ptxas, _short

from test_torch_heap import release_heap  # noqa: F401  (autouse)

PTXAS_RING_G1_8 = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2zk14madd_if_kernelINS_6RingFqILi8EEEEEvPKiS4_S4_S4_S4_PKhPiS7_S7_lNT_1PE' for 'sm_90a'
ptxas info    : Function properties for _ZN2zk14madd_if_kernelINS_6RingFqILi8EEEEEvPKiS4_S4_S4_S4_PKhPiS7_S7_lNT_1PE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers
ptxas info    : Compile time = 1916.329 ms
ptxas info    : Compiling entry function '_ZN2zk11aadd_kernelINS_6RingFqILi8EEEEEvPKiS4_S4_S4_PKhS6_PiS7_S7_lNT_1PE' for 'sm_90a'
ptxas info    : Function properties for _ZN2zk11aadd_kernelINS_6RingFqILi8EEEEEvPKiS4_S4_S4_PKhS6_PiS7_S7_lNT_1PE
    136 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 52 registers, used 0 barriers, 136 bytes cumulative stack size
ptxas info    : Compile time = 192.033 ms
ptxas info    : Function properties for _ZN2zk6cc_mulILi8EEENS_2FqIXT_EEES2_S2_RKNS_11FieldParamsIXT_EEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN2zk15ring_inv_kernelINS_6RingFqILi8EEEEEvPKiPilNT_1PE' for 'sm_90a'
ptxas info    : Function properties for _ZN2zk15ring_inv_kernelINS_6RingFqILi8EEEEEvPKiPilNT_1PE
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 32 bytes cumulative stack size
ptxas info    : Compile time = 94.118 ms
ptxas info    : Compiling entry function '_ZN2zk15ring_mul_kernelINS_6RingFqILi8EEEEEvPKiS4_PilNT_1PE' for 'sm_90a'
ptxas info    : Function properties for _ZN2zk15ring_mul_kernelINS_6RingFqILi8EEEEEvPKiS4_PilNT_1PE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 42 registers, used 0 barriers
ptxas info    : Compile time = 35.635 ms
ptxas info    : Compiling entry function '_ZN2zk13double_kernelINS_6RingFqILi8EEEEEvPKiS4_S4_PiS5_S5_liNT_1PE' for 'sm_90a'
ptxas info    : Function properties for _ZN2zk13double_kernelINS_6RingFqILi8EEEEEvPKiS4_S4_PiS5_S5_liNT_1PE
    144 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 54 registers, used 0 barriers, 144 bytes cumulative stack size
ptxas info    : Compile time = 94.154 ms
ptxas info    : Function properties for _ZN2zk6cc_mulILi8EEENS_2FqIXT_EEES2_S2_RKNS_11FieldParamsIXT_EEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN2zk10add_kernelINS_6RingFqILi8EEEEEvPKiS4_S4_S4_S4_S4_PKhPiS7_S7_lNT_1PE' for 'sm_90a'
ptxas info    : Function properties for _ZN2zk10add_kernelINS_6RingFqILi8EEEEEvPKiS4_S4_S4_S4_S4_PKhPiS7_S7_lNT_1PE
    176 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers, 176 bytes cumulative stack size
ptxas info    : Compile time = 152.505 ms
ptxas info    : Function properties for _ZN2zk6cc_mulILi8EEENS_2FqIXT_EEES2_S2_RKNS_11FieldParamsIXT_EEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""

PTXAS_RING_G2_12_5 = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2zk14madd_if_kernelINS_7RingFq2ILi12ELi5EEEEEvPKiS4_S4_S4_S4_PKhPiS7_S7_lNT_1PE' for 'sm_90a'
ptxas info    : Function properties for _ZN2zk14madd_if_kernelINS_7RingFq2ILi12ELi5EEEEEvPKiS4_S4_S4_S4_PKhPiS7_S7_lNT_1PE
    472 bytes stack frame, 772 bytes spill stores, 776 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 472 bytes cumulative stack size
ptxas info    : Compile time = 24150.150 ms
ptxas info    : Compiling entry function '_ZN2zk11aadd_kernelINS_7RingFq2ILi12ELi5EEEEEvPKiS4_S4_S4_PKhS6_PiS7_S7_lNT_1PE' for 'sm_90a'
ptxas info    : Function properties for _ZN2zk11aadd_kernelINS_7RingFq2ILi12ELi5EEEEEvPKiS4_S4_S4_PKhS6_PiS7_S7_lNT_1PE
    136 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 71 registers, used 0 barriers, 136 bytes cumulative stack size
ptxas info    : Compile time = 661.977 ms
ptxas info    : Function properties for _ZN2zk6cc_mulILi12EEENS_2FqIXT_EEES2_S2_RKNS_11FieldParamsIXT_EEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN2zk15ring_inv_kernelINS_7RingFq2ILi12ELi5EEEEEvPKiPilNT_1PE' for 'sm_90a'
ptxas info    : Function properties for _ZN2zk15ring_inv_kernelINS_7RingFq2ILi12ELi5EEEEEvPKiPilNT_1PE
    48 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 48 bytes cumulative stack size
ptxas info    : Compile time = 1036.230 ms
ptxas info    : Compiling entry function '_ZN2zk15ring_mul_kernelINS_7RingFq2ILi12ELi5EEEEEvPKiS4_PilNT_1PE' for 'sm_90a'
ptxas info    : Function properties for _ZN2zk15ring_mul_kernelINS_7RingFq2ILi12ELi5EEEEEvPKiS4_PilNT_1PE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 112 registers, used 0 barriers
ptxas info    : Compile time = 555.404 ms
ptxas info    : Compiling entry function '_ZN2zk13double_kernelINS_7RingFq2ILi12ELi5EEEEEvPKiS4_S4_PiS5_S5_liNT_1PE' for 'sm_90a'
ptxas info    : Function properties for _ZN2zk13double_kernelINS_7RingFq2ILi12ELi5EEEEEvPKiS4_S4_PiS5_S5_liNT_1PE
    176 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 66 registers, used 0 barriers, 176 bytes cumulative stack size
ptxas info    : Compile time = 379.060 ms
ptxas info    : Function properties for _ZN2zk6cc_mulILi12EEENS_2FqIXT_EEES2_S2_RKNS_11FieldParamsIXT_EEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN2zk10add_kernelINS_7RingFq2ILi12ELi5EEEEEvPKiS4_S4_S4_S4_S4_PKhPiS7_S7_lNT_1PE' for 'sm_90a'
ptxas info    : Function properties for _ZN2zk10add_kernelINS_7RingFq2ILi12ELi5EEEEEvPKiS4_S4_S4_S4_S4_PKhPiS7_S7_lNT_1PE
    160 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 79 registers, used 0 barriers, 160 bytes cumulative stack size
ptxas info    : Compile time = 831.096 ms
ptxas info    : Function properties for _ZN2zk6cc_mulILi12EEENS_2FqIXT_EEES2_S2_RKNS_11FieldParamsIXT_EEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""

# (label, registers, stack frame, spill stores, spill loads) of each entry,
# in the order ptxas compiled them
ROWS = {
    "ring_g1_8": (PTXAS_RING_G1_8, [
        ("madd_if_kernel<Fq[8]>", 128, 0, 0, 0),
        ("aadd_kernel<Fq[8]>", 52, 136, 0, 0),
        ("ring_inv_kernel<Fq[8]>", 40, 32, 0, 0),
        ("ring_mul_kernel<Fq[8]>", 42, 0, 0, 0),
        ("double_kernel<Fq[8]>", 54, 144, 0, 0),
        ("add_kernel<Fq[8]>", 56, 176, 0, 0),
    ]),
    "ring_g2_12_5": (PTXAS_RING_G2_12_5, [
        ("madd_if_kernel<Fq2[12, nr -5]>", 255, 472, 772, 776),
        ("aadd_kernel<Fq2[12, nr -5]>", 71, 136, 0, 0),
        ("ring_inv_kernel<Fq2[12, nr -5]>", 96, 48, 0, 0),
        ("ring_mul_kernel<Fq2[12, nr -5]>", 112, 0, 0, 0),
        ("double_kernel<Fq2[12, nr -5]>", 66, 176, 0, 0),
        ("add_kernel<Fq2[12, nr -5]>", 79, 160, 0, 0),
    ]),
}


@pytest.mark.parametrize("source", sorted(ROWS))
def test_parse_ptxas_gives_each_kernel_its_own_frame(source):
    """Every entry gets its registers and its own stack and spill bytes; the
    callee's 0-byte frame, listed after the entry that calls it, is not
    taken for the next entry's or the last one's."""
    log, want = ROWS[source]
    got = _parse_ptxas(log)
    assert [(r["kernel"], r["registers"], r["stack"], r["spill_stores"], r["spill_loads"])
            for r in got] == want


# each kernel's mangled parameter list, as ptxas names the entry
PARAMS = {
    "add_kernel": "PKiS4_S4_S4_S4_S4_PKhPiS7_S7_lNT_1PE",
    "aadd_kernel": "PKiS4_S4_S4_PKhS6_PiS7_S7_lNT_1PE",
    "double_kernel": "PKiS4_S4_PiS5_S5_liNT_1PE",
    "madd_if_kernel": "PKiS4_S4_S4_S4_PKhPiS7_S7_lNT_1PE",
    "ring_mul_kernel": "PKiS4_PilNT_1PE",
    "ring_inv_kernel": "PKiPilNT_1PE",
}
# each coordinate ring's mangled template argument and its label
RINGS = {
    "6RingFqILi8EE": "Fq[8]",
    "6RingFqILi12EE": "Fq[12]",
    "7RingFq2ILi8ELi1EE": "Fq2[8, nr -1]",
    "7RingFq2ILi12ELi1EE": "Fq2[12, nr -1]",
    "7RingFq2ILi12ELi5EE": "Fq2[12, nr -5]",
}
LABELS = [(k, r) for k in PARAMS for r in RINGS]


def _mangled(kernel, ring):
    return f"_ZN2zk{len(kernel)}{kernel}INS_{ring}EEEv{PARAMS[kernel]}"


def test_mangled_names_are_the_ones_ptxas_writes():
    """The names built below are those of the two logs above."""
    for log, _ in ROWS.values():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                assert any(name == _mangled(k, r) for k, r in LABELS), name


@pytest.mark.parametrize("kernel,ring", LABELS, ids=[f"{k}-{RINGS[r]}" for k, r in LABELS])
def test_kernel_label_names_the_kernel_and_its_ring(kernel, ring):
    assert _kernel_label(_mangled(kernel, ring)) == f"{kernel}<{RINGS[ring]}>"


def test_kernel_label_names_a_second_template_argument():
    """ring_mul_kernel<R, PARTS> (csrc/kernels.cuh), as ptxas names it."""
    for ring, label in (("7RingFq2ILi12ELi5EE", "Fq2[12, nr -5]"), ("6RingFqILi8EE", "Fq[8]")):
        name = f"_ZN2zk15ring_mul_kernelINS_{ring}ELi3EEEvPKiS5_PilNT_1PE"
        assert _kernel_label(name) == f"ring_mul_kernel<{label}, 3>"


@pytest.mark.parametrize("raw,want", [
    ("void zk::add_kernel<zk::RingFq2<12, 1> >(int const*, int const*, int const*, int const*, "
     "int const*, int const*, unsigned char const*, int*, int*, int*, long, "
     "zk::RingFq2<12, 1>::P)", "zk::add_kernel<zk::RingFq2<12, 1> >"),
    ("void at::native::(anonymous namespace)::elementwise_kernel<128, 2, "
     "at::native::gpu_kernel_impl_nocast<at::native::AddFunctor<long> >(at::TensorIteratorBase&, "
     "at::native::AddFunctor<long> const&)::{lambda(int)#1}>(int, "
     "at::native::gpu_kernel_impl_nocast<at::native::AddFunctor<long> >(at::TensorIteratorBase&, "
     "at::native::AddFunctor<long> const&)::{lambda(int)#1})", "at::native::elementwise_kernel"),
    ("void montmul_kernel<8>(int const*, int const*, int*, long, FieldParams<8>)",
     "montmul_kernel"),
    ("radix_scatter_kernel(unsigned int const*, unsigned int*, int const*, int, int, int)",
     "radix_scatter_kernel"),
], ids=["port-template", "torch-anonymous", "plain-template", "no-template"])
def test_short_keeps_the_ring_of_the_port_kernels_only(raw, want):
    assert _short(raw) == want



def test_kernel_table_lists_every_port_kernel_whatever_its_rank(tmp_path):
    """A trace of 30 PyTorch kernels, each longer than any of the port's
    ring_mul, ring_inv, montmul and sort-pass kernels: the table holds the
    TOP names by time and all four of the port's, with their seconds and
    launches; the busy time is the union of the intervals."""
    ring = "zk::RingFq<8>"
    port = [f"void zk::ring_mul_kernel<{ring} >(int const*, int const*, int*, long, {ring}::P)",
            f"void zk::ring_inv_kernel<{ring} >(int const*, int*, long, {ring}::P)",
            "void montmul_kernel<8>(int const*, int const*, int*, long, FieldParams<8>)",
            "radix_scatter_kernel(unsigned int const*, unsigned int*, int const*, int, int, int)"]
    torch_names = [f"void at::native::kernel_{i}<float>(float*)" for i in range(30)]
    events = [{"cat": "kernel", "name": n, "ts": 1000 * i, "dur": 100 + i}
              for i, n in enumerate(torch_names)]
    events += [{"cat": "kernel", "name": n, "ts": 50_000 + 10 * i, "dur": 5} for i, n in
               enumerate(port + port[:1])]
    events.append({"cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 10**6})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    table = _kernel_table(str(path))
    names = [r["name"] for r in table["by_name"]]
    assert names[:TOP] == [f"at::native::kernel_{i}" for i in range(29, 29 - TOP, -1)]
    rest = table["by_name"][TOP:]
    assert {r["name"]: r["launches"] for r in rest} == {
        f"zk::ring_mul_kernel<{ring} >": 2, f"zk::ring_inv_kernel<{ring} >": 1,
        "montmul_kernel": 1, "radix_scatter_kernel": 1}
    assert [r["device_s"] for r in rest] == pytest.approx([10e-6, 5e-6, 5e-6, 5e-6])
    assert table["kernels_in_trace"] == 35
    assert table["device_busy_s"] == pytest.approx((sum(100 + i for i in range(30)) + 25) * 1e-6)
