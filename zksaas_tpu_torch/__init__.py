"""zksaas_tpu_torch — the PyTorch / CUDA port of zksaas_tpu.

The same distributed Groth16 prover (zkSaaS, eprint 2023/905) as the JAX
package beside it, with the same module layout and the same tensor layout
at every public function, so each module can be held against its
counterpart.  The kernels the JAX package wrote in Pallas for the TPU are
hand-written CUDA C++ for Hopper here (csrc/, built by kernels.py); every
kernel keeps a plain PyTorch version beside it, which is what CPU tensors
run.  Nothing here imports jax or zksaas_tpu.

  fields/   Fr/Fq arithmetic on (..., K) int32 limb tensors; kernel 1
  curves/   G1/G2 Jacobian point ops (kernels 2-4), fixed-base, host oracle
  ntt/      radix-2 domains and the host NTT oracle
  pss/      packed secret sharing
  comm/     the star protocol: LocalNet (all parties in one process), the
            TCP star and HostStarNet (a process a party), SpmdNet (a
            torch.distributed rank a party), JournalNet
  dist/     d_fft/d_ifft, deg_red, d_msm, d_pp; the sharded king paths of
            d_fft/d_ifft and deg_red under SpmdNet
  groth16/  QAP packing, extended witness, CRS packing, d_prove, host oracle
  circom/   R1CS, the SHA-256 fixture circuit, the wasm witness generator
  sha256_e2e.py  the flagship distributed prove (python -m ...)
  host_prove.py  a prove as a king and n - 1 spawned client processes
  spmd_prove.py  a prove as n torch.distributed ranks, the caller rank 0
"""

__version__ = "0.1.0"
