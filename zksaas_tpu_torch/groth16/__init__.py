"""Groth16 on the port: host oracle (local.py), QAP and CRS packing,
extended witness and the distributed prover.  See zksaas_tpu_torch/__init__.py."""
