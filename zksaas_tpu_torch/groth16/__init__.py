"""Groth16 on the port: host oracle (local.py), QAP and CRS packing,
extended witness and the distributed prover.  See zksaas_tpu_torch/__init__.py."""

from .ext_wit import circom_h, circom_masks, libsnark_h, libsnark_masks

__all__ = ["circom_h", "circom_masks", "libsnark_h", "libsnark_masks"]
