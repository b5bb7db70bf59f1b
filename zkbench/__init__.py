"""The benchmark of zksaas_tpu_torch on the card (see README.md)."""
