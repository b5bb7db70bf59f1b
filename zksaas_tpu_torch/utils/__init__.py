"""See the package docstring in zksaas_tpu_torch/__init__.py."""
