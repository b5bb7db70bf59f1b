"""The benchmark's plain reference: host Python that imports nothing of the
program under test (checked by zkbench/tests/test_zkbench_isolation.py)."""
