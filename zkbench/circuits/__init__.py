"""Circuit generators, one module a kind, found by name (loader.circuit)."""
