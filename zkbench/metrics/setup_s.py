"""setup_s: from the start of the process to the start of the window (host
clock): imports, the card, the circuit, the CRS, the dealing, the warm-up."""


def read(record):
    return record["setup_s"]
