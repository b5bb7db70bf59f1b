"""ext_wit_s: d_prove's ext_wit phase (d_ifft, d_fft, deg_red, h) a proof,
mean over the window (d_prove's own synchronised `times`)."""

from zkbench.stats import per_item


def read(record):
    return per_item(sum(p["phases"]["prove.ext_wit"] for p in record["proofs"]),
                    len(record["proofs"]))
