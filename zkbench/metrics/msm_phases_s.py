"""msm_phases_s: d_prove's A, B_g1, B_g2 and C phases (the five d_msm and
the king's point mat-vecs) a proof, mean over the window."""

from zkbench.stats import per_item

PHASES = ("prove.A", "prove.B_g1", "prove.B_g2", "prove.C")


def read(record):
    return per_item(sum(p["phases"][k] for p in record["proofs"] for k in PHASES),
                    len(record["proofs"]))
