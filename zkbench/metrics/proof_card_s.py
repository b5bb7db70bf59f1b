"""proof_card_s: the card's busy seconds a proof over the window: the union
of the device operations' intervals (kernels, copies, fills) in the trace
of the whole window with CUDA activity alone, over the proofs the window
completed.  The card time a proof costs, which provers that share a card
divide among them; the host's speed, which sets proof_s, does not enter it."""


def read(record):
    t = record.get("window_trace")
    return t["busy_s"] / t["proofs"] if t and t["busy_s"] > 0 and t["proofs"] else None
