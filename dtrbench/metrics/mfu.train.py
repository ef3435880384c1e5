"""Model FLOPs utilisation over the traced run's whole window: three times
the forward's matrix-product FLOPs (the family's ``forward_flops``: the
experts a token is routed to and the visible causal pairs count,
recompute does not) of every step completed, over the window's wall
times the bf16 peak."""
from dtrbench.lib.work import MFU_PEAK_OPS_PER_S


def read(run):
    steps = len(run.stamps) - 1
    if steps < 1:
        return None
    flops = 3 * run.family.forward_flops(run.config["model"],
                                         run.traffic["batch"],
                                         run.traffic["seq"]) * steps
    return 100 * flops / ((run.stamps[-1] - run.stamps[0])
                          * MFU_PEAK_OPS_PER_S)
