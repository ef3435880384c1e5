"""The moe_gemm kernels' share of their roofline in the traced session: the
least time of every call (bytes once or operations at the peak, the
larger; `lib.work`) over the device time of everything launched inside
the calls' spans, forward and backward (`lib.spans`)."""
from dtrbench.lib.work import roofline_share


def read(run):
    return roofline_share(run, "moe_gemm")
