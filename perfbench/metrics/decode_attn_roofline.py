"""Decode attention's share of its roofline in the profiled window: the
bound of the live rows' contexts (bytes or operations, each step and
layer) over the profiled time of the decode kernels (split and combine),
in %."""

from perfbench import devtrace


def read(rec):
    prof = rec["profile"]
    if prof is None or not prof["decode_bound_s"]:
        return None
    spent = devtrace.seconds_of(prof["kernels"], devtrace.DECODE_KERNELS)
    if spent <= 0:
        return None
    return 100.0 * prof["decode_bound_s"] / spent
