"""The prefill flash kernel's share of its roofline in the profiled
window: the bound of the real prompt lengths admitted there (causal pairs
and q, k, v, o bytes, each call and layer) over the profiled time of
``flash_attention_kernel``, in %."""

from perfbench import devtrace


def read(rec):
    prof = rec["profile"]
    if prof is None or not prof["flash_bound_s"]:
        return None
    spent = devtrace.seconds_of(prof["kernels"], devtrace.FLASH_KERNELS)
    if spent <= 0:
        return None
    return 100.0 * prof["flash_bound_s"] / spent
