"""Readers that two per-layer metrics share (the same quantity in cells
that report different end-to-end metrics)."""


def idle_share(rec):
    prof = rec["profile"]
    if prof is None or prof["busy_s"] <= 0 or prof["idle_share"] is None:
        return None
    return 100.0 * prof["idle_share"]


def admit_share(rec):
    if rec["host_s"] <= 0:
        return None
    return 100.0 * rec["admit_s"] / rec["host_s"]
