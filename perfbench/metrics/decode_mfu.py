"""Model FLOPs of the live rows the window decoded over the synced time of
``step()`` at the card's bf16 peak, in %."""

from perfbench import counts


def read(rec):
    if not rec["step_s"] or not rec["decode_flops"]:
        return None
    return 100.0 * rec["decode_flops"] / (rec["step_s"] * counts.PEAK_FLOPS)
