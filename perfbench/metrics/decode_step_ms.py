"""Host time of ``step()`` (synced) per decode step the engine took, ms."""


def read(rec):
    if not rec["decode_steps"]:
        return None
    return 1e3 * rec["step_s"] / rec["decode_steps"]
