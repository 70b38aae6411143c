"""The port's copy of ``repro.core.ibsim`` as far as the fleet needs it:
the serially-held ``Resource`` timeline behind every dispatch-channel
lock.  The data-path simulator behind the paper's figures is not ported
yet."""

from repro_torch.core.ibsim.engine import Resource

__all__ = ["Resource"]
