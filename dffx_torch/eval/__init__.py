"""dffx_torch.eval — serving utilities for the port."""

from dffx_torch.eval.common import TimedForward, load_params_auto

__all__ = ["TimedForward", "load_params_auto"]
