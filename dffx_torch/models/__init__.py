"""dffx_torch.models — DFFNet (eval) as ``nn.Module``s keyed like the reference."""

from dffx_torch.models.dffnet import DFFNet, Hourglass, HourglassUp, Network, init_params
from dffx_torch.models.layers import EFD, SRD, FMModule, ResnetBlock2d, init_module_params

__all__ = [
    "DFFNet",
    "Hourglass",
    "HourglassUp",
    "Network",
    "init_params",
    "EFD",
    "SRD",
    "FMModule",
    "ResnetBlock2d",
    "init_module_params",
]
