"""dffx_torch.models — DFFNet, the end-to-end network, DFV and DDFFNet as
``nn.Module``s keyed like their references."""

from dffx_torch.models.alignnet import (
    E2ENetwork,
    FlowNetwork,
    MotionHead,
    OFLevel,
    ResnetBlock2dOF,
    e2e_init_params,
)
from dffx_torch.models.ddffnet import DDFFNet, ddffnet_init_params
from dffx_torch.models.dffnet import DFFNet, Hourglass, HourglassUp, Network, init_params
from dffx_torch.models.dfv import DFV, dfv_init_params
from dffx_torch.models.layers import EFD, SRD, FMModule, ResnetBlock2d, init_module_params

__all__ = [
    "DFFNet",
    "Hourglass",
    "HourglassUp",
    "Network",
    "init_params",
    "DFV",
    "dfv_init_params",
    "DDFFNet",
    "ddffnet_init_params",
    "E2ENetwork",
    "FlowNetwork",
    "MotionHead",
    "OFLevel",
    "ResnetBlock2dOF",
    "e2e_init_params",
    "EFD",
    "SRD",
    "FMModule",
    "ResnetBlock2d",
    "init_module_params",
]
