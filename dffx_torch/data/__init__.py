"""dffx_torch.data — the port's dataset readers, augmentation, EXR codec and
input pipeline: copies of ``dffx.data`` in numpy, the port's C++ host
library (decode and normalisation, ``native``), ``cv2``, ``h5py`` and
``scipy.io`` (imported by the reader that needs them), with a prefetch that
pins each batch and copies it to the card on a side stream."""

from dffx_torch.data.datasets import (
    DDFFBenchmark,
    DDFFTrainval,
    DefocusNetDataset,
    FlyingThings3DDataset,
    HCIDataset,
    MiddleburyDataset,
    RealScenesDataset,
    SmartphoneDataset,
    ddff_focus_dists,
)
from dffx_torch.data.pipeline import Loader, device_prefetch
from dffx_torch.data.simulated import SimulatedScenesDataset

__all__ = [
    "DDFFBenchmark",
    "DDFFTrainval",
    "DefocusNetDataset",
    "FlyingThings3DDataset",
    "HCIDataset",
    "MiddleburyDataset",
    "RealScenesDataset",
    "SmartphoneDataset",
    "ddff_focus_dists",
    "Loader",
    "SimulatedScenesDataset",
    "device_prefetch",
]
