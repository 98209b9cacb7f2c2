"""dffx_torch.eval — serving utilities and the port's eval command lines:

* ``python -m dffx_torch.eval.test --dataset {DefocusNet,4D_Light_Field,DDFF,
  Smartphone,FlyingThings3D}`` (``dffx/eval/test.py``);
* ``python -m dffx_torch.eval.real_scenes`` (``dffx/eval/real_scenes.py``).

Both take ``--device`` (default ``cuda``) and print what ``dffx``'s print.
"""

from dffx_torch.eval.common import (
    TimedForward,
    checkpoint_or_seed,
    cli_device,
    jet_colormap,
    load_params_auto,
    save_jet,
)

__all__ = ["TimedForward", "checkpoint_or_seed", "cli_device", "jet_colormap",
           "load_params_auto", "save_jet"]
