"""dffx_torch.sim — thin-lens defocus simulator (synthetic in-the-wild focal
stacks), rendering on the card."""

from dffx_torch.sim.simulator import (
    DEVICE_PROFILES,
    DeviceProfile,
    coc_layers,
    disc_kernel,
    generate_scene,
    render_focal_slice,
    render_scene_fused,
    render_slice_fused,
    warp_2d,
)

__all__ = [
    "DEVICE_PROFILES",
    "DeviceProfile",
    "coc_layers",
    "disc_kernel",
    "generate_scene",
    "render_focal_slice",
    "render_scene_fused",
    "render_slice_fused",
    "warp_2d",
]
