"""dffx_torch — the DFFNet and end-to-end (FlowNetwork alignment + DFFNet)
eval forwards in PyTorch, with hand-written CUDA kernels for Hopper (H100)
on the full-resolution focus-measure chain, the alignment feature pyramid and
the full-resolution motion head.

Layout inside the port is torch's ``(B, C, N, H, W)``; the public forward
keeps the JAX package's ``(B, N, H, W, 3)`` focal stack and ``(B, N)`` focus
distances.  Parameters are ``nn.Module`` state dicts keyed exactly like the
reference ``state_dict`` (``DFF_net.FM_measure.Focus_extraction.0.0.weight``,
...).  The package imports torch and numpy only.

Importing this package has no side effects: the CUDA library is built at the
first kernel launch (``dffx_torch.ops._build``).
"""

__version__ = "0.1.0"
