"""dffx_torch — the DFFNet and end-to-end (FlowNetwork alignment + DFFNet)
networks in PyTorch: eval forwards with hand-written CUDA kernels for Hopper
(H100) on the full-resolution focus-measure chain, the alignment feature
pyramid and the full-resolution motion head, and the train step
(``dffx_torch.train``) on stock ops; ``dffx``'s command lines and the
thin-lens simulator (``dffx_torch.sim``) that makes the end-to-end network's
training data, behind one front door (``python -m dffx_torch``); over several
processes, one rank each (``dffx_torch.parallel``), data-parallel training
and H-sharded serving of the kernels' chains.

Layout inside the port is torch's ``(B, C, N, H, W)``; the public forward
keeps the JAX package's ``(B, N, H, W, 3)`` focal stack and ``(B, N)`` focus
distances.  Parameters are ``nn.Module`` state dicts keyed exactly like the
reference ``state_dict`` (``DFF_net.FM_measure.Focus_extraction.0.0.weight``,
...).  The package imports torch and numpy only.

Importing this package has no side effects: the CUDA library is built at the
first kernel launch (``dffx_torch.ops._build``).
"""

__version__ = "0.1.0"
