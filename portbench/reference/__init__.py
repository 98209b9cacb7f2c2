"""The benchmark's plain reference: fp32 PyTorch, unpacked, importing nothing
of the program (``nets``: the forwards; ``train``: the DDFF step and Adam;
``weights``: the seeded draw; ``lowp``: the control's fp8)."""
