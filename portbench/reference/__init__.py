"""The benchmark's plain reference: fp32 PyTorch, unpacked, importing nothing
of the program (``nets``: DFFNet's and E2E's forwards; ``train``: a train
step, the DDFF loss and Adam; ``weights``: the seeded draw; ``lowp``: the
control's fp8).  A network that joins brings its forward as a file of its
own here."""
