"""Share of the traced slice's stock 16-bit convs and deconvs that cuDNN got
NDHWC (the program's counters stock.conv_ndhwc and stock.conv_ncdhw)."""

from portbench import conv_layout


def read(r):
    return conv_layout.ndhwc_pct(r)
