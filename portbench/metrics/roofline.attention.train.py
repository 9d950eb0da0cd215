"""The attention stack's least time (``opmap/attention.json``'s operations,
counted by the model kind) over the device time of the kernels that map
assigns to it, in the traced steps, in %."""

from portbench.readings import roofline


def read(r):
    return roofline(r, "attention")
