"""The CIN's least time (``opmap/cin.json``'s operations) over the device
time of the kernels that map assigns to it, in the traced steps, in %."""

from portbench.readings import roofline


def read(r):
    return roofline(r, "cin")
