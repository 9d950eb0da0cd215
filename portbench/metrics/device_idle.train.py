"""The share of the traced window in which no kernel, copy or fill ran on
the device, in %."""

from portbench.readings import device_idle


def read(r):
    return device_idle(r)
