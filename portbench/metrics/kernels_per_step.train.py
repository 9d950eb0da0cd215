"""Device kernels launched a step in the traced epoch (copies and fills
not counted)."""

from portbench.readings import kernels_per_step


def read(r):
    return kernels_per_step(r)
