"""The whole step's least time (every operation counted from shapes at the
configuration's compute dtype, ``counts.step_ops``) over the traced time
a step took, in %."""

from portbench.readings import mfu


def read(r):
    return mfu(r)
