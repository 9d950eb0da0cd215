"""The share of the window the host spent in ``Predictor._stage`` (chunks
copied to the device), in %. The scores' copy back is not timed apart: it
waits for the chunk's forwards."""

from portbench.readings import stage_share


def read(r):
    return stage_share(r, ("stage",))
