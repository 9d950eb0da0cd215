"""The share of the window the host spent building chunks (each ``next()``
of ``Trainer._chunk_plan``) and staging them (``Trainer._stage_seconds``),
in %."""

from portbench.readings import stage_share


def read(r):
    return stage_share(r)
