"""The host's time in a call of ``Trainer._train_step`` (no synchronise:
the time to enqueue a step), the mean over the window's steps, in ms."""

from portbench.readings import host_enqueue_ms


def read(r):
    return host_enqueue_ms(r)
