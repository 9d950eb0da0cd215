"""The table update's least time (the table and its moments read and
written once, the sorted pairs read once) over the device time of the
kernels ``opmap/table_update.json`` assigns to it, in %."""

from portbench.readings import roofline


def read(r):
    return roofline(r, "table_update")
