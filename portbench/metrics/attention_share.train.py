"""The device time of the kernels ``opmap/attention.json`` assigns to the
model's attention module, forward and backward, over the traced busy
time, in %; nothing where the model has no such module or no card was
traced."""

from portbench.readings import kernel_seconds, share


def read(r):
    t = r["trace"]
    if t is None or t["busy_s"] <= 0 or "attention" not in r["opmaps"]:
        return None
    spent = kernel_seconds(r, "attention")
    return share(spent, t["busy_s"]) if spent > 0 else None
