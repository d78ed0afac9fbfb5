"""The optimizer, the whole update: the device time launched inside the
program's `ttts.train.update` spans (the global norm, the non-finite check,
the clip and AdamW) over the device time of the traced steps; where
`train.optimizer_share` sees AdamW alone."""

from portbench.spans import device_share


def read(r):
    return device_share(r, "ttts.train.update")
