"""The backward: the device time launched inside the program's
`ttts.train.backward` spans (autograd.grad of the loss) over the device
time of the traced steps."""

from portbench.spans import device_share


def read(r):
    return device_share(r, "ttts.train.backward")
