"""The device: the share of the traced window in which no operation ran
on the card (the union of the device's operation intervals)."""

from portbench.readers import idle_share


def read(r):
    return idle_share(r)
