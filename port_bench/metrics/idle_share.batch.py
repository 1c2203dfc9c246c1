"""The share of the traced window in which no kernel, copy or memset ran on
the card, in percent."""


def read(run):
    return run.idle_share()
