"""The window's whole time over the batches completed in it, each the
assignment filled from a fresh batch and its proof (host clock)."""


def read(run):
    return run.per_request()
