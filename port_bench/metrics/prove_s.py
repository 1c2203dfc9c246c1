"""The window's whole time over the proofs completed in it (host clock)."""


def read(run):
    return run.per_request()
