"""Seconds a proof of the witness upload: the program's ``witness_upload``
span."""


def read(run):
    return run.phase_mean('witness_upload')
