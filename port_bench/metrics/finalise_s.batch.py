"""Seconds a proof of the host finalisation: the program's ``finalise`` span."""


def read(run):
    return run.phase_mean('finalise')
