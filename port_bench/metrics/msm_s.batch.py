"""Seconds a proof of the MSMs: the program's ``digits`` span and every
``*_msm*`` span."""


def read(run):
    return run.msm_mean()
