"""Seconds a proof of the QAP witness map: the program's ``witness_map``
span."""


def read(run):
    return run.phase_mean('witness_map')
