"""The least time of the witness map's work (``cost.witness_map_work``) over
its span, in percent."""


def read(run):
    return run.share(run.witness_map_least_s(), run.phase_mean('witness_map'))
