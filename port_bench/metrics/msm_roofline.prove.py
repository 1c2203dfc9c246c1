"""The least time of the four MSMs' work (``cost.msm_work``) over their
spans, in percent."""


def read(run):
    return run.share(run.msm_least_mean(), run.msm_mean())
