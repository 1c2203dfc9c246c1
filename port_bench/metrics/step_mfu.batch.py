"""The whole request's share of the card's peak: the least time of its
witness map and MSMs over the window's time a request, in percent."""


def read(run):
    wm, msm = run.witness_map_least_s(), run.msm_least_mean()
    if wm is None or msm is None:
        return None
    return run.share(wm + msm, run.per_request())
