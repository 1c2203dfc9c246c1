"""What a run recorded, as the metric readers see it.

A reader (``metrics/<metric>.py``) has one function, ``read(run)``, which
takes a :class:`Run` and returns a number, or None where the run holds
nothing to read: then the metric is left out of the result line.
"""

from . import cost

MSM_SPAN = '_msm'


class CircuitStats(object):
    """The circuit's shape as the yardstick counts it: matrix nonzeros
    and rows, the variables whose A and B columns hold a nonzero (with
    the constant and the public inputs in A, whose rows the QAP adds), the
    public inputs and the domain."""

    def __init__(self, cs, domain):
        a_cols, b_cols = set(range(cs.num_inputs + 1)), set()
        nnz = 0
        for con in cs.constraints:
            a_cols.update(con.a.terms)
            b_cols.update(con.b.terms)
            nnz += len(con.a.terms) + len(con.b.terms) + len(con.c.terms)
        self.nnz = nnz
        self.rows = cs.num_constraints
        self.n_vars = cs.num_variables
        self.n_inputs = cs.num_inputs
        self.a_cols = sorted(a_cols)
        self.b_cols = sorted(b_cols)
        self.m = domain


class Run(object):
    """setup_s, window_s; requests: one dict a request with 'start',
    'end', 'filled' (where the window fills the assignment), 'profile'
    (the program's ``last_profile``), 'failed'; witness_setup_s (where
    set-up fills it); trace: :meth:`.devtrace.Trace.summary` or None;
    stats: :class:`CircuitStats` or None; assignment(request) -> the
    assignment it proved."""

    def __init__(self, setup_s, window_s, requests, witness_setup_s=None,
                 trace=None, stats=None, assignment=None):
        self.setup_s = setup_s
        self.window_s = window_s
        self.requests = requests
        self.ok = [r for r in requests if not r.get('failed')]
        self.witness_setup_s = witness_setup_s
        self.trace = trace
        self.stats = stats
        self.assignment = assignment
        self._msm_least = {}

    def per_request(self):
        """Window seconds a completed request."""
        return self.window_s / len(self.ok) if self.ok else None

    def phase_mean(self, *names, contains=None):
        """Mean over the completed requests of the sum of the program's
        spans ``names`` (and of those whose name holds ``contains``)."""
        if not self.ok:
            return None
        tot = 0.0
        for r in self.ok:
            prof = r['profile']
            tot += sum(prof[n] for n in names)
            if contains:
                tot += sum(v for k, v in prof.items() if contains in k)
        return tot / len(self.ok)

    def fill_mean(self):
        got = [r['filled'] - r['start'] for r in self.ok if 'filled' in r]
        return sum(got) / len(got) if got else None

    def msm_mean(self):
        return self.phase_mean('digits', contains=MSM_SPAN)

    def witness_map_least_s(self):
        s = self.stats
        if s is None:
            return None
        return cost.least_seconds(*cost.witness_map_work(
            s.m, s.nnz, s.n_vars, s.rows))

    def msm_least_s(self, request):
        """The least seconds of the four MSMs of the proof of
        ``request``'s assignment."""
        if self.stats is None:
            return None
        w = self.assignment(request)
        if id(w) not in self._msm_least:
            s = self.stats
            col = lambda idx: cost.scalar_words([w[i] for i in idx])
            l_idx = range(s.n_inputs + 1, s.n_vars)
            t = cost.least_seconds(*cost.msm_work(
                s.m, cost.msm_additions(uniform=s.m), False))
            for idx, g2 in ((s.a_cols, False), (s.b_cols, True),
                            (l_idx, False)):
                t += cost.least_seconds(*cost.msm_work(
                    len(idx), cost.msm_additions(col(idx)), g2))
            self._msm_least[id(w)] = t
        return self._msm_least[id(w)]

    def msm_least_mean(self):
        if self.stats is None or not self.ok:
            return None
        return sum(self.msm_least_s(r) for r in self.ok) / len(self.ok)

    def share(self, least, spent):
        """least / spent as a percentage, None where either is missing."""
        if least is None or not spent:
            return None
        return 100.0 * least / spent

    def idle_share(self):
        t = self.trace
        if t is None or t['busy_s'] <= 0:
            return None
        return 100.0 * (1.0 - t['busy_s'] / t['window_s'])
