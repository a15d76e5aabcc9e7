"""Device milliseconds per gradient of the kernels that the backward pass
launches: those whose launch comes at or after the first autograd engine
call of the job (by the launches' correlation ids, else by the kernels'
start on the device timeline)."""

from h100bench.readers import mean


def _backward_ms(run, sp):
    tr = run.trace
    t_b = min((e.ts for evs in tr.host.values() for e in evs
               if sp.ts <= e.ts <= sp.end
               and e.name.startswith("autograd::engine::evaluate_function")),
              default=None)
    if t_b is None:
        return None
    ks = tr.kernels_in(sp.ts, sp.end)
    corr = [e.corr for e in tr.launches
            if t_b <= e.ts <= sp.end and e.corr > 0]
    if corr and all(k.corr > 0 for k in ks):
        first = min(corr)
        mine = [k for k in ks if k.corr >= first]
    else:
        mine = [k for k in ks if k.ts >= t_b]
    return sum(k.dur for k in mine) * 1e-3 if mine else None


def read(run):
    if run.trace is None:
        return None
    return mean(_backward_ms(run, sp) for _, sp in run.job_spans())
