"""plan_self_s.<mix>: seconds per completed plan that no span of the
program explains: each `api.plan` span less the union of the program's
other spans inside it.  The benchmark's own spans (`plan`, `xbound`,
`host_des`) time the same work from outside and are left out."""

OUTSIDE = {"api.plan", "plan", "xbound", "host_des"}


def read(run):
    done = sum(1 for r in run.records if r.ok)
    plans = run.span_records("api.plan")
    if not done or not plans:
        return None
    inner = sorted((t0, t0 + dur) for name, t0, dur in run.spans
                   if name not in OUTSIDE)
    own = 0.0
    for _, p0, pdur in plans:
        p1 = p0 + pdur
        covered, end = 0.0, p0
        for a, b in inner:
            a, b = max(a, end), min(b, p1)
            if b > a:
                covered += b - a
                end = b
        own += pdur - covered
    return own / done
