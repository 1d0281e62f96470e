"""RPR005 fixture: solver payloads used with and without status gates."""


def bad_unpack(md):
    status, x, info = md.solve()
    return x.sum()  # TP: no `x is None` gate


def good_unpack(md):
    status, x, info = md.solve()
    if x is None:  # near miss: gated
        return None
    return x.sum()


def bad_result(dag):
    res = solve_delta_milp(dag)  # noqa: F821 -- fixture, never executed
    return res.schedule  # TP: payload read, feasible/status never consulted


def good_result(dag):
    res = solve_robust_milp(dag)  # noqa: F821
    if res.status != "optimal":  # near miss: gated
        return None
    return res.x
