"""search_gen_s: seconds per GA generation of a time-budgeted plan, the
whole wall time of the window's plans (Alg. 2, the ideal run, the re-rank
and the certification included, as a user with that budget pays them)
over the generations they report."""


def read(run):
    gens = sum(r.generations or 0 for r in run.records)
    if not gens:
        return None
    return sum(r.wall_s for r in run.records) / gens
