"""plan_s: seconds per whole plan of a closed loop of one client, the
wall time of the completed plans over how many completed."""


def read(run):
    done = [r for r in run.records if r.ok]
    if not done:
        return None
    return sum(r.wall_s for r in done) / len(done)
