"""alg2_s.<mix>: seconds of Alg. 2 per completed plan, from the program's
own `xbound.upper_bound` spans (`x_upper_bound`: the t_up estimate, the
bitset closure and the MWIS scans)."""


def read(run):
    done = sum(1 for r in run.records if r.ok)
    spans = run.span_records("xbound.upper_bound")
    if not done or not spans:
        return None
    return sum(s[2] for s in spans) / done
