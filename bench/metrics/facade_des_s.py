"""facade_des_s.<mix>: seconds of the facade's own numpy DES runs per
completed plan, from the program's `api.ideal` (the ideal run, the NCT's
denominator) and `api.certify` (the winner's certification) spans."""


def read(run):
    done = sum(1 for r in run.records if r.ok)
    spans = run.span_records("api.ideal") + run.span_records("api.certify")
    if not done or not spans:
        return None
    return sum(s[2] for s in spans) / done
