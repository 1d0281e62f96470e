"""xbound_s.<mix>: seconds of Alg. 2 (`x_upper_bound`, the host's
bitset closure and MWIS) per completed plan, timed by the benchmark's
wrapper of `repro_torch.core.ga.x_upper_bound`."""


def read(run):
    done = sum(1 for r in run.records if r.ok)
    spans = run.span_records("xbound")
    if not done or not spans:
        return None
    return sum(s[2] for s in spans) / done
