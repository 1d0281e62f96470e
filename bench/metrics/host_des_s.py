"""host_des_s.<mix>: seconds of the host's numpy DES per completed plan
(the facade's ideal run and certification, the GA's exact re-rank),
timed by the benchmark's wrappers of `simulate` in
`repro_torch.core.api` and `repro_torch.core.ga`."""


def read(run):
    done = sum(1 for r in run.records if r.ok)
    spans = run.span_records("host_des")
    if not done or not spans:
        return None
    return sum(s[2] for s in spans) / done
