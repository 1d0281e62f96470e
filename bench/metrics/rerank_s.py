"""rerank_s.<mix>: seconds of the GA's exact re-rank per completed plan,
from the program's own `ga.rerank` spans (the numpy DES of the best
cached genomes)."""


def read(run):
    done = sum(1 for r in run.records if r.ok)
    spans = run.span_records("ga.rerank")
    if not done or not spans:
        return None
    return sum(s[2] for s in spans) / done
