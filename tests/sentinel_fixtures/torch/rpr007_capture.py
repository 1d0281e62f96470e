"""RPR007 fixture: impure host calls under CUDA-graph capture."""
import random
import time

import numpy as np
import torch

from repro_torch.obs import get_counter, span

_STEPS = get_counter("fixture_steps_total", "steps run")


def _step(x):
    _STEPS.inc()  # TP: a graph below captures this function
    return x * 2


def bad_graph(x):
    t0 = time.perf_counter()  # near miss: before the capture
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = _step(x)
        t1 = time.time()  # TP: runs at capture only
    return g, y, t0, t1


def bad_span(x):
    g = torch.cuda.CUDAGraph()
    g.capture_begin()
    with span("fixture.capture"):  # TP: times the capture, not a replay
        y = x + 1
    g.capture_end()
    print(time.time())  # near miss: after capture_end
    return g, y


def _noisy(x):
    return x * random.random()  # TP: captured by make_graphed_callables


def bad_graphed(x):
    return torch.cuda.make_graphed_callables(_noisy, (x,))


@torch.compile
def bad_compiled(x):
    return x + np.random.rand()  # TP: traced once by torch.compile


def host(x):
    t0 = time.time()  # near miss: plain host code
    _STEPS.inc()  # near miss
    with span("fixture.host"):  # near miss
        return x, t0
