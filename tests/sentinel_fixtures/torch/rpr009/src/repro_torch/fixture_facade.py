"""RPR009 fixture: deprecated facade calls vs the plan() entry point.

True positives: `bad_direct` (name imported from repro_torch.core.api),
`bad_alias` (attribute call through a module alias).  Near misses: the
unified `plan` call, a same-named helper imported from elsewhere, and an
attribute call on an object that is not the api module.
"""
from repro_torch.core import api
from repro_torch.core.api import PlanRequest, optimize_failsafe, plan
from repro_torch.other.tools import optimize as tune  # not the facade


def bad_direct(dag):
    return optimize_failsafe(dag)               # flagged


def bad_alias(requests):
    return api.fleet_optimize(requests)         # flagged


def good_plan(dag):
    return plan(PlanRequest(dag=dag))           # the replacement


def good_other_import(params):
    return tune(params)                         # different `optimize`


def good_method_call(runner, dag):
    return runner.optimize(dag)                 # not the api module
