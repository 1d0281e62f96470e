"""RPR010 fixture: a device failure swallowed by a broad handler."""
import torch

from repro_torch.core.des_torch import TorchDES
from repro_torch.kernels import ops, ref


def bad_engine(problem):
    try:
        return TorchDES(problem)
    except Exception:  # TP: a quiet fallback
        return None


def bad_kernel(a):
    try:
        return ops.transitive_closure(a)
    except RuntimeError:  # TP
        return a


def bad_bare():
    try:
        torch.cuda.synchronize()
    except:  # noqa: E722  TP: bare
        pass


def bad_engine_method(problem, x):
    des = TorchDES(problem)
    try:
        return des.makespan(x)
    except (ValueError, OSError):  # TP: a tuple with a broad type
        return float("inf")


def good_reraise(problem):
    try:
        return TorchDES(problem)
    except Exception as exc:  # near miss: re-raises
        raise RuntimeError("engine failed") from exc


def good_host(path):
    try:
        with open(path) as f:  # near miss: host-only body
            return f.read()
    except OSError:
        return ""


def good_narrow(problem):
    try:
        return TorchDES(problem)
    except ValueError:  # near miss: a narrow handler
        return None


def good_plain(a, b):
    try:
        return ref.maxplus_ref(a, b)  # near miss: the plain version
    except Exception:
        return None
