"""The LM model zoo of the port: `layers` (the primitives) and `model`
(the `LM` module, its cache and forward)."""
from repro_torch.models import layers, model  # noqa: F401
