"""DELTA planner core on PyTorch: data model, DES engines, GA, facade."""
