"""Serving and evaluation steps of the port (`train_step`).  The training
step, its optimizer, checkpoints and data are not ported yet."""
