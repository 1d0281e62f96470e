"""Training and serving of the port: `train_step` (the train, prefill,
decode and eval steps), `optimizer` (AdamW), `checkpoint` (the
reference's on-disk layout) and `data` (the deterministic synthetic
stream).  Training is ported; `launch/train.py` drives it."""
