"""Entry points of the port: `topo_plan` (the control-plane CLI), `serve`
(batched decode serving) and `train` (the training driver)."""
