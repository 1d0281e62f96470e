"""Entry points of the port: `topo_plan`, the control-plane CLI."""
