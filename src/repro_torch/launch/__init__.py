"""Entry points of the port: `topo_plan` (the control-plane CLI), `serve`
(batched decode serving), `train` (the training driver) and `dryrun` (the
multi-pod dry run, with its meshes in `mesh` and its cost model in
`costanalysis`)."""
