"""The examples of the port, each a module:

    python -m repro_torch.examples.<name> [--device cpu]

quickstart, plan_topology and trace_plan (the planner); fleet_realloc,
chaos_fleet, control_plane and planes_transition (the fleet);
serve_decode and train_lm (the LM).  Each runs its engines on `--device`
(default cuda) and exits non-zero on a broken invariant."""
