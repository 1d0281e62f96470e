"""Distributed training support of the port: `fault_tolerance` (the
straggler watchdog, fault injection and the resilient step loop),
`sharding` (the reference's sharding rules as DTensor placements) and
`compression` (the int8 ring all-reduce with error feedback)."""
