"""Distributed training support of the port: `fault_tolerance` (the
straggler watchdog, fault injection and the resilient step loop).  The
sharding rules, gradient compression and the dry-run are not ported
yet."""
