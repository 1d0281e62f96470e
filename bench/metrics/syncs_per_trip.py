"""syncs_per_trip.<mix>: host reads of device values per event trip of the
torch DES in the window, `des_host_syncs_total` over
`des_event_trips_total` (the exit test of each trip, and per simulation
the rounds read and the result copies)."""


def read(run):
    syncs = run.counters.get("des_host_syncs_total")
    trips = run.counters.get("des_event_trips_total", 0.0)
    if syncs is None or not trips:
        return None
    return syncs / trips
