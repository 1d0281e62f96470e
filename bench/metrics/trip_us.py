"""trip_us.<mix>: microseconds per event trip of the torch DES, the
`des.simulate` spans' time over the trips `des_event_trips_total`
counted in the window (host dispatch and the one sync per trip)."""


def read(run):
    trips = run.counters.get("des_event_trips_total", 0.0)
    if not trips:
        return None
    return 1e6 * sum(s[2] for s in run.span_records("des.simulate")) / trips
