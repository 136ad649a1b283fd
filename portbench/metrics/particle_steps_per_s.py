"""Particle-steps a second: N T times the filters dispatched in the
window, over the window's wall time, from the first timed dispatch to the
synchronize that completes the last filter (host clock)."""


def read(rec):
    work = rec.get("work", {}).get("particle_steps")
    if not work or rec["window_s"] <= 0:
        return None
    return work / rec["window_s"]
