"""Set-up: process start to the first timed dispatch (host clock)."""


def read(rec):
    return rec["setup_s"]
