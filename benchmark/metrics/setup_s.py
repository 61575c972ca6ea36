"""Set-up: process start to the first timed dispatch (seconds, host clock)."""


def read(run):
    return run["setup_s"]
