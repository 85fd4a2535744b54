"""Set-up: seconds from the process's start to the first timed request."""


def read(run):
    return run["setup_s"]
