"""From the process's start (the first line of run.py) to the first timed
call: loading, weights and inputs, building and warming up."""


def read(run):
    return run.setup_s
