"""setup_s: seconds from the process's start to the window's first
request: imports, kernel load, weights from the seed, the program's
encode, warm-up (host clock)."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
