"""Set-up seconds: process start to the window's start, loading, the
history, warm-up and (in a checkout's first run) the kernel build."""


def read(run):
    return run["setup_s"]
