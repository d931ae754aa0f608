"""Wall milliseconds per trial of an fmin window: the window's wall time
over the trials completed in it, the objective included."""


def read(run):
    if run["kind"] != "fmin" or not run["n_trials"]:
        return None
    return run["window_s"] * 1e3 / run["n_trials"]
