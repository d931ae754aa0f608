"""Shared arithmetic of the readers of the traced slice (no metric)."""


def kernels_per_suggest(run, kind):
    sl = run.get("slice")
    if run["kind"] != kind or not sl or not sl.get("suggests"):
        return None
    return sl["kernels"] / sl["suggests"]


def idle_pct(run, kind):
    sl = run.get("slice")
    if run["kind"] != kind or not sl or sl["window_s"] <= 0 or sl["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])


def fmin_counts(run):
    """The fmin window's counts, before the traced slice when there is one
    (the profiler slows launches while it records)."""
    return run.get("untraced") or run


def roofline_pct(run, costs):
    """The share of their roofline of the kernels that ``costs`` describe
    in the traced slice: the least time for the launches of their symbols
    that the slice holds over their device time, summed over the kernels
    that ran.  Nothing when none ran."""
    sl = run.get("slice")
    if run["kind"] != "fmin" or not sl:
        return None
    cfg = run["cfg"]
    bound = busy = 0.0
    for cost in costs:
        times = [b - a for name, a, b in sl["kernel_intervals"]
                 if any(s in name for s in cost.KERNEL_SYMBOLS)]
        launches = cost.suggest_launches(cfg["labels"], cfg["algo"], round(sl["history"]))
        if not times or not launches:
            continue
        per = cost.LAUNCHES_PER_FAMILY
        bound += len(times) / (per * len(launches)) * sum(cost.bound_s(*x) for x in launches)
        busy += sum(times)
    return 100.0 * bound / busy if busy > 0 else None
