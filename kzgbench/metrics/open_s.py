"""open_s: the window's seconds over the openings it completed (commit,
evaluation and witness each)."""


def read(run):
    jobs = [r for r in run.requests if r["kind"] == "open"]
    return run.window_s / len(jobs) if jobs else None
