"""verifies_per_s: verdicts delivered over the window's seconds."""


def read(run):
    done = [r for r in run.requests if r["kind"] == "verify"]
    return len(done) / run.window_s if done else None
