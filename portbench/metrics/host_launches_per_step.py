"""Step: host runtime calls that start device work (kernel launches of every
form and CUDA graph replays) per fit step, replicas counted apart."""


def read(trace):
    if not trace.steps or not trace.runtime:
        return None
    return trace.launches() / trace.steps
