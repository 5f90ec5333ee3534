"""EEG windows a device dispatch of the micro-batcher: the windows of every
request the window sent over ``MicroBatcher.dispatches``, counted over the
window."""


def read(run):
    if not run["dispatches"]:
        return None
    return run["windows"] / run["dispatches"]
