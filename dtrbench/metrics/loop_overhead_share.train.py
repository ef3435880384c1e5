"""The launcher's share of the window outside the train step: 1 - (sum of
the loop's own step times, ``TrainResult.step_seconds``) over the sum of
the steps' walls from the hook's stamps (prefetch, the divergence guard,
``device_memory``, the monitors), in percent, over the window's steps
that no profiler session touched."""
from dtrbench.lib import stats


def read(run):
    pairs = [(w, s) for w, s, clean in zip(stats.walls(run.stamps),
                                           run.step_seconds, run.clean)
             if clean]
    if not pairs:
        return None
    return 100 * (1 - sum(s for _, s in pairs) / sum(w for w, _ in pairs))
