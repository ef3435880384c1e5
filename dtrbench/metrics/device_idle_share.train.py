"""The device's idle share in the traced session: 1 - (union of its
kernel, copy and fill intervals) over the profiled steps' wall, in
percent."""


def read(run):
    if run.session is None or run.session.window_s <= 0:
        return None
    return 100 * (1 - run.session.busy_s / run.session.window_s)
