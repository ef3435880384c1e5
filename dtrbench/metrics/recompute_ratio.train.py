"""Launches of the main forward kernel in the window's steps (the
wrapper's own counter) over its calls made outside a backward (one
forward each): 1 with no remat, 2 where the policy runs every layer's
forward again."""


def read(run):
    main = run.config["main_forward"]
    spec = run.config["kernels"][main]
    forwards = run.forward_calls.get(main, 0)
    if not forwards:
        return None
    return run.counters[spec["forward_counter"]] / forwards
