"""The format-free bound (``roofline.bound_ms``) over the call's device
time, in %: no sound implementation can pass 100."""


def read(run):
    bound, ms = run.bound_ms(), run.device_ms()
    if bound is None or not ms:
        return None
    return 100.0 * bound / ms
