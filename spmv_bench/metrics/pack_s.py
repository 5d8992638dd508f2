"""Host seconds of the strategy's ``prepare`` (the pack), from the
benchmark's clock around it."""


def read(run):
    return run.pack_s
