"""Process start to the first timed request or step: loading, drawing
the weights, building and loading the kernels, warming up."""


def read(run):
    return run["out"]["setup_s"]
