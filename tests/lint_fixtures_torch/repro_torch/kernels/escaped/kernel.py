"""BS006 fixture: a justified line suppression in the port's directive."""
import numpy as np  # bigset-lint-torch: disable=BS006 -- fixture: a deliberate escape


def launch(x):
    return np.asarray(x)
