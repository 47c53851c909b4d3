"""BS006 fixture: the plain version is not a launcher; numpy is fine here."""
import numpy as np


def demo_ref(x):
    return np.asarray(x)
