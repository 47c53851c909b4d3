"""BS001 fixture: the reference's directive is a plain comment to the port."""
import time


def default_clock():
    return time.monotonic()  # bigset-lint: disable=BS001 -- fixture: read only by the reference's linter
