"""No native host runtime: the copied encoder and resolver take their
pure-Python paths."""


def available() -> bool:
    return False
