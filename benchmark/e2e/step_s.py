"""Seconds a step: the window's wall time over the steps completed in it."""


def compute(window):
    return window.seconds / len(window.spans)
